"""Run-time support of the port: checkpoint integrity."""
