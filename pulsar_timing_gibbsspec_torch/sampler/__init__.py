"""Compiled model, Gibbs blocks, driver and facade of the port."""
