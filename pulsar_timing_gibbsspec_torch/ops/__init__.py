"""Device operations of the port: linear algebra and kernels."""
