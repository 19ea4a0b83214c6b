"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref``), plus the ``nvcc``/``ctypes`` build helper."""
