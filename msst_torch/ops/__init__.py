"""Geometry and compute ops of the port (PyTorch, plus hand-written CUDA
kernels behind wrappers that take the plain version on CPU tensors)."""
