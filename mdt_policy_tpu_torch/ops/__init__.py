"""Kernels of the port (CUDA sources in `../csrc`) and plain attention."""
