"""Numerical operators of the port and its CUDA kernels."""
