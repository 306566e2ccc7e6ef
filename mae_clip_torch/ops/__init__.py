"""Tensor operations of the port: attention (with its CUDA kernels) and retrieval."""
