"""Operators of the port: plain PyTorch and hand-written CUDA kernels."""
