"""Greedy alignment: the plain PyTorch version and the CUDA kernel wrapper."""
