"""The aligners: plain PyTorch versions and the wrappers of their CUDA
kernels (greedy; exact NW: full, trace and band)."""
