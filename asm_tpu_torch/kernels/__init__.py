"""The aligners: plain PyTorch versions and the wrappers of their CUDA
kernels (greedy; exact NW: full, trace and band; LEAP, with the SHD
gate and the fused CIGAR), and the roofline's microkernels."""
