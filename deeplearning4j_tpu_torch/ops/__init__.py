"""Attention ops of the port: dense attention and the hand-written CUDA
kernels (each beside its plain PyTorch version)."""
