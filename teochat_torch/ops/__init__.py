"""Attention kernels (CUDA, csrc/) with their plain PyTorch twins, and int8 projections."""
