"""Attention kernels: hand-written CUDA for the card, plain PyTorch for the CPU."""
