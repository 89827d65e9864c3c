"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""
