"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""
from .hc_vjp import hc_block_trainable  # noqa: F401
