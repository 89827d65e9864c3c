"""Device selection and fp32 numerics for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"`` they raise instead of quietly
running on the CPU. They also turn TF32 off for both matmuls and cuDNN, so
that float32 means float32, as the JAX package pins ``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch


def fp32_numerics() -> None:
    """Turn TF32 off (``cudnn.allow_tf32`` defaults to True)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if it is CUDA and there is
    no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run on the CPU")
    fp32_numerics()
    return dev
