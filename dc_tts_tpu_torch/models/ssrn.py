"""SSRN: spectrogram super-resolution network, the port of
``dc_tts_tpu/models/ssrn.py``.

Coarse mel (B, T/r, n_mels) -> full linear spectrogram (B, T, 1 + n_fft/2):
C(c,1) -> HC(3,1) -> HC(3,3) -> 2x[ D(stride2) -> HC(3,1) -> HC(3,3) ]
-> C(2c,1) -> 2x HC(3,1) -> C(1+n_fft/2, 1) -> 2x C(1,relu) -> C(1)
-> sigmoid. All non-causal. In synthesis every conv is a torch matmul; in
training under ``cfg.use_pallas`` the eight HC blocks run kernel K4.
``cfg.compute_dtype`` selects the operand modes (``blocks.operand_modes``);
the logits are cast back to float32 for the loss. ``model_group`` runs
the stack tensor-parallel over that process group (``parallel/tp.py``;
``params`` this rank's slices; the last n_freq-wide conv stays whole when
the model size does not divide it).

In synthesis on the card (the tensors on CUDA, gradients off, not training,
the "high" operand mode with float32 activations, no model group) every
block runs kernel K5 (``ops/ssrn_block.py``): one prologue and one epilogue
launch around its three bf16 products, against weight halves split once
(``SSRN.pack``, which the synthesizers call when they are built). Every
other call runs the eager chain of ``blocks.apply_stack``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple

import torch

from ..config import Config
from ..ops.ssrn_block import pack_weights, ssrn_stack
from .blocks import (C, D, HC, apply_stack, init_stack, operand_modes,
                     widen)


def ssrn_specs(cfg: Config):
    c = cfg.c
    assert cfg.r == 4, "SSRN's two stride-2 deconvs implement exactly r=4"
    specs = [C(1, 1, c, None)]
    specs += [HC(3, 3 ** j) for j in range(2)]
    for _ in range(2):
        specs += [D(3)]
        specs += [HC(3, 3 ** j) for j in range(2)]
    specs += [C(1, 1, 2 * c, None)]
    specs += [HC(3, 1), HC(3, 1)]
    specs += [C(1, 1, cfg.n_freq, None)]
    specs += [C(1, 1, None, "relu"), C(1, 1, None, "relu")]
    specs += [C(1, 1, None, None)]
    return tuple(specs)


def takes_k5(Y: torch.Tensor, train: bool, dtype, act_dtype,
             model_group) -> bool:
    """Whether ``SSRN.apply`` runs its blocks through kernel K5: what the
    call can observe, synthesis on the card in the "high" mode (module
    docstring)."""
    return (Y.is_cuda and not train and not torch.is_grad_enabled()
            and dtype == "high" and act_dtype is None and model_group is None)


@dataclass(frozen=True)
class SSRN:
    cfg: Config
    model_group: Any = field(default=None, compare=False)

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        params, out = init_stack(gen, self.cfg.n_mels, ssrn_specs(self.cfg),
                                 device)
        assert out == self.cfg.n_freq
        return {"stack": params}

    def pack(self, params):
        """The conv kernels' bf16 halves that K5 reads (``ops/ssrn_block.
        pack_weights``), or None under an operand mode K5 never runs."""
        if operand_modes(self.cfg.compute_dtype) != ("high", None):
            return None
        return pack_weights(params["stack"], ssrn_specs(self.cfg))

    def apply(self, params, Y: torch.Tensor, *, gen=None,
              train: bool = False,
              packed=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Y (B, T/r, n_mels) -> (Z_logits, Z) each (B, T, n_freq). In
        training (``train``) dropout draws from ``gen``. ``packed``: this
        ``params``' ``pack``, for a call that runs K5 (module docstring;
        packed here when not given), unused by any other."""
        cfg = self.cfg
        dtype, act_dtype = operand_modes(cfg.compute_dtype)
        specs = ssrn_specs(cfg)
        if takes_k5(Y, train, dtype, act_dtype, self.model_group):
            if packed is None:
                packed = self.pack(params)
            logits = ssrn_stack(params["stack"], specs, Y, packed,
                                cfg.ln_eps)
        else:
            logits = widen(apply_stack(
                params["stack"], specs, Y, ln_eps=cfg.ln_eps,
                dropout_rate=cfg.dropout_rate, gen=gen, train=train,
                use_pallas=cfg.use_pallas, dtype=dtype, act_dtype=act_dtype,
                remat=cfg.remat, model_group=self.model_group))
        return logits, torch.sigmoid(logits)
