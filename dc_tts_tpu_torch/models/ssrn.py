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
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple

import torch

from ..config import Config
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


@dataclass(frozen=True)
class SSRN:
    cfg: Config
    model_group: Any = field(default=None, compare=False)

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        params, out = init_stack(gen, self.cfg.n_mels, ssrn_specs(self.cfg),
                                 device)
        assert out == self.cfg.n_freq
        return {"stack": params}

    def apply(self, params, Y: torch.Tensor, *, gen=None,
              train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Y (B, T/r, n_mels) -> (Z_logits, Z) each (B, T, n_freq). In
        training (``train``) dropout draws from ``gen``."""
        cfg = self.cfg
        dtype, act_dtype = operand_modes(cfg.compute_dtype)
        logits = widen(apply_stack(
            params["stack"], ssrn_specs(cfg), Y, ln_eps=cfg.ln_eps,
            dropout_rate=cfg.dropout_rate, gen=gen, train=train,
            use_pallas=cfg.use_pallas, dtype=dtype, act_dtype=act_dtype,
            remat=cfg.remat, model_group=self.model_group))
        return logits, torch.sigmoid(logits)
