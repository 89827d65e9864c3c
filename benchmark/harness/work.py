"""The work each stage needs, counted from shapes, and the chip's peaks.

Frozen copies of the repository's counters, so that a later change to the
program cannot move the yardstick:

* ``conv_stack_flops``: ``dc_tts_tpu_torch/utils/profiling.py``, 2 M N K a
  conv product (an HC block's conv is 2C wide, a deconv three products);
* the decode K1: ``chip_smoke.py``'s count, AudioEnc and AudioDec a row a
  step, and the scores and context of the ``attention_win_size`` keys of
  the window (the smoke counts the keys its cursors leave unmasked: at most
  this, and 0.02 % of the total at the published sizes);
* Griffin-Lim K2: ``chip_smoke.py``'s, 2 n_iter + 1 real FFTs of each of
  the spectrogram's frames, 2.5 n log2 n each;
* training: ``scripts/bench_train.py``'s three times the forward's conv
  FLOPs at the batch's (N, T).

A stage's bytes are its inputs read once and its outputs written once, at
their types on the device (parameters float32, ids int64, pcm16 int16).
The least time of a stage is the larger of FLOPs over the dense bf16 peak
and bytes over the HBM peak: no implementation of the same result, float32
ones by split passes included, can beat either, so a share of it cannot
pass 100 %.
"""
from __future__ import annotations

import math

from ..reference import dctts as R

# NVIDIA H100 SXM, the data sheet's dense bf16 tensor-core rate and HBM3
# bandwidth (at 700 W)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def conv_stack_flops(batch: int, t: int, blocks, in_ch: int) -> int:
    total, ch = 0, in_ch
    for b in blocks:
        if b.kind == "HC":
            total += 2 * batch * t * (b.size * ch) * (2 * ch)
        elif b.kind == "C":
            out = b.out or ch
            total += 2 * batch * t * (b.size * ch) * out
            ch = out
        else:                                   # D: stride-2 deconv
            out = b.out or ch
            total += 2 * batch * t * ch * out * 3
            ch, t = out, 2 * t
    return total


def param_bytes(cfg: dict, network: str) -> int:
    return 4 * sum(math.prod(s) for s in R.param_shapes(cfg, network).values())


def text_enc_flops(cfg: dict, B: int, N: int) -> int:
    return conv_stack_flops(B, N, R.text_enc(cfg), cfg["e"])


def k1_flops(cfg: dict, B: int) -> int:
    T, d = cfg["max_T"], cfg["d"]
    return (conv_stack_flops(B, T, R.audio_enc(cfg), cfg["n_mels"])
            + conv_stack_flops(B, T, R.audio_dec(cfg), 2 * d)
            + 2 * B * T * cfg["attention_win_size"] * 2 * d)


def ssrn_flops(cfg: dict, B: int) -> int:
    return conv_stack_flops(B, cfg["max_T"], R.ssrn(cfg), cfg["n_mels"])


def k2_flops(cfg: dict, B: int) -> float:
    F, n = cfg["max_T"] * cfg["r"], cfg["n_fft"]
    return (2 * cfg["n_iter"] + 1) * F * B * 2.5 * n * math.log2(n)


def n_samples(cfg: dict) -> int:
    return R.hop_length(cfg) * (cfg["max_T"] * cfg["r"] - 1)


def synth_stages(cfg: dict, B: int, N: int) -> dict:
    """{stage: (FLOPs, bytes)} of one batch of B rows of N ids."""
    T, F = cfg["max_T"], cfg["max_T"] * cfg["r"]
    Y = 4 * B * T * cfg["n_mels"]
    Z = 4 * B * F * R.n_freq(cfg)
    return {
        "text2mel": (text_enc_flops(cfg, B, N) + k1_flops(cfg, B),
                     8 * B * N + param_bytes(cfg, "text2mel") + Y
                     + 4 * B * N * T),
        "ssrn": (ssrn_flops(cfg, B), Y + param_bytes(cfg, "ssrn") + Z),
        "vocoder": (k2_flops(cfg, B), Z + 2 * B * n_samples(cfg)),
    }


def train_flops(cfg: dict, network: str, B: int, N: int, T: int) -> int:
    """Three times the forward's conv FLOPs of a step at (N, T)."""
    if network == "text2mel":
        fwd = (conv_stack_flops(B, N, R.text_enc(cfg), cfg["e"])
               + conv_stack_flops(B, T, R.audio_enc(cfg), cfg["n_mels"])
               + conv_stack_flops(B, T, R.audio_dec(cfg), 2 * cfg["d"]))
    else:
        fwd = conv_stack_flops(B, T, R.ssrn(cfg), cfg["n_mels"])
    return 3 * fwd


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
