"""Griffin-Lim vocoder, the port of ``dc_tts_tpu/dsp/griffin_lim.py``.

Each round is X = mag * phase(stft(istft(X))) with a 1e-8 magnitude floor,
starting from zero phase. Every ``stft_method`` of the JAX package:
* ``"dft_pallas2"`` (the config default): the whole loop through kernel K2
  (``ops/gl2.py``), every round float32;
* ``"dft_pallas"``: the ``dft_mixed`` schedule with every round through
  kernel K3 (``ops/gl.py``), 3-pass head and tail, single-pass bf16 middle;
* ``"dft_mixed"``: the same schedule on the DFT-matmul transforms
  (``dft_3x`` head and tail, ``dft_bf16`` middle);
* ``"fft"``, ``"dft"``, ``"dft_3x"``, ``"dft_bf16"``, ``"ct"``: every round
  on that transform (``dsp/stft.py``).
The final synthesis iSTFT runs in float32 for the bf16 methods and the
schedules.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..config import Config
from ..utils.profiling import span
from .features import deemphasis
from .stft import dft_consts, istft, stft

METHODS = ("fft", "dft", "dft_3x", "dft_bf16", "ct", "dft_mixed",
           "dft_pallas", "dft_pallas2")


def gl_schedule(n_iter: int):
    """(head, mid, tail) rounds of the mixed schedules: 3-pass head rounds
    select the phase basin, single-pass bf16 rounds polish inside it, 3-pass
    tail rounds converge to the float32 fixed point."""
    head = min(n_iter, max(1, n_iter // 10))
    tail = min(n_iter - head, max(2, n_iter // 10))
    return head, n_iter - head - tail, tail


def _rounds(X, mag, n_fft, hop, win_length, n, method, mats):
    for _ in range(n):
        est = stft(istft(X, n_fft, hop, win_length, method, mats),
                   n_fft, hop, win_length, method, mats)
        X = mag * (est / torch.clamp(est.abs(), min=1e-8))
    return X


def _griffin_lim_fft(mag: torch.Tensor, n_fft: int, hop: int,
                     win_length: int, n_iter: int) -> torch.Tensor:
    """The torch.fft rounds in the magnitude's precision (float32, or
    float64 for a reference)."""
    X = _rounds(mag.to(mag.dtype.to_complex()), mag, n_fft, hop, win_length,
                n_iter, "fft", None)
    return istft(X, n_fft, hop, win_length)


@functools.lru_cache(maxsize=8)
def _gl_consts_cached(n_fft: int, method: str, hop: int, win_length: int,
                      F: int, device: str) -> dict:
    d = dict(dft_consts(n_fft, method))
    if method == "dft_pallas":
        # the rounds read only K3's own constants; the final iSTFT A and B
        from ..ops.gl import gl_fused_consts
        d = {"A": d["A"], "B": d["B"],
             "fused": gl_fused_consts(n_fft, hop, win_length, F)}
    if method == "dft_pallas2":
        from ..ops.gl2 import gl2_consts
        d["fused2"] = {k: torch.as_tensor(v) for k, v in
                       gl2_consts(n_fft, hop, win_length, F).items()}
        d["fused2"]["F_tag"] = torch.zeros(F, 0)
    return {k: ({kk: vv.to(device) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in d.items()}


def gl_consts(cfg: Config, F: int | None = None, device="cuda") -> dict:
    """The Griffin-Lim constants of ``cfg.stft_method`` on ``device``,
    cached per (n_fft, method, hop, win, F, device). F defaults to the
    synthesis grid, max_T * r frames."""
    device = torch.empty(0, device=device).device   # "cuda" -> "cuda:0"
    return _gl_consts_cached(cfg.n_fft, cfg.stft_method, cfg.hop_length,
                             cfg.win_length, F or cfg.max_T * cfg.r,
                             str(device))


def griffin_lim(mag: torch.Tensor, n_fft: int, hop: int, win_length: int,
                n_iter: int, method: str = "fft",
                mats: dict | None = None) -> torch.Tensor:
    """Phase reconstruction. mag (..., F, n_freq) -> (..., hop*(F-1)).
    float32, except that method "fft" keeps a float64 magnitude in float64
    (a reference for the float32 paths). mats: the constants of
    ``gl_consts`` (built and cached on mag's device when omitted)."""
    if method not in METHODS:
        raise ValueError(f"unknown stft_method {method!r}; one of {METHODS}")
    if mag.dtype != torch.float64 or method != "fft":
        mag = mag.float()
    if method == "fft":
        return _griffin_lim_fft(mag, n_fft, hop, win_length, n_iter)
    F_, n_freq = mag.shape[-2], mag.shape[-1]
    m = mats if mats is not None else _gl_consts_cached(
        n_fft, method, hop, win_length, F_, str(mag.device))
    if method in ("dft_pallas", "dft_pallas2"):
        key = "fused" if method == "dft_pallas" else "fused2"
        fused = m.get(key)
        # distinct F can share one padded-row bucket while their NOLA tails
        # differ: validate by the frame count
        if fused is None or fused["F_tag"].shape[0] != F_:
            fused = _gl_consts_cached(n_fft, method, hop, win_length, F_,
                                      str(mag.device))[key]

    if method == "dft_pallas2":
        from ..ops.gl2 import gl2_geometry, gl2_run, scramble_mag
        g = gl2_geometry(n_fft, hop, win_length, F_)
        y = gl2_run(scramble_mag(mag.reshape(-1, F_, n_freq), g), fused, g,
                    n_iter)
        return y.reshape(*mag.shape[:-2], -1)

    head, mid, tail = gl_schedule(n_iter)
    if method == "dft_pallas":
        from ..ops.gl import fused_gl_round, gl_geometry
        g = gl_geometry(n_fft, hop, win_length, F_)
        mag_p = F.pad(mag.reshape(-1, F_, n_freq), (0, 0, 0, g.f2 - F_))
        Xr, Xi = mag_p, torch.zeros_like(mag_p)
        for three, n in ((True, head), (False, mid), (True, tail)):
            for _ in range(n):
                Xr, Xi = fused_gl_round(Xr, Xi, mag_p, fused, g, three)
        X = torch.complex(Xr[:, :F_], Xi[:, :F_])
        y = istft(X, n_fft, hop, win_length, "dft",
                  {"A": m["A"], "B": m["B"]})
        return y.reshape(*mag.shape[:-2], -1)

    X = mag.to(torch.complex64)
    if method == "dft_mixed":
        m3 = {k: m[k] for k in ("C", "S", "A", "B")}
        mb = {"C": m["Cb"], "S": m["Sb"], "A": m["Ab"], "B": m["Bb"]}
        X = _rounds(X, mag, n_fft, hop, win_length, head, "dft_3x", m3)
        X = _rounds(X, mag, n_fft, hop, win_length, mid, "dft_bf16", mb)
        X = _rounds(X, mag, n_fft, hop, win_length, tail, "dft_3x", m3)
        return istft(X, n_fft, hop, win_length, "dft", m3)
    X = _rounds(X, mag, n_fft, hop, win_length, n_iter, method, m)
    if method == "dft_bf16":
        return istft(X, n_fft, hop, win_length, "dft",
                     {"A": m["A32"], "B": m["B32"]})
    return istft(X, n_fft, hop, win_length, method, m)


def denormalize_mag(mag_norm: torch.Tensor, cfg: Config) -> torch.Tensor:
    """[0,1]-normalized spectrogram -> sharpened linear amplitude: clip ->
    dB denorm -> amplitude -> ^power."""
    mag = torch.clamp(mag_norm, 0.0, 1.0) * cfg.max_db - cfg.max_db \
        + cfg.ref_db
    return torch.pow(10.0, mag * 0.05) ** cfg.power


def spectrogram_to_wav(mag_norm: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Normalized linear spectrogram (..., T, n_freq) -> waveform:
    denormalize -> Griffin-Lim (``cfg.stft_method``) -> de-emphasis. A
    float64 spectrogram under ``stft_method="fft"`` gives a float64
    reference waveform. Span ``vocoder.griffin_lim`` (``utils/profiling``)
    around denormalize + Griffin-Lim."""
    with span("vocoder.griffin_lim"):
        wav = griffin_lim(denormalize_mag(mag_norm, cfg), cfg.n_fft,
                          cfg.hop_length, cfg.win_length, cfg.n_iter,
                          method=cfg.stft_method)
    return deemphasis(wav, cfg.preemphasis)
