"""Sequence-parallel Griffin-Lim: the frame axis of one spectrogram
sharded over the ranks of a mesh axis; the port of
``dc_tts_tpu/parallel/sp_gl.py``.

Each round couples frames only within the overlap-add overlap of
``n_fft - hop`` samples, so each round a rank exchanges one boundary
segment with each neighbour:

  istft side: my trailing overlap-add spill [F_l*hop, F_l*hop + n_fft - hop)
  adds into my right neighbour's head; then my spill section is refreshed
  from the right neighbour's summed head (only after the add: in the other
  order a rank would read a head still missing its left part).
  stft side: my framing window reads those n_fft - hop samples.

The window-sum normalisation uses the global NOLA denominator, sliced per
rank; the centred STFT's reflect padding at the signal's ends is applied by
the first and last ranks. The transforms are the float32 DFT matrix
products (``method="dft"``), as in the JAX package, where they run outside
any Pallas kernel. The loop equals the unsharded ``griffin_lim(...,
method="dft")`` up to float rounding (tests/test_torch_sp.py).

A frame shard must exceed the halo: F_l * hop > n_fft - hop (841 frames
over 8 ranks at base config own 105 frames, far more than the 7 the halo
spans).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..dsp.features import deemphasis
from ..dsp.griffin_lim import denormalize_mag
from ..dsp.stft import (_ola_window_sq, _overlap_add, dft_consts,
                        hann_window, irdft, rdft)
from . import distributed as Dist


def _shift(x: torch.Tensor, mesh, axis: str, from_left: bool
           ) -> torch.Tensor:
    """Receive a neighbour's x: the left one's (rank 0 gets zeros), or the
    right one's (the last rank gets zeros)."""
    i, n = mesh.coords[axis], mesh.shape[axis]
    peers = mesh.ranks[axis]
    src, dst = (i - 1, i + 1) if from_left else (i + 1, i - 1)
    out = torch.zeros_like(x)
    Dist.exchange([(x, peers[dst])] if 0 <= dst < n else [],
                  [(out, peers[src])] if 0 <= src < n else [],
                  mesh.groups[axis])
    return out


def _sp_gl_local(mag: torch.Tensor, wsi_global: torch.Tensor, mats: dict,
                 *, n_fft: int, hop: int, win_length: int, n_iter: int,
                 mesh, axis: str) -> torch.Tensor:
    """This rank's Griffin-Lim body: mag (B, F_l, n_freq) -> its normalised
    samples [i*own, i*own + own + spill) of the padded signal."""
    win = torch.as_tensor(hann_window(win_length, n_fft), device=mag.device)
    i, n = mesh.coords[axis], mesh.shape[axis]
    first, last = i == 0, i == n - 1
    f_local = mag.shape[-2]
    spill = n_fft - hop                      # boundary overlap in samples
    own = f_local * hop                      # samples owned per rank
    pad = n_fft // 2                         # centred-stft padding
    wsi = wsi_global[i * own: i * own + own + spill]

    def istft_local(X):
        y = _overlap_add(irdft(X, n_fft, "dft", mats) * win, hop)
        y[..., :spill] += _shift(y[..., own:].contiguous(), mesh, axis, True)
        head_next = _shift(y[..., :spill].contiguous(), mesh, axis, False)
        if not last:
            y = torch.cat([y[..., :own], head_next], dim=-1)
        return y * wsi

    def stft_local(y):
        # the unsharded stft reflects around the trimmed signal's ends: in
        # padded coordinates head[k] = y[2*pad - k], tail[m] =
        # y[total - pad - 2 - m], each local to the first / last rank
        ext = own + spill
        if first:
            y = torch.cat([y[..., pad + 1: 2 * pad + 1].flip(-1),
                           y[..., pad:]], dim=-1)
        if last:
            y = torch.cat([y[..., : ext - pad],
                           y[..., ext - 2 * pad - 1: ext - pad - 1].flip(-1)],
                          dim=-1)
        frames = y.unfold(-1, n_fft, hop)
        return rdft(frames * win, n_fft, "dft", mats)

    X = mag.to(torch.complex64)
    for _ in range(n_iter):
        est = stft_local(istft_local(X))
        X = mag * (est / torch.clamp(est.abs(), min=1e-8))
    return istft_local(X)


@torch.no_grad()
def griffin_lim_sp(mag_local: torch.Tensor, cfg: Config, mesh,
                   axis: str = "data", n_iter: Optional[int] = None
                   ) -> torch.Tensor:
    """Time-sharded Griffin-Lim: this rank's frames (B, F/n, n_freq) of a
    magnitude whose F frames are split evenly over ``mesh[axis]`` -> the
    whole waveform (B, hop*(F-1)), trimmed as the unsharded one, on every
    rank. Raises when the frames do not divide over the ranks (see
    ``time_slice``) or a shard is no longer than the overlap halo."""
    n_iter = cfg.n_iter if n_iter is None else n_iter
    n = mesh.shape[axis]
    f_local = mag_local.shape[-2]
    F = f_local * n
    spill = cfg.n_fft - cfg.hop_length
    if f_local * cfg.hop_length <= spill:
        raise ValueError(
            f"time-shard too fine for the OLA halo: each shard owns "
            f"{f_local} frames = {f_local * cfg.hop_length} samples, but "
            f"the overlap halo is n_fft - hop = {spill} samples; use at "
            f"most {F * cfg.hop_length // (spill + 1)} shards at this "
            f"geometry")
    dev = mag_local.device
    # the global NOLA denominator (JAX's _global_winsum_inv)
    wsi = torch.as_tensor(_ola_window_sq(F, cfg.n_fft, cfg.hop_length,
                                         cfg.win_length), device=dev)
    mats = {k: v.to(dev) for k, v in dft_consts(cfg.n_fft, "dft").items()}
    y = _sp_gl_local(mag_local.float(), wsi, mats, n_fft=cfg.n_fft,
                     hop=cfg.hop_length, win_length=cfg.win_length,
                     n_iter=n_iter, mesh=mesh, axis=axis)
    # stitch: every rank's owned samples, then the last rank's spill
    own = f_local * cfg.hop_length
    segs = Dist.all_gather_cat(y[None], mesh.groups[axis])
    y = torch.cat([segs[:, :, :own].transpose(0, 1).reshape(
        y.shape[0], n * own), segs[-1, :, own:]], dim=-1)
    pad = cfg.n_fft // 2
    return y[..., pad: cfg.n_fft + cfg.hop_length * (F - 1) - pad]


def time_slice(x: torch.Tensor, mesh, axis: str = "data", dim: int = 1
               ) -> torch.Tensor:
    """This rank's contiguous slice of a time axis (``dim``) split evenly
    over ``mesh[axis]``."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    F = x.shape[dim]
    if F % n:
        raise ValueError(f"time-sharded GL needs the frame count to divide "
                         f"by the shard count, got F={F}, shards={n}")
    return x.narrow(dim, i * (F // n), F // n)


def time_sharded_vocoder(mag_norm_local: torch.Tensor, cfg: Config, mesh,
                         axis: str = "data") -> torch.Tensor:
    """This rank's frames of a normalised linear spectrogram (B, T/n,
    n_freq) in [0, 1] -> the whole waveform on every rank: the
    denormalisation and sharpening of ``spectrogram_to_wav``, the
    time-sharded Griffin-Lim, then de-emphasis of the whole signal."""
    wav = griffin_lim_sp(denormalize_mag(mag_norm_local, cfg), cfg, mesh,
                         axis=axis)
    return deemphasis(wav, cfg.preemphasis)
