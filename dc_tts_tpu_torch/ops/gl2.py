"""Kernel K2: all Griffin-Lim rounds of a batch, the port of
``dc_tts_tpu/ops/pallas_gl2.py:gl2_run`` (kernel body ``_kernel``).

The function: X0 = magnitude with zero phase; each round takes the inverse
DFT of the full n_fft-bin spectrum, windows it (periodic, centred Hann),
overlap-adds the frames, divides by the summed squared window (NOLA), trims
librosa's centre padding and reflect-pads again (together the identity on
the interior and a mirror of the n_fft/2-sample edges), re-frames, windows,
takes the forward DFT, normalises the phase with a 1e-8 floor and imposes
the magnitude again. A final inverse STFT without the reflect gives the
waveform [pad : pad + L_sig]. The TPU kernel's bf16 middle rounds are not
ported: every round here is float32.

On the H100 (csrc/gl2.cu): per utterance a round is F transforms each way
of n_fft points, ~2 * 5 n_fft log2(n_fft) * F operations (0.19 GFLOP at
F=840, n_fft=2048), and the state (the frames of one round) is 6.9 MB per
utterance, which cannot stay in one SM's shared memory across rounds as it
stays in VMEM on the TPU. So the state lives in device memory and each
round is two launches over (frame, utterance):
  * frame kernel, one block per frame: read the frame's n_fft samples of
    the reflect-padded signal, window, forward FFT in shared memory (mixed
    radix-8 Stockham: four passes at n_fft=2048, so few roundings for the
    phase normalisation of near-zero bins to amplify), impose the magnitude
    on every bin of the full spectrum, inverse FFT, window, write the frame;
  * OLA kernel, one thread per sample: sum the <= ceil(n_fft/hop)
    overlapping frames (in the TPU kernel's order), multiply by 1/sum(w^2),
    and read mirrored positions for the reflect-padded edges.
This spreads every round over F*B blocks, so all SMs work at any batch,
where one block per utterance for all rounds would leave most SMs idle at
B=72 and serialise 840 frames per SM. The spectrum is never stored: the
frame kernel goes from the waveform to the next round's frame in one pass.

``gl2_run`` launches the kernels for CUDA tensors and runs
``gl2_run_plain`` (the torch.fft loop) for CPU tensors only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dsp.stft import _ola_window_sq, hann_window

_N1 = 16


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class GL2Geom(NamedTuple):
    n_fft: int
    hop: int
    win_length: int
    F: int
    N2: int          # n_fft // 16
    P: int           # ceil(n_fft / hop)
    F2: int          # F padded to a multiple of 8
    rows_y: int      # waveform buffer rows (hop samples each)
    pad: int         # n_fft // 2
    L_sig: int       # trimmed istft length
    edge_rows: int   # mirror scratch rows of the TPU kernel


def gl2_geometry(n_fft: int, hop: int, win_length: int, F: int) -> GL2Geom:
    """The TPU kernel's geometry, field for field; the scrambled magnitude
    layout (B, 16, F2, N2) is the kernels' shared input format."""
    if n_fft % (2 * _N1) != 0:
        raise ValueError(
            f"fused whole-loop GL needs n_fft % {2 * _N1} == 0, "
            f"got n_fft={n_fft}")
    pad = n_fft // 2
    P = -(-n_fft // hop)
    F2 = _ceil_to(F, 8)
    L_sig = n_fft + hop * (F - 1) - 2 * pad
    rows_y = max(F2 + P - 1, -(-(2 * pad + L_sig) // hop) + 1)
    rows_y = _ceil_to(rows_y, 8)
    edge_rows = _ceil_to(pad // hop + 2, 8)
    return GL2Geom(n_fft, hop, win_length, F, n_fft // _N1, P, F2, rows_y,
                   pad, L_sig, edge_rows)


def gl2_consts(n_fft: int, hop: int, win_length: int, F: int) -> dict:
    """Host constants (float32): the window "win" (1, n_fft), the NOLA
    factor "wsq" (rows_y, hop) padded with ones, as the TPU kernel's, and
    the FFT twiddles "fft_tw" (n_fft/2, 2) = (cos, -sin)(2 pi k / n_fft)
    computed in float64."""
    g = gl2_geometry(n_fft, hop, win_length, F)
    wsq = _ola_window_sq(F, n_fft, hop, win_length)
    wsq_seg = np.ones((g.rows_y * hop,), np.float32)
    n = min(wsq.shape[0], wsq_seg.shape[0])
    wsq_seg[:n] = wsq[:n]
    ang = 2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    return {"win": hann_window(win_length, n_fft).reshape(1, n_fft),
            "wsq": wsq_seg.reshape(g.rows_y, hop),
            "fft_tw": np.ascontiguousarray(tw, np.float32)}


def scramble_mag(mag: torch.Tensor, g: GL2Geom) -> torch.Tensor:
    """(..., F, n_freq) magnitude -> (..., 16, F2, N2): the full mirrored
    spectrum, bin k = k1 + 16*k2 at [k1, f, k2]."""
    F, nf = mag.shape[-2], mag.shape[-1]
    assert nf == g.n_fft // 2 + 1
    full = torch.cat([mag, torch.flip(mag[..., 1:-1], dims=[-1])], dim=-1)
    full = torch.nn.functional.pad(full, (0, 0, 0, g.F2 - F))
    full = full.reshape(*full.shape[:-1], g.N2, _N1)
    return torch.movedim(full, -1, -3).contiguous()


def unscramble_mag(mag_scr: torch.Tensor, g: GL2Geom) -> torch.Tensor:
    """Inverse of ``scramble_mag``: (..., 16, F2, N2) -> (..., F, n_freq)."""
    full = torch.movedim(mag_scr, -3, -1)
    full = full.reshape(*full.shape[:-2], g.n_fft)
    return full[..., : g.F, : g.n_fft // 2 + 1]


# ---------------------------------------------------------------------------
# plain version


def gl2_run_plain(mag_scr: torch.Tensor, consts: dict, g: GL2Geom,
                  n_iter: int) -> torch.Tensor:
    """K2's function in PyTorch: the torch.fft Griffin-Lim loop on the
    unscrambled magnitude. (B, 16, F2, N2) -> (B, L_sig), in the input's
    precision: float32, or float64 as a reference for both versions."""
    from ..dsp.griffin_lim import _griffin_lim_fft
    return _griffin_lim_fft(unscramble_mag(mag_scr, g), g.n_fft, g.hop,
                            g.win_length, n_iter)


# ---------------------------------------------------------------------------
# wrapper


def gl2_run(mag_scr: torch.Tensor, consts: dict, g: GL2Geom,
            n_iter: int) -> torch.Tensor:
    """Run every Griffin-Lim round. mag_scr (B, 16, F2, N2) float32 from
    ``scramble_mag`` -> (B, L_sig). CUDA tensors launch the kernels (one
    counted launch per call: 2*n_iter + 2 kernel launches on the current
    stream); CPU tensors take ``gl2_run_plain``."""
    if mag_scr.device.type == "cpu":
        return gl2_run_plain(mag_scr, consts, g, n_iter)
    if mag_scr.device.type != "cuda":
        raise ValueError(f"gl2_run: unsupported device {mag_scr.device}")
    from ._build import check, load_library

    dev = mag_scr.device
    B = mag_scr.shape[0]
    n = g.n_fft
    if tuple(mag_scr.shape) != (B, _N1, g.F2, g.N2) \
            or mag_scr.dtype != torch.float32 or not mag_scr.is_contiguous():
        raise ValueError(f"gl2_run: mag_scr must be contiguous float32 "
                         f"(B, {_N1}, {g.F2}, {g.N2}), got "
                         f"{tuple(mag_scr.shape)} {mag_scr.dtype}")
    if n & (n - 1) or n < 32:
        raise ValueError(f"gl2_run: the CUDA kernel's FFT needs a "
                         f"power-of-two n_fft >= 32, got {n}")
    if n_iter < 0:
        raise ValueError(f"gl2_run: n_iter must be >= 0, got {n_iter}")
    win, wsq, tw = (torch.as_tensor(consts[k], dtype=torch.float32,
                                    device=dev).contiguous()
                    for k in ("win", "wsq", "fft_tw"))
    if win.numel() != n or wsq.numel() != g.rows_y * g.hop \
            or tw.numel() != n:
        raise ValueError("gl2_run: consts do not match the geometry")
    lib = load_library()
    frames = torch.empty(B, g.F, n, device=dev)
    yp = torch.empty(B, n + g.hop * (g.F - 1), device=dev)
    out = torch.empty(B, g.L_sig, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.dctts_gl2(mag_scr.data_ptr(), win.data_ptr(), wsq.data_ptr(),
                         tw.data_ptr(), frames.data_ptr(), yp.data_ptr(),
                         out.data_ptr(), B, n, g.hop, g.F, g.F2, g.pad,
                         g.L_sig, n_iter, stream)
    check(code, "Griffin-Lim kernels")
    gl2_run.launches += 1
    return out


gl2_run.launches = 0
