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

On the H100 (csrc/gl2.cu): per utterance a round is F real transforms
each way of n_fft points, ~2 * 2.5 n_fft log2(n_fft) * F operations, and
the state (one round's frames) is 3.7 MB per utterance at base_config(),
which cannot stay in one SM's shared memory across rounds as it stays in
VMEM on the TPU. So the frames live in device memory and each round is two
launches:
  * frame kernel, persistent: one work item a block, n_fft/16 threads (128
    at base_config(), in whole warps), as many blocks as fit on the card
    (the occupancy query), each taking items (a pair of frames f, f + 1 of
    one utterance) from a counter per launch. An item reads the pair's
    samples of the reflect-padded signal over the window's nonzero span
    only (``dsp.stft.window_span``: [474, 1575) of 2048 at base_config()),
    windows them, and takes ONE complex forward FFT of z = x0 + i x1;
    splits the two spectra (X = (Z[k] + conj Z[n-k]) / 2, Y = (Z[k] - conj
    Z[n-k]) / 2i), imposes the magnitude on bins 0..n/2 of each (phase
    with a 1e-8 floor; the n/2 + 1 distinct bins read from the scrambled
    layout), merges W = X' + i Y' with exact Hermitian halves, in place,
    takes one inverse FFT and stores Re w and Im w, windowed, over the
    span: frames (B, F, span). An odd F pairs its last frame with a zero
    frame;
  * overlap-add kernel (csrc/gl_ola.cuh, shared with K3, which passes the
    whole frame as its span), one thread per sample: the <= ceil(span /
    hop) frames that cover it, in the TPU kernel's order (last frame
    first), times 1/sum(w^2), mirrored positions for the reflect-padded
    edges. The dropped terms are window zeros, so the result is bitwise
    that of summing every frame.
The FFT (``fft_plan``): n_fft = 2^a * m (m odd) as radix-16 Stockham
passes, then one of 8, 4 or 2, then for m > 1 one pass of radix m; three
passes at 2048 (16, 16, 8). Each thread holds 16 points of a pass in
registers: one radix-16 butterfly or two of radix 8, whose outputs it
narrows to float32 before the exchange; a pass of 4, 2 or odd radix is a
direct sum (rolled loops, kept small: no cell's plan has one). Shared
memory holds one float32 exchange buffer of n_fft points an item (16 KB at
2048), used in place: a pass loads, computes, meets a block barrier and
stores, through an XOR swizzle (csrc/gl2.cu:xi) that keeps every pass's
loads and stores at most 2-way bank conflicted at power-of-two n_fft.
Twiddles come from per-pass tables computed and kept in float64
(``fft_twiddles``), read through L1: w, w^2, w^4 (and w^8) of a fast pass,
the other powers formed as products. The butterflies compute in float64
(the exchange and every array in device memory but the tables stay
float32): the phase normalisation of near-zero bins amplifies rounding,
and with two frames in one transform float32 butterflies put the waveform
1.02e-5 from the float64 plain version after one round at the smoke's
input, over the 1e-5 gate. n_fft is at most 16 x 512 = 8192 (the threads
an item).

``gl2_run`` launches the kernels for CUDA tensors and runs
``gl2_run_plain`` (the torch.fft loop) for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp.stft import _ola_window_sq, hann_window, window_span
from ..utils.profiling import count

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


def fft_plan(n: int) -> list[tuple[int, int]]:
    """The CUDA kernel's passes over n = 2^a * m points (m odd, n % 32 ==
    0; handed to csrc/gl2.cu by ``fft_passes``): (R, Ns) for each, a pass
    of radix R after Ns points have been combined. Radix 16 while it
    divides what is left of 2^a, then one pass of 8, 4 or 2, then one pass
    of radix m if m > 1."""
    if n < 2 * _N1 or n % (2 * _N1):
        raise ValueError(f"fft_plan: n must be a multiple of 32, got {n}")
    m = n
    while m % 2 == 0:
        m //= 2
    p2, ns, plan = n // m, 1, []
    while p2 // ns >= 16:
        plan.append((16, ns))
        ns *= 16
    if p2 // ns > 1:
        plan.append((p2 // ns, ns))
        ns = p2
    if m > 1:
        plan.append((m, ns))
    return plan


def _twiddle_count(n: int, R: int, ns: int) -> int:
    """Entries of pass (R, Ns)'s twiddle table (``fft_twiddles``)."""
    if R in (8, 16):
        return ns * (R.bit_length() - 1) if ns > 1 else 0
    return n


def fft_passes(n: int) -> np.ndarray:
    """The plan as the CUDA kernel takes it: (R, Ns, the offset of the
    pass's table in ``fft_twiddles``) for each pass, int32 (passes, 3)."""
    plan = fft_plan(n)
    offs = np.cumsum([0] + [_twiddle_count(n, R, ns) for R, ns in plan])
    return np.array([(R, ns, o) for (R, ns), o in zip(plan, offs)],
                    np.int32)


@functools.lru_cache(maxsize=16)
def fft_twiddles(n: int) -> np.ndarray:
    """The kernel's twiddle tables, complex128, concatenated in pass order:
    pass (R, Ns) of radix 16 or 8 with Ns > 1 takes w^b, w = exp(-2 pi i
    jm / (Ns R)), at [log2 b][jm] for b = 1, 2, 4 (and 8 at radix 16), jm
    < Ns (the kernel forms the other powers as products); a pass of radix
    4, 2 or odd (a direct sum) exp(-2 pi i k / n) for k < n."""
    parts = []
    for R, ns in fft_plan(n):
        if R not in (8, 16):
            parts.append(np.exp(-2j * np.pi * np.arange(n) / n))
        elif ns > 1:
            b, jm = np.meshgrid(2 ** np.arange(R.bit_length() - 1),
                                np.arange(ns), indexing="ij")
            parts.append(np.exp(-2j * np.pi * b * jm / (ns * R)).ravel())
    tw = np.concatenate(parts) if parts else np.zeros(0, np.complex128)
    tw.setflags(write=False)   # cached: shared by every caller
    return tw


def gl2_consts(n_fft: int, hop: int, win_length: int, F: int) -> dict:
    """Host constants: the window "win" (1, n_fft) and the NOLA factor
    "wsq" (rows_y, hop) padded with ones, float32, as the TPU kernel's, and
    the FFT's twiddle tables "fft_tw" (n_tw, 2) = (Re, Im) of
    ``fft_twiddles``, float64."""
    g = gl2_geometry(n_fft, hop, win_length, F)
    wsq = _ola_window_sq(F, n_fft, hop, win_length)
    wsq_seg = np.ones((g.rows_y * hop,), np.float32)
    n = min(wsq.shape[0], wsq_seg.shape[0])
    wsq_seg[:n] = wsq[:n]
    tw = fft_twiddles(n_fft)
    return {"win": hann_window(win_length, n_fft).reshape(1, n_fft),
            "wsq": wsq_seg.reshape(g.rows_y, hop),
            "fft_tw": np.ascontiguousarray(
                np.stack([tw.real, tw.imag], axis=-1), np.float64)}


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
    counted launch per call: a memset of the frame kernel's work counters
    and 2*n_iter + 2 kernel launches on the current stream); CPU tensors
    take ``gl2_run_plain``."""
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
    if n_iter < 0:
        raise ValueError(f"gl2_run: n_iter must be >= 0, got {n_iter}")
    win, wsq = (torch.as_tensor(consts[k], dtype=torch.float32,
                                device=dev).contiguous()
                for k in ("win", "wsq"))
    tw = torch.as_tensor(consts["fft_tw"], dtype=torch.float64,
                         device=dev).contiguous()
    n_tw = len(fft_twiddles(n))
    if win.numel() != n or wsq.numel() != g.rows_y * g.hop \
            or tw.numel() != 2 * n_tw:
        raise ValueError("gl2_run: consts do not match the geometry")
    passes = fft_passes(n)
    lib = load_library()
    off, span = window_span(n, g.win_length)
    frames = torch.empty(B, g.F, span, device=dev)
    yp = torch.empty(B, n + g.hop * (g.F - 1), device=dev)
    out = torch.empty(B, g.L_sig, device=dev)
    counters = torch.empty(n_iter + 1, dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 4)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.dctts_gl2(mag_scr.data_ptr(), win.data_ptr(), wsq.data_ptr(),
                         tw.data_ptr(), frames.data_ptr(), yp.data_ptr(),
                         out.data_ptr(), counters.data_ptr(),
                         passes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                         len(passes), B, n, g.hop, g.F, g.F2, g.pad, g.L_sig,
                         n_iter, n_tw, off, span, info, stream)
    check(code, "Griffin-Lim kernels")
    count("k2.launches")
    gl2_run.frame = dict(zip(("grid", "threads", "blocks_per_sm",
                              "registers"), info))
    return out


# the frame kernel's last launch: its blocks, threads a block (one item
# each), resident blocks a SM and registers a thread
gl2_run.frame = None
