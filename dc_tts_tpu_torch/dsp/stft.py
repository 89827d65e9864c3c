"""Centered STFT / iSTFT, the port of ``dc_tts_tpu/dsp/stft.py``.

Conventions match librosa's defaults as the original DC-TTS uses them:
center=True (reflect pad n_fft//2), a periodic Hann of win_length
zero-padded symmetrically to n_fft, NOLA normalisation by the summed squared
window. Layout is time-major (..., frames, freq). Overlap-add sums the P =
ceil(n_fft/hop) frame streams in the same order as the JAX package.

Transform backends (``method``), as in the JAX package:
* ``"fft"``: ``torch.fft``.
* ``"dft"``: the real DFT as float32 matrix products (x @ C, x @ S), full
  float32 on the card (TF32 off, see ``device.fp32_numerics``).
* ``"dft_3x"``: the same products as the explicit 3-pass bf16 sum
  xh@Mh + xh@Ml + xl@Mh of hi/lo bf16 splits (what ``Precision.HIGH`` is on
  the TPU), each product taken on bf16 values upcast to float32.
* ``"dft_bf16"``: single-pass, operands rounded to bf16 and multiplied in
  float32 (a bf16 x bf16 product is exact in float32; the sum stays float32,
  as on the TPU's matrix unit). ``torch.matmul`` on bf16 tensors would round
  the output to bf16 on the card, so it is not used.
* ``"ct"``: a Cooley-Tukey factored DFT (n_fft = 128 x N2): two 128-point
  float32 matrix products and an N2-point multiply-reduce (an einsum).
``"dft_mixed"`` and ``"dft_pallas"`` name Griffin-Lim schedules; as a
transform they are ``"dft"``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# transform names rdft/irdft accept besides "fft" and "ct"
_DFT_METHODS = ("dft", "dft_3x", "dft_bf16", "dft_mixed", "dft_pallas")


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of win_length, centered in an n_fft buffer (float32)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad: lpad + win_length] = w
    return out.astype(np.float32)


@functools.lru_cache(maxsize=16)
def window_span(n_fft: int, win_length: int) -> tuple[int, int]:
    """(off, len): the nonzero samples [off, off + len) of
    ``hann_window(win_length, n_fft)``, read off the window itself. Outside
    them every windowed sample is exactly 0, so the Griffin-Lim kernels
    (K2, K3) skip them."""
    nz = np.flatnonzero(hann_window(win_length, n_fft))
    return int(nz[0]), int(nz[-1]) + 1 - int(nz[0])


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Frame count for a centered STFT: 1 + n_samples // hop."""
    return 1 + n_samples // hop


@functools.lru_cache(maxsize=8)
def frame_indices(n_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """(n_frames, n_fft) int32 indices into the padded signal (for tests
    and oracles; the transforms here never gather)."""
    return (np.arange(n_frames)[:, None] * hop
            + np.arange(n_fft)[None, :]).astype(np.int32)


def _ola_window_sq(n_frames: int, n_fft: int, hop: int,
                   win_length: int) -> np.ndarray:
    """1 / summed squared window (NOLA), with sums <= 1e-11 read as 1."""
    win = hann_window(win_length, n_fft).astype(np.float64)
    total = n_fft + hop * (n_frames - 1)
    wsq = np.zeros(total)
    for f in range(n_frames):
        wsq[f * hop: f * hop + n_fft] += win * win
    wsq[wsq <= 1e-11] = 1.0
    return (1.0 / wsq).astype(np.float32)


def _window(win_length: int, n_fft: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(hann_window(win_length, n_fft), device=like.device)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """frames (..., F, n_fft) -> (..., n_fft + hop*(F-1)): stream j adds
    segment j of every frame f into output segment f + j."""
    *batch, n_frames, n_fft = frames.shape
    P = -(-n_fft // hop)
    c = F.pad(frames, (0, P * hop - n_fft)).reshape(*batch, n_frames, P, hop)
    out = frames.new_zeros(*batch, n_frames + P - 1, hop)
    for j in range(P):
        out[..., j: j + n_frames, :] += c[..., :, j, :]
    return out.reshape(*batch, -1)[..., : n_fft + hop * (n_frames - 1)]


# ---------------------------------------------------------------------------
# DFT matmul constants


@functools.lru_cache(maxsize=8)
def _dft_mats(n_fft: int, dtype: str = "float32"):
    """Forward rDFT as two real matmuls: X = x @ C + i * x @ S, each
    (n_fft, n_freq), float32 or bf16 (rounded from float64)."""
    n = np.arange(n_fft)
    f = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(n, f) / n_fft
    return _cast(np.cos(ang), dtype), _cast(-np.sin(ang), dtype)


@functools.lru_cache(maxsize=8)
def _idft_mats(n_fft: int, dtype: str = "float32"):
    """Inverse rDFT as two real matmuls: x = Re(X) @ A + Im(X) @ B, each
    (n_freq, n_fft). Hermitian weights: DC and Nyquist once, every other
    bin twice, all over n_fft."""
    n = np.arange(n_fft)
    f = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(f, n) / n_fft
    w = np.full((n_fft // 2 + 1, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    return (_cast(np.cos(ang) * w / n_fft, dtype),
            _cast(-np.sin(ang) * w / n_fft, dtype))


def _cast(x64: np.ndarray, dtype: str) -> torch.Tensor:
    """float64 -> float32 or bf16 (torch, like ``ml_dtypes`` for the JAX
    package, rounds float64 to bf16 through float32)."""
    return torch.from_numpy(x64).to(getattr(torch, dtype))


def split_bf16(x: torch.Tensor):
    """float32 -> (hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _mm(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m in float32; a bf16 m is upcast exactly."""
    return torch.matmul(x, m.to(x.device, torch.float32))


def _mm_bf16(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Single pass: x rounded to bf16, products and sums in float32."""
    return _mm(x.to(torch.bfloat16).float(), m)


def _mm3x(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """3-pass bf16: xh@Mh + xh@Ml + xl@Mh (xl@Ml is below float32 noise)."""
    xh, xl = (t.float() for t in split_bf16(x))
    mh, ml = split_bf16(m.to(x.device, torch.float32))
    return _mm(xh, mh) + _mm(xh, ml) + _mm(xl, mh)


def _dft_variant(method: str):
    """-> (matrix dtype, matmul) for a dft-family method."""
    if method not in _DFT_METHODS:
        raise ValueError(f"unknown stft method {method!r}")
    if method.endswith("bf16"):
        return "bfloat16", _mm_bf16
    if method.endswith("3x"):
        return "float32", _mm3x
    return "float32", _mm


# ---------------------------------------------------------------------------
# Cooley-Tukey factored DFT ("ct"): n_fft = 128 * N2; a 128-point matrix
# product stage and an N2-point multiply-reduce stage.

_CT_N1 = 128


@functools.lru_cache(maxsize=8)
def _ct_mats(n_fft: int) -> dict:
    """The factored transform's float32 constants; n_fft % 256 == 0 (N2
    even, so the rfft bins split into N2/2 blocks of 128 plus Nyquist)."""
    if n_fft % (2 * _CT_N1) != 0:
        raise ValueError(
            f"stft method 'ct' needs n_fft % {2 * _CT_N1} == 0, got {n_fft}")
    N1, N2 = _CT_N1, n_fft // _CT_N1
    B2 = N2 // 2
    n1 = np.arange(N1)
    ang1 = 2.0 * np.pi * np.outer(n1, n1) / N1
    # E2[b, n2, k1] = exp(-2 pi i n2 (k1 + 128 b) / N)
    n2 = np.arange(N2)[None, :, None]
    k = (np.arange(N1)[None, None, :]
         + N1 * np.arange(B2)[:, None, None]).astype(np.float64)
    ang2 = 2.0 * np.pi * n2 * k / n_fft
    # G[n2, k2, k1] = exp(+2 pi i n2 (k1 + 128 k2) / N)
    n2i = np.arange(N2)[:, None, None]
    ki = (np.arange(N1)[None, None, :]
          + N1 * np.arange(N2)[None, :, None]).astype(np.float64)
    angG = 2.0 * np.pi * n2i * ki / n_fft
    mats = {"C1": np.cos(ang1), "S1": -np.sin(ang1),
            "E2c": np.cos(ang2), "E2s": -np.sin(ang2),
            "alt": (-1.0) ** np.arange(N2),
            "Gc": np.cos(angG), "Gs": np.sin(angG),
            "Cb": np.cos(ang1) / n_fft, "Sb": np.sin(ang1) / n_fft}
    return {k_: torch.from_numpy(np.asarray(v).astype(np.float32))
            for k_, v in mats.items()}


def _on(m: dict, like: torch.Tensor) -> dict:
    return {k: v.to(like.device) for k, v in m.items()}


def _ct_rdft(frames: torch.Tensor, n_fft: int, m: dict) -> torch.Tensor:
    """(.., F, n_fft) real -> (.., F, n_freq) complex64."""
    m = _on(m, frames)
    N1, N2 = _CT_N1, n_fft // _CT_N1
    x = frames.reshape(*frames.shape[:-1], N1, N2).transpose(-1, -2)
    Yr, Yi = _mm(x, m["C1"]), _mm(x, m["S1"])      # (.., N2, N1) [n2, k1]
    Y = torch.stack([Yr, Yi], dim=-3)              # (.., 2, N2, N1)
    # the N2-point stage: X[b, k1] = sum_n2 Y[n2, k1] E2[b, n2, k1]
    Xr = torch.einsum("...cnk,cbnk->...bk", Y,
                      torch.stack([m["E2c"], -m["E2s"]]))
    Xi = torch.einsum("...cnk,cbnk->...bk", Y,
                      torch.stack([m["E2s"], m["E2c"]]))
    Xr = Xr.reshape(*Xr.shape[:-2], n_fft // 2)
    Xi = Xi.reshape(*Xi.shape[:-2], n_fft // 2)
    nyq_r = (Yr[..., 0] * m["alt"]).sum(-1, keepdim=True)
    nyq_i = (Yi[..., 0] * m["alt"]).sum(-1, keepdim=True)
    return torch.complex(torch.cat([Xr, nyq_r], -1),
                         torch.cat([Xi, nyq_i], -1))


def _ct_irdft(X: torch.Tensor, n_fft: int, m: dict) -> torch.Tensor:
    """(.., F, n_freq) complex -> (.., F, n_fft) real."""
    m = _on(m, X)
    N1, N2 = _CT_N1, n_fft // _CT_N1
    Xr, Xi = X.real, X.imag
    # the full spectrum by conjugate symmetry: X[N-k] = conj(X[k])
    Xr = torch.cat([Xr, torch.flip(Xr[..., 1:-1], [-1])], -1)
    Xi = torch.cat([Xi, -torch.flip(Xi[..., 1:-1], [-1])], -1)
    Xs = torch.stack([Xr, Xi], dim=-2).reshape(*Xr.shape[:-1], 2, N2, N1)
    # twiddled N2-point inverse over k2: Z[n2, k1]
    Zr = torch.einsum("...ckq,cnkq->...nq", Xs,
                      torch.stack([m["Gc"], -m["Gs"]]))
    Zi = torch.einsum("...ckq,cnkq->...nq", Xs,
                      torch.stack([m["Gs"], m["Gc"]]))
    x = _mm(Zr, m["Cb"]) - _mm(Zi, m["Sb"])       # (.., N2, N1) [n2, n1]
    return x.transpose(-1, -2).reshape(*x.shape[:-2], n_fft)


def dft_consts(n_fft: int, method: str) -> dict:
    """The DFT matmul constants of ``method`` as CPU tensors (empty for
    "fft" and "dft_pallas2"); the keys are the JAX package's."""
    if method in ("fft", "dft_pallas2"):
        return {}
    if method == "ct":
        return dict(_ct_mats(n_fft))
    if method in ("dft_mixed", "dft_pallas"):
        # bf16 matrices for the single-pass middle rounds, float32 for the
        # 3-pass head/tail and the final synthesis iSTFT
        C, S = _dft_mats(n_fft, "float32")
        A, B = _idft_mats(n_fft, "float32")
        Cb, Sb = _dft_mats(n_fft, "bfloat16")
        Ab, Bb = _idft_mats(n_fft, "bfloat16")
        return {"C": C, "S": S, "A": A, "B": B,
                "Cb": Cb, "Sb": Sb, "Ab": Ab, "Bb": Bb}
    dt, _ = _dft_variant(method)
    C, S = _dft_mats(n_fft, dt)
    A, B = _idft_mats(n_fft, dt)
    d = {"C": C, "S": S, "A": A, "B": B}
    if dt == "bfloat16":
        # the final synthesis iSTFT always runs in float32
        d["A32"], d["B32"] = _idft_mats(n_fft, "float32")
    return d


def rdft(frames: torch.Tensor, n_fft: int, method: str = "fft",
         mats: dict | None = None) -> torch.Tensor:
    """(.., F, n_fft) real -> (.., F, n_freq) complex."""
    if method == "fft":
        return torch.fft.rfft(frames, dim=-1)
    if method == "ct":
        return _ct_rdft(frames, n_fft, mats if mats is not None
                        else _ct_mats(n_fft))
    dt, mm = _dft_variant(method)
    C, S = (mats["C"], mats["S"]) if mats is not None \
        else _dft_mats(n_fft, dt)
    return torch.complex(mm(frames, C), mm(frames, S))


def irdft(X: torch.Tensor, n_fft: int, method: str = "fft",
          mats: dict | None = None) -> torch.Tensor:
    """(.., F, n_freq) complex -> (.., F, n_fft) real."""
    if method == "fft":
        return torch.fft.irfft(X, n=n_fft, dim=-1)
    if method == "ct":
        return _ct_irdft(X, n_fft, mats if mats is not None
                         else _ct_mats(n_fft))
    dt, mm = _dft_variant(method)
    A, B = (mats["A"], mats["B"]) if mats is not None \
        else _idft_mats(n_fft, dt)
    return mm(X.real.contiguous(), A) + mm(X.imag.contiguous(), B)


def stft(y: torch.Tensor, n_fft: int, hop: int, win_length: int,
         method: str = "fft", mats: dict | None = None) -> torch.Tensor:
    """y (..., n) -> complex (..., 1 + n//hop, n_freq)."""
    pad = n_fft // 2
    lead = y.shape[:-1]
    yp = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    frames = yp.reshape(*lead, -1).unfold(-1, n_fft, hop)
    return rdft(frames * _window(win_length, n_fft, y), n_fft, method, mats)


def istft(S: torch.Tensor, n_fft: int, hop: int, win_length: int,
          method: str = "fft", mats: dict | None = None) -> torch.Tensor:
    """S (..., n_frames, n_freq) complex -> (..., hop*(n_frames-1)) real:
    windowed inverse DFT frames, overlap-add, NOLA, trim n_fft//2 from both
    ends."""
    f = S.shape[-2]
    frames = irdft(S, n_fft, method, mats) * _window(win_length, n_fft, S)
    y = _overlap_add(frames, hop) * torch.as_tensor(
        _ola_window_sq(f, n_fft, hop, win_length), device=S.device)
    pad = n_fft // 2
    return y[..., pad: n_fft + hop * (f - 1) - pad]
