"""K2's host-side plan, checked on the CPU.

The CUDA frame kernel (``csrc/gl2.cu``) runs a mixed-radix Stockham FFT
planned by ``fft_plan``, handed to it as the table of ``fft_passes`` with
the float64 twiddle tables of ``fft_twiddles``, and exchanges every pass's
outputs in place through one shared-memory buffer at the index ``xi``.
These tests hold a numpy emulation of those passes (float64, the kernel's
loads, twiddles, butterflies and stores) to ``numpy.fft.fft`` within
1e-12, the exchange index to at most 2-way bank conflicts on every pass's
loads and stores, each warp's twiddle loads to consecutive addresses, the
pass table's offsets to the float64 table, and a float64
model of the kernel's two real frames per complex transform (pack, split,
impose, merge) to one plain round, and the window's span (the frames'
stored samples) to the window's nonzero samples, with the span
overlap-add's frame range to the full one's without its exactly-zero
terms. The exchange index and the overlap-add's frame range are evaluated
from the kernels' own source lines (``_kernel_int_exprs``), so the tests
hold the .cu, not a copy of it. No card is needed.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.dsp.stft import window_span
from dc_tts_tpu_torch.ops import gl2 as K2

WARP = 32
CSRC = pathlib.Path(K2.__file__).resolve().parents[1] / "csrc"


def _kernel_int_exprs(source: str, pattern: str) -> dict:
    """name -> numpy function source of each integer expression that
    ``pattern`` (one group per name, one per expression) finds in
    csrc/``source``: C's ``c ? a : b`` becomes np.where, ``min``
    np.minimum, ``/`` floor division (the kernels divide non-negative
    values only where the result is used)."""
    text = (CSRC / source).read_text()
    out = {}
    for name, expr in re.findall(pattern, text):
        m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
        if m:
            expr = f"np.where({m[1]}, {m[2]}, {m[3]})"
        out[name] = expr.replace("/", "//").replace("min(", "np.minimum(")
    return out


def exchange_index(i):
    """The shared-memory index of exchange element i: csrc/gl2.cu's
    ``xi``, evaluated from its source."""
    (expr,) = _kernel_int_exprs(
        "gl2.cu", r"int (xi)\(int i\) \{ return (.+?); \}").values()
    return eval(expr, {"np": np, "i": np.asarray(i)})


def ola_frame_range(s, off, span, hop, F):
    """(f_lo, f_hi): the frames whose stored samples [f*hop + off, f*hop +
    off + span) cover signal samples s (empty where f_lo > f_hi), from
    csrc/gl_ola.cuh's own lines, which the overlap-add sums from f_hi down
    to f_lo."""
    exprs = _kernel_int_exprs(
        "gl_ola.cuh",
        r"(?:const int |, )(u|t|f_hi|f_lo) = ((?:[^,;()]|\([^()]*\))+)")
    assert list(exprs) == ["u", "t", "f_hi", "f_lo"], exprs
    env = {"np": np, "s": np.asarray(s), "off": off, "len": span,
           "hop": hop, "F": F}
    for name, expr in exprs.items():
        env[name] = eval(expr, env)
    return env["f_lo"], env["f_hi"]


def _emulate_fft(x: np.ndarray) -> np.ndarray:
    """The kernel's forward transform of x (n,) in float64: a pass of 16 or
    8 (fast_pass) reads its butterfly's points, twiddles them by w^r, w^b
    from the tables (b = 1, 2, 4, 8) and the other powers as the products
    w^b w^(r - b), b the top bit of r, and takes the DFT of R points; a
    pass of 4, 2 or odd radix (sum_pass) sums each output directly from
    the n-entry table; each pass stores through the exchange index once
    every point is read (the buffer is used in place)."""
    n = x.shape[0]
    tw = K2.fft_twiddles(n)
    src = x.astype(np.complex128)        # pass 0 reads natural order
    xi = exchange_index(np.arange(n))
    assert sorted(xi) == list(range(n))  # a permutation of the buffer
    passes = K2.fft_passes(n)            # what the kernel is handed
    assert passes[:, :2].tolist() == [list(p) for p in K2.fft_plan(n)]
    off = 0
    for R, ns, tw_off in passes.tolist():
        assert tw_off == off
        dst = np.empty(n, np.complex128)
        nb = n // R
        j = np.arange(nb)
        jm = j & (ns - 1)
        o = (j - jm) * R + jm
        if R in (8, 16):
            v = np.stack([src[j + r * nb] for r in range(R)])
            if ns > 1:
                rows = R.bit_length() - 1
                t = tw[off: off + ns * rows].reshape(rows, ns)[:, jm]
                w = {1 << b: t[b] for b in range(rows)}
                for r in range(3, R):
                    top = 1 << (r.bit_length() - 1)
                    if r != top:
                        w[r] = w[top] * w[r - top]
                v[1:] *= np.stack([w[r] for r in range(1, R)])
                off += ns * rows
            v = np.fft.fft(v, axis=0)    # the butterfly's DFT of R points
            for r in range(R):
                dst[xi[o + r * ns]] = v[r]
        else:
            for k in range(R):
                step = (jm + k * ns) * (n // (ns * R))
                acc = src[j].copy()
                for r in range(1, R):
                    acc += src[j + r * nb] * tw[off + (r * step) % n]
                dst[xi[o + k * ns]] = acc
            off += n
        src = dst[xi]                    # the next pass reads through xi
    assert off == len(tw)
    return src


@pytest.mark.parametrize("n", [96, 160, 480, 1056, 2048])
def test_mixed_radix_plan_matches_numpy_fft(n):
    plan = K2.fft_plan(n)
    assert np.prod([R for R, _ in plan]) == n
    assert plan[0] == (16, 1)
    # a thread of the item's n/16 (whole warps) holds at most 16 points of
    # any pass: its butterflies' points, or the odd pass's outputs
    nt = -(-n // 16 // WARP) * WARP
    for R, _ in plan:
        assert (-(-n // (R * nt)) * R if R % 2 == 0 else -(-n // nt)) <= 16
    assert sum(R % 2 for R, _ in plan) == (n & -n != n)   # one odd pass
    assert all(R == 16 for R, _ in plan[:-2])
    x = np.random.default_rng(n).standard_normal(n) \
        + 1j * np.random.default_rng(n + 1).standard_normal(n)
    np.testing.assert_allclose(_emulate_fft(x), np.fft.fft(x), rtol=0,
                               atol=1e-12 * np.abs(np.fft.fft(x)).max())


def test_plan_at_base_config_is_four_passes():
    """Three passes at the base config's 2048 since radix 16 (four before
    it, of radix 8, 8, 8 and 4)."""
    assert K2.fft_plan(2048) == [(16, 1), (16, 16), (8, 256)]
    assert K2.fft_plan(1056) == [(16, 1), (2, 16), (33, 32)]
    for bad in (16, 100, 1000):
        with pytest.raises(ValueError):
            K2.fft_plan(bad)


def _conflict(addresses) -> int:
    """Ways of the worst bank among one warp's float2 accesses: distinct
    addresses on one bank (a float2 at index a covers banks 2*(a % 16) and
    2*(a % 16) + 1). 32 float2 need 2 at least."""
    a = np.unique(np.asarray(addresses))
    return int(np.bincount(a % 16, minlength=16).max())


def _pass_accesses(n):
    """For every pass of the plan, every load and store instruction (one r
    of a pass of 16 or 8; one term of a direct-sum pass's loads, its one
    store) and each warp (32 consecutive butterflies, or outputs): ("load" or
    "store", its exchange indices), keyed by (R, Ns), then the spectral
    step's (bins k and n - k, k = k1 + 16 k2 with k2 fastest across the
    threads)."""
    xi = exchange_index
    for R, ns in K2.fft_plan(n):
        nb = n // R
        if R not in (8, 16):
            # sum_pass: output t of the thread's is (j, k) = (t % nb, t //
            # nb); one load instruction a term r
            t = np.arange(n)
            j, k = t % nb, t // nb
            o = (j - (j & (ns - 1))) * R + (j & (ns - 1)) + k * ns
            for w in range(0, n, WARP):
                for r in range(R):
                    yield (R, ns), "load", xi(j[w: w + WARP] + r * nb)
                yield (R, ns), "store", xi(o[w: w + WARP])
            continue
        j = np.arange(nb)
        o = (j - (j & (ns - 1))) * R + (j & (ns - 1))
        for w in range(0, nb, WARP):
            for r in range(R):
                yield (R, ns), "load", xi(j[w: w + WARP] + r * nb)
                yield (R, ns), "store", xi(o[w: w + WARP] + r * ns)
    h2 = n // 32
    i = np.arange(n // 2)
    k = i // h2 + 16 * (i % h2)
    for w in range(0, n // 2, WARP):
        yield "spectral", "k", xi(k[w: w + WARP])
        yield "spectral", "n-k", xi((n - k[w: w + WARP]) % n)


@pytest.mark.parametrize("n", [2048, 1056])
def test_exchange_stores_conflict_at_most_two_way(n):
    """Every pass's loads and stores and the spectral step's accesses fall
    at most 2 on a bank at a power-of-two n. At 1056 two kinds are held to
    3: a radix-16 pass's loads, as n/16 = 66 is no multiple of 16 (a warp's
    32 consecutive loads start inside a 16-point row and span three, and no
    swizzle by rows keeps both those and the first pass's stores, 16 j + r,
    at 2); and the spectral step's, as its warps' bins cross from one k1
    to the next (n/32 = 33 bins each)."""
    worst = {}
    for key, kind, addr in _pass_accesses(n):
        worst[key, kind] = max(worst.get((key, kind), 0), _conflict(addr))
    assert len(worst) == 2 * len(K2.fft_plan(n)) + 2
    for (key, kind), ways in worst.items():
        looser = key == "spectral" and (n // 32) % WARP \
            or kind == "load" and key[0] == 16 and (n // 16) % 16
        assert ways <= (3 if looser else 2), worst
    if n & (n - 1) == 0:
        assert max(worst.values()) <= 2, worst
    # without the swizzle the first pass's stores are 32-way
    j = np.arange(WARP)
    assert _conflict(16 * j) == 32


@pytest.mark.parametrize("n", [2048, 1056])
def test_twiddle_loads_broadcast_or_distinct_banks(n):
    """A fast pass's twiddle loads, w^b at [log2 b][jm] (read through L1),
    one b a load instruction: every warp's distinct addresses are
    consecutive double2s (jm fastest), at most four 128-byte lines."""
    offs = {tuple(p[:2]): p[2] for p in K2.fft_passes(n).tolist()}
    for R, ns in K2.fft_plan(n):
        if R not in (8, 16) or ns == 1:
            continue
        jm = np.arange(n // R) & (ns - 1)
        for w in range(0, len(jm), WARP):
            for row in range(R.bit_length() - 1):
                a = np.unique(offs[R, ns] + row * ns + jm[w: w + WARP])
                assert (np.diff(a) == 1).all()
                assert len(np.unique(a * 16 // 128)) <= 4


@pytest.mark.parametrize("n", [96, 1056, 2048, 8192])
def test_pass_table_offsets_match_the_float64_table(n):
    """Each pass's offset in ``fft_passes`` is where its table starts in
    ``fft_twiddles``, the tables fill it, and ``gl2_consts`` hands the
    kernel that table in float64."""
    passes = K2.fft_passes(n)
    tw = K2.fft_twiddles(n)
    sizes = [n if R not in (8, 16) else ns * (R.bit_length() - 1)
             if ns > 1 else 0 for R, ns in K2.fft_plan(n)]
    assert passes[:, 2].tolist() == np.cumsum([0] + sizes[:-1]).tolist()
    assert passes[-1, 2] + sizes[-1] == len(tw)
    hop = n // 8
    c = K2.gl2_consts(n, hop, n // 2, 9)["fft_tw"]
    assert c.dtype == np.float64 and c.shape == (len(tw), 2)
    np.testing.assert_array_equal(c[:, 0] + 1j * c[:, 1], tw)


def _pair_round(x: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """The frame kernel's spectral step on frame pairs, float64: frames x
    (F, n) -> z = x[2p] + i x[2p+1] (a zero frame after an odd F), Z =
    fft(z), X = (Z[k] + conj Z[n-k]) / 2 and Y = (Z[k] - conj Z[n-k]) / 2i
    for k <= n/2, each scaled to mag (1e-8 floor), W = X' + i Y' with
    Hermitian halves, w = ifft(W): the new frames are Re w and Im w."""
    F, n = x.shape
    xp = torch.cat([x, x.new_zeros(F % 2, n)])
    z = torch.complex(xp[0::2], xp[1::2])
    Z = torch.fft.fft(z)
    k = torch.arange(n // 2 + 1)
    Zc = Z[:, (n - k) % n].conj()
    X, Y = (Z[:, k] + Zc) / 2, (Z[:, k] - Zc) / 2j
    mp = torch.cat([mag, mag.new_zeros(F % 2, mag.shape[1])])

    def impose(S, m):
        return m * S / torch.clamp(S.abs(), min=1e-8)
    Xn, Yn = impose(X, mp[0::2]), impose(Y, mp[1::2])
    W = torch.zeros_like(Z)
    W[:, k] = Xn + 1j * Yn
    kk = torch.arange(1, n // 2)
    W[:, n - kk] = Xn[:, kk].conj() + 1j * Yn[:, kk].conj()
    w = torch.fft.ifft(W)
    return torch.stack([w.real, w.imag], 1).reshape(-1, n)[:F]


@pytest.mark.parametrize("F", [12, 13])
@pytest.mark.parametrize("n", [96, 480])
def test_pair_split_merge_reproduces_a_plain_round(n, F):
    """One round on frame pairs equals the plain round on single frames
    (rfft, normalise, irfft) within 1e-12, an odd F included."""
    rng = np.random.default_rng(F)
    x = torch.as_tensor(rng.standard_normal((F, n)))
    mag = torch.as_tensor(rng.random((F, n // 2 + 1)) + 0.05)
    X = torch.fft.rfft(x)
    want = torch.fft.irfft(mag * X / torch.clamp(X.abs(), min=1e-8), n)
    got = _pair_round(x, mag)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)


GEOMS = {"base": (2048, 275, 1102, 840), "test": (256, 8, 32, 96),
         "jax_gl2": (512, 69, 275, 160), "n1056": (1056, 142, 568, 61)}


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_window_span_covers_every_nonzero_sample(name):
    n, hop, wl, F = GEOMS[name]
    win = K2.gl2_consts(n, hop, wl, F)["win"][0]
    off, span = window_span(n, wl)
    inside = np.zeros(n, bool)
    inside[off: off + span] = True
    assert (win[~inside] == 0).all()
    assert win[off] != 0 and win[off + span - 1] != 0
    assert span <= wl
    if name == "base":
        assert (off, span) == (474, 1101)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_span_overlap_add_drops_only_zero_terms(name):
    """For every sample of the signal, the frames the span overlap-add sums
    are the full-frame overlap-add's frames whose windowed term is not
    exactly zero, in the same order (last frame first)."""
    n, hop, wl, F = GEOMS[name]
    win = K2.gl2_consts(n, hop, wl, F)["win"][0]
    off, span = window_span(n, wl)
    samples = np.arange(n + hop * (F - 1))
    los, his = ola_frame_range(samples, 0, n, hop, F)
    los_s, his_s = ola_frame_range(samples, off, span, hop, F)
    for s, lo, hi, lo_s, hi_s in zip(samples.tolist(), los.tolist(),
                                     his.tolist(), los_s.tolist(),
                                     his_s.tolist()):
        full = [f for f in range(hi, lo - 1, -1) if win[s - f * hop] != 0]
        assert list(range(hi_s, lo_s - 1, -1)) == full, s
        assert len(full) <= -(-span // hop)
