"""The port's K3 round and Griffin-Lim methods against the JAX package on
the CPU:

* ``gl_geometry`` field-equal and every ``gl_fused_consts`` entry bit-equal
  (bf16 as uint16), the bf16 matrices as slices of the CUDA kernels'
  layouts;
* the plain K3 round (``fused_gl_round`` on CPU tensors), one- and 3-pass,
  against JAX's ``fused_gl_round(..., interpret=True)`` at the JAX test's
  geometry (512/69/275, F=160, B=2): max |d| <= 2e-2 (the JAX test's bar)
  and mean |d| <= 1e-5 (a wrong overlap-add or window gives O(0.1));
  padded rows exactly 0; the tight-fp1 and no-leak geometries of
  tests/test_pallas_gl.py, and consts built for another F in one fp1
  bucket rebuilt;
* ``window_span``: the kernels' tiles it keeps cover every nonzero window
  sample, and the round taken tile by tile over those tiles only equals the
  round over every tile bitwise (the skipped work is exactly zero);
* the mixed schedule's (head, mid, tail), and ``griffin_lim`` at n_iter=1
  for fft, dft and ct within 1e-4 of JAX's waveform;
* full schedules on tests/test_dsp.py's bistable two-tone probe, under the
  gates of tests/test_dsp.py and tests/test_pallas_gl.py.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.dsp import griffin_lim as tgl
from dc_tts_tpu_torch.dsp import stft as tstft
from dc_tts_tpu_torch.ops import gl as K3
from dc_tts_tpu_torch.utils import profiling

jgl = import_module("dc_tts_tpu.dsp.griffin_lim")
jstft = import_module("dc_tts_tpu.dsp.stft")
jk3 = import_module("dc_tts_tpu.ops.pallas_gl")

torch.set_num_threads(1)

N_FFT, HOP, WIN_L, F, B = 512, 69, 275, 160, 2
NF = N_FFT // 2 + 1


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) \
            if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("geom", [(512, 69, 275, 160), (512, 69, 275, 152),
                                  (512, 69, 275, 124), (2048, 275, 1102, 840),
                                  (2048, 275, 1102, 125)])
def test_geometry_and_consts_match_jax(geom):
    g = K3.gl_geometry(*geom)
    assert tuple(g) == tuple(jk3.gl_geometry(*geom))
    assert g.ly == geom[0] + geom[1] * (geom[3] - 1)
    got, want = K3.gl_fused_consts(*geom), jk3.gl_fused_consts(*geom)
    # JAX's bf16 matrices ("Ab", "Ab_lo", ...) are slices of the kernels'
    # layouts, the rest are entries of their own
    mats = {f"{k}b{sfx}": v for part, sfx in (("_hi", ""), ("_lo", "_lo"))
            for k, v in K3._plain_mats(got, g, part).items()}
    assert set(want) == set(mats) | {"win", "wsq_seg", "F_tag"}
    for k in want:
        v = mats[k] if k in mats else got[k]
        assert tuple(v.shape) == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(_bits(v.contiguous()), _bits(want[k]),
                                      err_msg=k)
    # the kernels' layouts are zero-padded to their tiles
    n, nf = geom[0], geom[0] // 2 + 1
    for part in ("hi", "lo"):
        w1, w2 = got["k3a_" + part], got["k3b_" + part]
        assert w1.shape[0] % 128 == 0 and w1.shape[1] % 64 == 0
        assert w2.shape[0] % 128 == 0 and w2.shape[1] % 64 == 0
        assert float(w1[n:].float().abs().sum() + w1[:, 2 * nf:].float().abs()
                     .sum() + w2[2 * nf:].float().abs().sum()
                     + w2[:, n:].float().abs().sum()) == 0.0


def _round_inputs(seed, n_frames, batch=B):
    rng = np.random.default_rng(seed)
    mag = rng.random((batch, n_frames, NF), np.float32)
    Xr = rng.standard_normal((batch, n_frames, NF)).astype(np.float32)
    Xi = rng.standard_normal((batch, n_frames, NF)).astype(np.float32)
    return mag, Xr, Xi


def _padded(g, *arrays):
    pr = ((0, 0), (0, g.f2 - arrays[0].shape[1]), (0, 0))
    return [np.pad(a, pr) for a in arrays]


def _port_round(g, consts, mag, Xr, Xi, three):
    mag_p, Xr_p, Xi_p = (torch.from_numpy(a) for a in _padded(g, mag, Xr,
                                                               Xi))
    return [t.numpy() for t in K3.fused_gl_round(Xr_p, Xi_p, mag_p, consts,
                                                 g, three)]


def _gate(got, want):
    d = np.abs(np.concatenate([(got[0] - want[0]).ravel(),
                               (got[1] - want[1]).ravel()]))
    assert d.max() <= 2e-2 and d.mean() <= 1e-5, (d.max(), d.mean())


@pytest.mark.parametrize("three", [False, True])
def test_plain_round_matches_jax_kernel(three):
    g = K3.gl_geometry(N_FFT, HOP, WIN_L, F)
    mag, Xr, Xi = _round_inputs(0, F)
    before = profiling.counts()
    got = _port_round(g, K3.gl_fused_consts(N_FFT, HOP, WIN_L, F), mag, Xr,
                      Xi, three)
    assert profiling.counts() == before
    jc = jax.tree.map(jnp.asarray, jk3.gl_fused_consts(N_FFT, HOP, WIN_L, F))
    want = jk3.fused_gl_round(*(jnp.asarray(a) for a in _padded(g, Xr, Xi,
                                                                mag)),
                              jc, g, interpret=True, three_pass=three)
    want = [np.asarray(w) for w in want]
    _gate(got, want)
    assert np.abs(got[0][:, F:]).max() == 0 == np.abs(got[1][:, F:]).max()


def test_tight_fp1_round_matches_xla_bf16_round():
    """F=124: fp1*hop is shorter than the full overlap-add support
    (tests/test_pallas_gl.py:99-133); held to the XLA dft_bf16 round."""
    F_t = 124
    g = K3.gl_geometry(N_FFT, HOP, WIN_L, F_t)
    assert g.fp1 * HOP < N_FFT + HOP * (F_t - 1)
    mag, Xr, Xi = _round_inputs(7, F_t, batch=1)
    got = _port_round(g, K3.gl_fused_consts(N_FFT, HOP, WIN_L, F_t), mag, Xr,
                      Xi, False)
    mb = {k: jnp.asarray(v) for k, v in
          zip("CSAB", jstft._dft_mats(N_FFT, "bfloat16")
              + jstft._idft_mats(N_FFT, "bfloat16"))}
    X = jax.lax.complex(jnp.asarray(Xr), jnp.asarray(Xi))
    est = jstft.stft(jstft.istft(X, N_FFT, HOP, WIN_L, method="dft_bf16",
                                 mats=mb),
                     N_FFT, HOP, WIN_L, method="dft_bf16", mats=mb)
    ref = jnp.asarray(mag) * est / jnp.maximum(1e-8, jnp.abs(est))
    _gate([got[0][:, :F_t], got[1][:, :F_t]],
          [np.asarray(ref.real), np.asarray(ref.imag)])


def _round_by_tiles(Xr, Xi, mag_p, consts, g, three, span):
    """The plain round with K3a's N and K3b's K taken tile by tile, as the
    kernels take them (N tiles of ``_BN`` columns, k-tiles of ``_BK``
    summed in order): the window span's tiles only, or every tile."""
    n, hop, pad = g.n_fft, g.hop, g.n_fft // 2
    hi, lo = (K3._plain_mats(consts, g, p) for p in ("_hi", "_lo"))

    def tiles(tile):
        return (range(*K3.window_span(g, tile)) if span
                else range(-(-n // tile)))

    z = torch.zeros(Xr.shape[0], g.F, n)
    for t in tiles(K3._BN):
        c = slice(t * K3._BN, (t + 1) * K3._BN)
        z[..., c] = (K3._mm(Xr[:, : g.F], hi["A"][:, c], lo["A"][:, c], three)
                     + K3._mm(Xi[:, : g.F], hi["B"][:, c], lo["B"][:, c],
                              three))
    y = tstft._overlap_add(z * consts["win"], hop)[:, pad: pad + g.L_sig] \
        * consts["wsq_seg"].reshape(-1)[pad: pad + g.L_sig]
    yp = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    fw = yp.unfold(-1, n, hop) * consts["win"]
    er = ei = 0.0
    for t in tiles(K3._BK):
        k = slice(t * K3._BK, (t + 1) * K3._BK)
        er = er + K3._mm(fw[..., k], hi["C"][k], lo["C"][k], three)
        ei = ei + K3._mm(fw[..., k], hi["S"][k], lo["S"][k], three)
    s = mag_p[:, : g.F] / torch.clamp(torch.sqrt(er * er + ei * ei), min=1e-8)
    return er * s, ei * s


@pytest.mark.parametrize("three", [False, True])
@pytest.mark.parametrize("geom,batch", [((512, 69, 275, F), 2),
                                        ((2048, 275, 1102, 840), 1)])
def test_window_span_skips_only_zeros(geom, batch, three):
    """The span's tiles (K3a's N tiles of 128, K3b's k-tiles of 64) cover
    every nonzero window sample and each of them meets one; the round over
    those tiles only equals the round over every tile bitwise, and that is
    the plain round up to float32 sums taken in another order."""
    g = K3.gl_geometry(*geom)
    win = tstft.hann_window(g.win_length, g.n_fft)
    nz = np.flatnonzero(win)
    for tile in (K3._BN, K3._BK):
        t0, t1 = K3.window_span(g, tile)
        assert t0 * tile <= nz[0] and nz[-1] < t1 * tile
        assert t1 <= -(-g.n_fft // tile)
        assert all(win[t * tile: (t + 1) * tile].any() for t in range(t0, t1))
    rng = np.random.default_rng(5)
    mag, Xr, Xi = (torch.from_numpy(a) for a in _padded(
        g, rng.random((batch, g.F, g.n_freq), np.float32),
        *rng.standard_normal((2, batch, g.F, g.n_freq)).astype(np.float32)))
    consts = K3.gl_fused_consts(*geom)
    got = _round_by_tiles(Xr, Xi, mag, consts, g, three, span=True)
    full = _round_by_tiles(Xr, Xi, mag, consts, g, three, span=False)
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    plain = K3.fused_gl_round_plain(Xr, Xi, mag, consts, g, three)
    _gate([t.numpy() for t in got], [t[:, : g.F].numpy() for t in plain])


def test_padded_rows_do_not_leak():
    """tests/test_pallas_gl.py:70-96: the same content in the geometry of F
    and of F + one tile agrees on the frames more than P from the end."""
    g = K3.gl_geometry(N_FFT, HOP, WIN_L, F)
    g2 = K3.gl_geometry(N_FFT, HOP, WIN_L, F + g.tf2)
    mag, Xr, Xi = _round_inputs(1, F)
    a = _port_round(g, K3.gl_fused_consts(N_FFT, HOP, WIN_L, F), mag, Xr,
                    Xi, False)
    b = _port_round(g2, K3.gl_fused_consts(N_FFT, HOP, WIN_L, F + g.tf2),
                    mag, Xr, Xi, False)
    interior = F - 2 * g.P
    for u, v in zip(a, b):
        np.testing.assert_allclose(u[:, :interior], v[:, :interior],
                                   atol=1e-5)


def test_consts_for_another_f_are_rebuilt():
    """tests/test_pallas_gl.py:136-165: F=152 and 160 share one fp1 bucket
    with different NOLA tails; consts of the wrong F are not used."""
    F_a, F_b = 152, 160
    assert K3.gl_geometry(N_FFT, HOP, WIN_L, F_a).fp1 \
        == K3.gl_geometry(N_FFT, HOP, WIN_L, F_b).fp1
    mag = torch.from_numpy(np.random.default_rng(3).random(
        (1, F_a, NF), np.float32)) + 0.1
    base = tstft.dft_consts(N_FFT, "dft_pallas")
    right = dict(base, fused=K3.gl_fused_consts(N_FFT, HOP, WIN_L, F_a))
    wrong = dict(base, fused=K3.gl_fused_consts(N_FFT, HOP, WIN_L, F_b))
    kw = dict(n_iter=4, method="dft_pallas")
    w_right = tgl.griffin_lim(mag, N_FFT, HOP, WIN_L, mats=right, **kw)
    w_wrong = tgl.griffin_lim(mag, N_FFT, HOP, WIN_L, mats=wrong, **kw)
    assert torch.equal(w_wrong, w_right)
    assert torch.equal(w_right, tgl.griffin_lim(mag, N_FFT, HOP, WIN_L, **kw))


@pytest.mark.parametrize("n_iter,want", [(1, (1, 0, 0)), (2, (1, 0, 1)),
                                         (3, (1, 0, 2)), (4, (1, 1, 2)),
                                         (10, (1, 7, 2)), (50, (5, 40, 5))])
def test_schedule(n_iter, want):
    """dc_tts_tpu/dsp/griffin_lim.py:109-111: head = min(n, max(1, n//10)),
    tail = min(n - head, max(2, n//10))."""
    head = min(n_iter, max(1, n_iter // 10))
    tail = min(n_iter - head, max(2, n_iter // 10))
    assert (head, n_iter - head - tail, tail) == want
    assert tgl.gl_schedule(n_iter) == want


@pytest.mark.parametrize("method", ["fft", "dft", "ct"])
def test_griffin_lim_one_round_matches_jax(method):
    mag = np.random.default_rng(4).random((2, 40, 129)).astype(np.float32) \
        + 0.1
    want = jgl.griffin_lim(jnp.asarray(mag), 256, 64, 256, 1, method=method)
    got = tgl.griffin_lim(torch.from_numpy(mag), 256, 64, 256, 1,
                          method=method)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_gl_consts_cached_per_device():
    cfg = test_config().replace(stft_method="dft_pallas")
    a = tgl.gl_consts(cfg, 20, "cpu")
    assert a is tgl.gl_consts(cfg, 20, torch.device("cpu"))
    assert a["fused"]["F_tag"].shape[0] == 20
    # K3's own constants and the final iSTFT's float32 A and B, nothing else
    assert set(a) == {"A", "B", "fused"}
    want = tstft.dft_consts(cfg.n_fft, "dft_pallas")
    assert torch.equal(a["A"], want["A"]) and torch.equal(a["B"], want["B"])
    assert tgl.gl_consts(cfg.replace(stft_method="fft"), 20, "cpu") == {}


@pytest.mark.parametrize("method", tgl.METHODS)
def test_every_method_runs_on_cpu(method):
    cfg = test_config().replace(stft_method=method)
    z = torch.from_numpy(np.random.default_rng(5).random(
        (2, 20, cfg.n_freq)).astype(np.float32))
    wav = tgl.spectrogram_to_wav(z, cfg)
    assert wav.shape == (2, cfg.hop_length * 19) and wav.dtype == \
        torch.float32 and bool(torch.isfinite(wav).all())


# ------------------------------------------------ full schedules
#
# Two two-tone probes, 50 rounds. "bistable" is tests/test_dsp.py's
# (440 + 1210 Hz, 256/64/256): its Griffin-Lim has two basins, ~0.066 and
# ~0.159. Which one a schedule reaches depends on whether its "3-pass"
# rounds are float32: JAX's dft_3x is float32 on the CPU (Precision.HIGH
# is a no-op there) and reaches 0.066, while the 3-pass split that HIGH is
# on the TPU reaches the other basin, in the port (dft_3x 0.153) as in
# JAX's own K3 (dft_pallas in interpret mode, 0.127). So on that probe a
# schedule is held to the port's own all-3-pass run, as the JAX tests hold
# dft_mixed to dft_3x and dft_pallas to dft_mixed; float32 methods to JAX's.
# JAX's interpret-mode dft_pallas is given up as the reference there (the
# port's reads 0.153 against its 0.127): from the zero-phase start, the
# first 3-pass round on this probe has bins whose spectrum all but
# vanishes while their magnitude does not, and their phase comes from
# rounding, so the port's and JAX's runs part from the first round on, each
# as far from the round summed in float64. The round itself is held to
# JAX's kernel on random spectra (test_plain_round_matches_jax_kernel) and
# the schedule on the "tones" probe.
# "tones" is tests/test_pallas_gl.py's (440 + 660 Hz, 512/69/275, F=160),
# where every method reaches one basin: the schedules are held to JAX's.


def _probe(name):
    if name == "bistable":
        sr, geo = 8000, (256, 64, 256)
        t = np.arange(sr) / sr
        y = 0.4 * np.sin(2 * np.pi * 440 * t) \
            + 0.2 * np.sin(2 * np.pi * 1210 * t)
    else:
        geo = (N_FFT, HOP, WIN_L)
        t = np.arange(HOP * (F - 1) + N_FFT) / 22050.0
        y = 0.6 * np.sin(2 * np.pi * 440 * t) \
            + 0.4 * np.sin(2 * np.pi * 660 * t)
    mag = np.asarray(jnp.abs(jstft.stft(jnp.asarray(y.astype(np.float32)),
                                        *geo)))
    return mag, geo


def _sc(wav, mag, geo):
    m = np.abs(jstft.stft(jnp.asarray(np.asarray(wav)), *geo))
    return float(np.linalg.norm(m - mag) / np.linalg.norm(mag))


def _port_sc(name, method):
    mag, geo = _probe(name)
    wav = tgl.griffin_lim(torch.tensor(mag), *geo, n_iter=50, method=method)
    assert bool(torch.isfinite(wav).all())
    return _sc(wav.numpy(), mag, geo)


@pytest.fixture(scope="module")
def refs():
    out = {}
    for name in ("bistable", "tones"):
        mag, geo = _probe(name)
        for m in ("dft", "dft_3x", "dft_mixed"):
            out[name, "jax", m] = _sc(jgl.griffin_lim(
                jnp.asarray(mag), *geo, n_iter=50, method=m), mag, geo)
    for m in ("dft_3x", "dft_mixed"):
        out["bistable", "port", m] = _port_sc("bistable", m)
    return out


@pytest.mark.parametrize("probe,method", [
    ("bistable", "dft_mixed"), ("bistable", "dft_bf16"),
    ("bistable", "dft_pallas"), ("bistable", "ct"),
    ("tones", "dft_mixed"), ("tones", "dft_pallas")])
def test_full_schedule_quality(probe, method, refs):
    s = _port_sc(probe, method)
    ref = "port" if probe == "bistable" else "jax"
    if method == "dft_mixed":     # tests/test_dsp.py:261-282
        assert s <= 1.05 * refs[probe, ref, "dft_3x"] + 0.01, (s, refs)
    elif method == "dft_pallas":  # tests/test_pallas_gl.py:168-196
        assert s <= 1.10 * refs[probe, ref, "dft_mixed"] + 0.01, (s, refs)
    elif method == "dft_bf16":    # tests/test_dsp.py:238-258
        assert s < 0.25 and s <= 3.0 * refs[probe, "jax", "dft"] + 0.02, \
            (s, refs)
    else:                         # tests/test_dsp.py:337-345
        assert s < 0.15, s
