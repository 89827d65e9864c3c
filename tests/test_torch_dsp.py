"""The port's DSP and Griffin-Lim against the JAX package on the CPU:

* stft / istft / pre- and de-emphasis / denormalize at atol 1e-5;
* gl2_geometry, gl2_consts (the float32 entries both packages have) and
  scramble_mag equal to JAX's;
* the Griffin-Lim kernel's plain version at n_iter=1 against JAX's whole-
  loop Pallas kernel in interpret mode at atol 1e-5 (its single round is
  float32; the JAX test holds it to the XLA round at 3e-6, and the port's
  torch.fft transforms sum in another order than the factored DFT);
* the full schedule's spectral convergence on the two-tone probe
  <= 1.10 x JAX dft_mixed's + 0.01, the gate of tests/test_pallas_gl2.py.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.dsp import features as tfeat
from dc_tts_tpu_torch.dsp import griffin_lim as tgl
from dc_tts_tpu_torch.dsp import stft as tstft
from dc_tts_tpu_torch.ops import gl2 as K2
from dc_tts_tpu_torch.utils import profiling

# dc_tts_tpu.dsp re-exports functions under its modules' names
jfeat = import_module("dc_tts_tpu.dsp.features")
jgl = import_module("dc_tts_tpu.dsp.griffin_lim")
jstft = import_module("dc_tts_tpu.dsp.stft")
jgl2 = import_module("dc_tts_tpu.ops.pallas_gl2")

torch.set_num_threads(1)

# the JAX gl2 test's geometry: P = ceil(512/69) = 8 as at 2048/275
N_FFT, HOP, WIN_L, F = 512, 69, 275, 160


def _signal(n, seed=0):
    return np.random.default_rng(seed).standard_normal((2, n)).astype(
        np.float32) * 0.3


def test_stft_istft_match_jax():
    y = _signal(HOP * 40 + 17)
    want = jstft.stft(jnp.asarray(y), N_FFT, HOP, WIN_L)
    got = tstft.stft(torch.as_tensor(y), N_FFT, HOP, WIN_L)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert got.shape[-2] == tstft.num_frames(y.shape[-1], N_FFT, HOP) \
        == jstft.num_frames(y.shape[-1], N_FFT, HOP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    want_i = jstft.istft(want, N_FFT, HOP, WIN_L)
    got_i = tstft.istft(got, N_FFT, HOP, WIN_L)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(tstft.hann_window(WIN_L, N_FFT),
                                  jstft.hann_window(WIN_L, N_FFT))


def test_frame_indices_match_jax():
    from dc_tts_tpu_torch import dsp
    for n_frames, n_fft, hop in ((5, 16, 4), (41, N_FFT, HOP)):
        got = dsp.frame_indices(n_frames, n_fft, hop)
        want = jstft.frame_indices(n_frames, n_fft, hop)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # the package exports the JAX package's dsp functions, but for stft and
    # griffin_lim: there those names stay the modules'
    import dc_tts_tpu.dsp as jdsp
    for name in ("mel_filterbank", "istft", "hann_window", "frame_indices",
                 "spectrogram_to_wav", "wav_to_spectrograms", "reduce_mel",
                 "preemphasis", "deemphasis"):
        assert callable(getattr(jdsp, name)), name
        assert callable(getattr(dsp, name)), name
    assert dsp.stft is tstft and dsp.griffin_lim is tgl


@pytest.mark.parametrize("n", [1, 511, 512, 5000])
def test_emphasis_filters_match_jax(n):
    x = _signal(n, seed=n)
    np.testing.assert_allclose(
        tfeat.deemphasis(torch.as_tensor(x), 0.97).numpy(),
        np.asarray(jfeat.deemphasis(jnp.asarray(x), 0.97)), atol=1e-5,
        rtol=0)
    np.testing.assert_allclose(
        tfeat.preemphasis(torch.as_tensor(x), 0.97).numpy(),
        np.asarray(jfeat.preemphasis(jnp.asarray(x), 0.97)), atol=1e-6,
        rtol=0)


def test_denormalize_and_trim_match_jax():
    cfg = test_config()
    z = np.random.default_rng(1).random((2, 8, cfg.n_freq)).astype(
        np.float32) * 1.2 - 0.1
    np.testing.assert_allclose(
        tgl.denormalize_mag(torch.as_tensor(z), cfg).numpy(),
        np.asarray(jgl.denormalize_mag(jnp.asarray(z), cfg)), rtol=1e-5)
    y = np.concatenate([np.zeros(3000), _signal(4000)[0], np.zeros(3000)])
    np.testing.assert_array_equal(tfeat.trim_silence(y),
                                  jfeat.trim_silence(y))


@pytest.mark.parametrize("geom", [(N_FFT, HOP, WIN_L, F),
                                  (N_FFT, HOP, WIN_L, F - 3),
                                  (2048, 275, 1102, 840),
                                  (512, 16, 275, 64),
                                  (1056, 142, 568, 61)])
def test_gl2_geometry_consts_scramble_match_jax(geom):
    g = K2.gl2_geometry(*geom)
    assert tuple(g) == tuple(jgl2.gl2_geometry(*geom))
    got, want = K2.gl2_consts(*geom), jgl2.gl2_consts(*geom)
    for k in ("win", "wsq"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    # the port's own entry: the CUDA kernel's twiddle tables, float64
    # exp(-2 pi i ...) (tests/test_torch_gl2_plan.py holds them)
    tw = K2.fft_twiddles(geom[0])
    assert got["fft_tw"].dtype == np.float64
    np.testing.assert_array_equal(
        got["fft_tw"][:, 0] + 1j * got["fft_tw"][:, 1], tw)
    np.testing.assert_allclose(np.abs(tw), 1.0, atol=1e-15)
    n_f = geom[3]
    mag = np.random.default_rng(2).random(
        (1, n_f, geom[0] // 2 + 1)).astype(np.float32)
    scr = K2.scramble_mag(torch.as_tensor(mag), g)
    np.testing.assert_array_equal(scr.numpy(), np.asarray(
        jgl2.scramble_mag(jnp.asarray(mag), g)))
    np.testing.assert_array_equal(K2.unscramble_mag(scr, g).numpy(), mag)


def test_gl2_plain_single_round_matches_jax_kernel():
    g = K2.gl2_geometry(N_FFT, HOP, WIN_L, F)
    mag = np.random.default_rng(0).random(
        (2, F, N_FFT // 2 + 1)).astype(np.float32) + 0.05
    jc = jax.tree.map(jnp.asarray, jgl2.gl2_consts(N_FFT, HOP, WIN_L, F))
    want = jgl2.gl2_run(jgl2.scramble_mag(jnp.asarray(mag), g), jc, g,
                        n_iter=1, interpret=True)
    tc = K2.gl2_consts(N_FFT, HOP, WIN_L, F)
    got = K2.gl2_run(K2.scramble_mag(torch.as_tensor(mag), g), tc, g, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_gl2_full_schedule_quality_vs_dft_mixed():
    n_iter = 12
    g = K2.gl2_geometry(N_FFT, HOP, WIN_L, F)
    t = np.arange(HOP * (F - 1) + N_FFT) / 22050.0
    y = (0.6 * np.sin(2 * np.pi * 440 * t)
         + 0.4 * np.sin(2 * np.pi * 660 * t)).astype(np.float32)
    mag = jnp.abs(jstft.stft(jnp.asarray(y), N_FFT, HOP, WIN_L))[None][:, :F]

    def sc(wav):
        m_ = jnp.abs(jstft.stft(jnp.asarray(wav), N_FFT, HOP,
                                WIN_L))[:, : mag.shape[1]]
        ref = mag[:, : m_.shape[1]]
        return float(jnp.linalg.norm(m_ - ref) / jnp.linalg.norm(ref))

    w_mixed = jgl.griffin_lim(
        mag, N_FFT, HOP, WIN_L, n_iter=n_iter, method="dft_mixed",
        mats=jax.tree.map(jnp.asarray, jstft.dft_consts(N_FFT, "dft_mixed")))
    w = K2.gl2_run(K2.scramble_mag(torch.tensor(np.asarray(mag)), g),
                   K2.gl2_consts(N_FFT, HOP, WIN_L, F), g, n_iter)
    assert w.shape[-1] == w_mixed.shape[-1]
    s, sm = sc(w.numpy()), sc(w_mixed)
    assert np.isfinite(s)
    assert s < sm * 1.10 + 0.01, (s, sm)


def test_griffin_lim_dispatch_on_cpu():
    """method "dft_pallas2" on CPU tensors is the plain torch.fft loop:
    equal to method "fft", with no kernel launch counted; "dft_pallas" on
    CPU tensors counts no K3 launch; an unknown method raises."""
    mag = torch.as_tensor(np.random.default_rng(3).random(
        (1, 2, 40, 129)).astype(np.float32)) + 0.1
    before = profiling.counts()
    a = tgl.griffin_lim(mag, 256, 8, 32, 3, method="dft_pallas2")
    b = tgl.griffin_lim(mag, 256, 8, 32, 3, method="fft")
    assert profiling.counts() == before
    assert a.shape == (1, 2, 8 * 39)
    assert torch.equal(a, b)
    c = tgl.griffin_lim(mag, 256, 8, 32, 3, method="dft_pallas")
    assert profiling.counts() == before
    assert c.shape == a.shape and bool(torch.isfinite(c).all())
    with pytest.raises(ValueError):
        tgl.griffin_lim(mag, 256, 8, 32, 3, method="dft_fast")
