"""The port's DFT-matmul STFT forms and FLOP counters against the JAX
package on the CPU:

* every ``dft_consts`` entry bit-equal (bf16 matrices as uint16 views, at
  the test and the production n_fft: JAX rounds float64 to bf16 once);
* stft/istft for ``dft``, ``dft_3x``, ``dft_bf16`` and ``ct`` within the
  JAX tests' own bars (tests/test_dsp.py:180-235, :310-334), and each
  against JAX's same method;
* ``griffin_lim_flops`` and ``conv_stack_flops`` equal to JAX's.
"""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import base_config
from dc_tts_tpu_torch.dsp import stft as tstft
from dc_tts_tpu_torch.models.ssrn import ssrn_specs
from dc_tts_tpu_torch.models.text2mel import (audio_dec_specs,
                                              audio_enc_specs, text_enc_specs)
from dc_tts_tpu_torch.utils import profiling as tprof

jstft = import_module("dc_tts_tpu.dsp.stft")
jprof = import_module("dc_tts_tpu.utils.profiling")
jt2m = import_module("dc_tts_tpu.models.text2mel")
jssrn = import_module("dc_tts_tpu.models.ssrn")
jconfig = import_module("dc_tts_tpu.config")

torch.set_num_threads(1)


def bits(a):
    """A bf16 array (ml_dtypes or torch) as uint16, float32 as itself."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) \
            if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("n_fft", [512, 2048])
@pytest.mark.parametrize("method", ["fft", "dft", "dft_3x", "dft_bf16", "ct",
                                    "dft_mixed", "dft_pallas",
                                    "dft_pallas2"])
def test_dft_consts_match_jax_bitwise(method, n_fft):
    want = jstft.dft_consts(n_fft, method)
    got = tstft.dft_consts(n_fft, method)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


def _y(seed, n=4096):
    return np.random.default_rng(seed).standard_normal((2, n)).astype(
        np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("method", ["dft", "dft_3x", "dft_bf16"])
def test_dft_stft_istft_match_jax(method):
    """The JAX tests' bars against ``fft`` / ``dft``, and the port against
    JAX's same method (bf16 operands are rounded alike in both)."""
    y = _y(10)
    S_fft = np.asarray(jstft.stft(jnp.asarray(y), 512, 128, 400))
    S_dft = np.asarray(jstft.stft(jnp.asarray(y), 512, 128, 400,
                                  method="dft"))
    got = tstft.stft(_t(y), 512, 128, 400, method=method).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(y), 512, 128, 400,
                                 method=method))
    yr32 = np.asarray(jstft.istft(jnp.asarray(S_dft), 512, 128, 400,
                                  method="dft"))
    yr = tstft.istft(_t(S_dft), 512, 128, 400, method=method).numpy()
    yr_j = np.asarray(jstft.istft(jnp.asarray(S_dft), 512, 128, 400,
                                  method=method))
    if method == "dft":        # test_dsp.py:180-194
        np.testing.assert_allclose(got, S_fft, atol=2e-3)
        y_fft = np.asarray(jstft.istft(jnp.asarray(S_dft), 512, 128, 400))
        np.testing.assert_allclose(yr, y_fft, atol=2e-3)
    elif method == "dft_3x":   # test_dsp.py:224-235
        # JAX meets 1e-4 on the CPU, where Precision.HIGH is float32. The
        # explicit 3-pass split (what HIGH is on the TPU) carries 16
        # significant bits per operand: its stft here is 1.7e-4 from the
        # float64 one (4e-6 of max |S| = 43), float32's 1e-5. The istft
        # meets 1e-4 (9e-6).
        np.testing.assert_allclose(got, S_dft, atol=2e-4)
        np.testing.assert_allclose(yr, yr32, atol=1e-4)
    else:                      # test_dsp.py:209-221
        assert np.linalg.norm(got - S_dft) / np.linalg.norm(S_dft) < 5e-3
        assert np.linalg.norm(yr - yr32) / np.linalg.norm(yr32) < 5e-3
    # against JAX's same method: float32 sums in another order (JAX's
    # dft_3x is float32 on the CPU, the port's the 3-pass split)
    tol = 1e-4 if method == "dft_3x" else 2e-5
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())
    np.testing.assert_allclose(yr, yr_j, atol=tol * np.abs(yr_j).max())


@pytest.mark.parametrize("n_fft,hop,win", [(256, 64, 200), (512, 128, 400),
                                           (2048, 276, 1102)])
def test_ct_matches_fft_and_jax(n_fft, hop, win):
    """test_dsp.py:310-329: the factored transform is an FFT to 2e-5 x the
    largest value, both ways."""
    n_samp = 8 * n_fft if n_fft < 2048 else 4 * 2048
    y = np.random.default_rng(15).standard_normal((2, n_samp)).astype(
        np.float32)
    S_f = np.asarray(jstft.stft(jnp.asarray(y), n_fft, hop, win))
    S_c = tstft.stft(_t(y), n_fft, hop, win, method="ct").numpy()
    scale = np.abs(S_f).max()
    np.testing.assert_allclose(S_c, S_f, atol=2e-5 * scale)
    S_cj = np.asarray(jstft.stft(jnp.asarray(y), n_fft, hop, win,
                                 method="ct"))
    np.testing.assert_allclose(S_c, S_cj, atol=2e-5 * scale)
    y_f = np.asarray(jstft.istft(jnp.asarray(S_f), n_fft, hop, win))
    y_c = tstft.istft(_t(S_f), n_fft, hop, win, method="ct").numpy()
    np.testing.assert_allclose(y_c, y_f, atol=2e-5 * np.abs(y_f).max())


def test_ct_and_unknown_methods_raise():
    with pytest.raises(ValueError):             # test_dsp.py:332-334
        tstft.stft(torch.zeros(1000), 200, 50, 200, method="ct")
    with pytest.raises(ValueError):
        tstft.stft(torch.zeros(1000), 256, 64, 256, method="dft_fast")


@pytest.mark.parametrize("method", ["dft", "dft_bf16", "ct", "fft",
                                    "dft_pallas2"])
@pytest.mark.parametrize("B,F,n_fft,n_iter", [(20, 896, 2048, 0),
                                              (3, 124, 512, 50)])
def test_griffin_lim_flops_match_jax(method, B, F, n_fft, n_iter):
    assert tprof.griffin_lim_flops(B, F, n_fft, n_iter, method) \
        == jprof.griffin_lim_flops(B, F, n_fft, n_iter, method)


def test_conv_stack_flops_match_jax():
    cfg, jcfg = base_config(), jconfig.base_config()
    pairs = [(text_enc_specs(cfg), jt2m.text_enc_specs(jcfg), cfg.max_N,
              cfg.e),
             (audio_enc_specs(cfg), jt2m.audio_enc_specs(jcfg), cfg.max_T,
              cfg.n_mels),
             (audio_dec_specs(cfg), jt2m.audio_dec_specs(jcfg), cfg.max_T,
              2 * cfg.d),
             (ssrn_specs(cfg), jssrn.ssrn_specs(jcfg), cfg.max_T,
              cfg.n_mels)]
    for ts, js, T, cin in pairs:
        got = tprof.conv_stack_flops(32, T, ts, cin)
        assert got == jprof.conv_stack_flops(32, T, js, cin) and got > 0
    f = tprof.griffin_lim_flops(20, 896, 2048, 0)
    assert tprof.mfu(f, f / tprof.H100_BF16_PEAK_FLOPS) == pytest.approx(1.0)
