"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where no CUDA device is present. Run them
on a machine with an H100:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: the decode kernel at the JAX fused-decode test's 2e-5 with an
identical cursor trajectory. The Griffin-Lim kernel at 1e-5 from its plain
version run in float64: the phase normalisation of near-zero bins amplifies
rounding, so the float32 plain version is itself up to ~3e-5 from the
float64 one at n_fft 2048, more than the kernel is.
"""
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.device import fp32_numerics
from dc_tts_tpu_torch.dsp.griffin_lim import spectrogram_to_wav
from dc_tts_tpu_torch.models import SSRN, Text2Mel
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.ops import gl2 as K2
from dc_tts_tpu_torch.pipeline import Synthesizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fp32_numerics()
    return torch.device("cuda")


def _ids(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, cfg.max_N), np.int64)
    for i in range(B):
        n = int(rng.integers(5, cfg.max_N))
        ids[i, :n] = rng.integers(2, cfg.vocab_size, n)
    return torch.as_tensor(ids)


@pytest.mark.parametrize("B", [1, 5])
def test_decode_kernel_matches_plain(cuda, B):
    cfg = test_config()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(B), cuda)
    Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, B).to(cuda))
    packed = K1.pack_decode_params(cfg, p)
    n = K1.fused_decode.launches
    Y, A = K1.fused_decode(packed, Kt.contiguous(), V.contiguous(),
                           cfg.max_T, cfg)
    torch.cuda.synchronize()
    assert K1.fused_decode.launches == n + 1
    Yp, Ap = K1.fused_decode_plain(packed, Kt, V, cfg.max_T, cfg)
    assert torch.equal(A.argmax(1), Ap.argmax(1))
    torch.testing.assert_close(Y, Yp, atol=2e-5, rtol=0)
    torch.testing.assert_close(A, Ap, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n_iter", [0, 1, 3])
def test_gl2_kernel_matches_plain(cuda, n_iter):
    n_fft, hop, win, F = 512, 69, 275, 160
    g = K2.gl2_geometry(n_fft, hop, win, F)
    mag = torch.rand(3, F, n_fft // 2 + 1,
                     generator=torch.Generator().manual_seed(n_iter)) + 0.05
    scr = K2.scramble_mag(mag.to(cuda), g)
    consts = {k: torch.as_tensor(v, device=cuda)
              for k, v in K2.gl2_consts(n_fft, hop, win, F).items()}
    y = K2.gl2_run(scr, consts, g, n_iter)
    yp = K2.gl2_run_plain(scr.double(), consts, g, n_iter)
    torch.cuda.synchronize()
    assert y.shape == yp.shape == (3, g.L_sig)
    torch.testing.assert_close(y.double(), yp, atol=1e-5, rtol=0)


def test_synthesizer_on_cuda_matches_cpu(cuda):
    """Y and Z against the CPU run; the waveform against the float64 plain
    vocoder on the card's own Z (see the module docstring)."""
    cfg = test_config()
    gen = torch.Generator().manual_seed(0)
    p1, p2 = Text2Mel(cfg).init(gen), SSRN(cfg).init(gen)
    ids = _ids(cfg, 3).numpy()
    wav, Y, Z, A = (o.cpu() for o in
                    Synthesizer(cfg, p1, p2).synthesize_ids(ids))
    cpu = Synthesizer(cfg, p1, p2, device="cpu").synthesize_ids(ids)
    assert torch.equal(A.argmax(1), cpu[3].argmax(1))
    torch.testing.assert_close(Y, cpu[1], atol=2e-5, rtol=0)
    torch.testing.assert_close(Z, cpu[2], atol=1e-4, rtol=0)
    ref = spectrogram_to_wav(Z.double(), cfg.replace(stft_method="fft"))
    torch.testing.assert_close(wav.double(), ref, atol=1e-4, rtol=0)
