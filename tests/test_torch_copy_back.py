"""The copy back of ``Synthesizer.synthesize_ids_chunked`` and de-emphasis's
tables on the CPU: the chunked result bit for bit the concatenation of
``synthesize_ids`` over its chunks (one chunk, several, a shorter tail;
pcm16 on and off), an output that no later call writes, and de-emphasis
from its cached tables bit for bit the formula with tables made on every
call, each new table key counted once as ``deemphasis.table_uploads``.
The card's staging pair and its overlap are checked in
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dc_tts_tpu_torch.bench import seeded_nets
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.dsp import features
from dc_tts_tpu_torch.pipeline import Synthesizer
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = test_config()


@pytest.fixture(scope="module")
def synths():
    nets = seeded_nets(CFG)
    return {pcm16: Synthesizer(CFG, *nets, device="cpu", pcm16=pcm16)
            for pcm16 in (False, True)}


def _ids(B, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, CFG.max_N), np.int64)
    for i in range(B):
        n = int(rng.integers(4, CFG.max_N))
        ids[i, :n] = rng.integers(2, CFG.vocab_size, n)
    return ids


@pytest.mark.parametrize("pcm16", [False, True])
@pytest.mark.parametrize("B,chunk", [(2, 4), (4, 2), (5, 2)],
                         ids=["one_chunk", "several", "tail"])
def test_chunked_equals_synthesize_ids_over_its_chunks(synths, B, chunk,
                                                       pcm16):
    synth = synths[pcm16]
    ids = _ids(B, seed=B)
    got = synth.synthesize_ids_chunked(ids, chunk)
    want = np.concatenate([synth.synthesize_ids(ids[i: i + chunk])[0]
                           .numpy() for i in range(0, B, chunk)])
    assert got.dtype == (np.int16 if pcm16 else np.float32)
    assert got.shape == want.shape and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_chunked_output_is_the_callers_own(synths):
    synth = synths[True]
    first = synth.synthesize_ids_chunked(_ids(3, seed=1), 2)
    kept = first.copy()
    second = synth.synthesize_ids_chunked(_ids(3, seed=2), 2)
    assert not np.shares_memory(first, second)
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(first, kept)


def _deemphasis_uncached(x, coef, block=512):
    """``features.deemphasis`` with its tables made from numpy on every
    call."""
    if x.dtype != torch.float64:
        x = x.float()
    n = x.shape[-1]
    L = min(block, max(1, n))
    nb = -(-n // L)
    xb = F.pad(x, (0, nb * L - n)).reshape(*x.shape[:-1], nb, L)
    kw = {"device": x.device, "dtype": x.dtype}
    local = xb @ torch.as_tensor(features._iir_toeplitz(coef, L), **kw)
    carry = local[..., -1] @ torch.as_tensor(
        features._iir_toeplitz(coef ** L, nb), **kw)
    prev = F.pad(carry[..., :-1], (1, 0))
    decay = torch.as_tensor((coef ** np.arange(1, L + 1)).astype(np.float32),
                            **kw)
    return (local + prev[..., None] * decay).reshape(
        *x.shape[:-1], nb * L)[..., :n]


@pytest.mark.parametrize("n", [1, 300, 1024, 2207])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_deemphasis_cached_tables_bitwise_and_counted(n, dtype):
    features._deemphasis_tables.cache_clear()
    x = torch.randn(3, n, generator=torch.Generator().manual_seed(n),
                    dtype=dtype)
    c0 = profiling.counts()
    y = features.deemphasis(x, 0.97)
    assert (profiling.counts() - c0)["deemphasis.table_uploads"] == 1
    assert y.dtype == dtype
    assert torch.equal(y, _deemphasis_uncached(x, 0.97))
    c1 = profiling.counts()
    again = features.deemphasis(x[:2], 0.97)
    assert (profiling.counts() - c1)["deemphasis.table_uploads"] == 0
    assert torch.equal(again, y[:2])
