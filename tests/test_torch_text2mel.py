"""Text2Mel and SSRN of the port against the JAX package on the CPU, on the
same parameters (JAX ``init(PRNGKey(0))`` for Text2Mel, ``PRNGKey(1)`` for
SSRN, carried across with ``from_jax_params``):

* TextEnc and SSRN apply at atol 1e-5 (float32 on both sides);
* the frozen goldens of tests/goldens/tiny_outputs.npz at atol 1e-4, the
  JAX golden test's tolerance;
* decode: the port's incremental mode and the decode kernel's plain
  version against JAX's incremental mode and its fused Pallas kernel (in
  interpret mode on the CPU): Y and A at atol 2e-5 (the JAX fused-decode
  test's tolerance) and an identical cursor trajectory;
* pack_decode_params equal to JAX's, exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.models.ssrn import SSRN as JSSRN
from dc_tts_tpu.models.text2mel import Text2Mel as JText2Mel
from dc_tts_tpu.ops.pallas_decode import pack_decode_params as jax_pack

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.models import SSRN, Text2Mel
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.params import from_jax_params
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = test_config()
GOLD = os.path.join(os.path.dirname(__file__), "goldens", "tiny_outputs.npz")


@pytest.fixture(scope="module")
def t2m():
    params = JText2Mel(jax_test_config()).init(jax.random.PRNGKey(0))
    ids = np.zeros((3, CFG.max_N), np.int32)
    for i in range(3):
        ids[i, : 6 + 3 * i] = (np.arange(6 + 3 * i) % 28) + 3
    return params, from_jax_params(params), ids


@pytest.fixture(scope="module")
def jax_decodes(t2m):
    jp, _, ids = t2m
    m = JText2Mel(jax_test_config())
    return {mode: tuple(np.asarray(o) for o in
                        m.decode(jp, jnp.asarray(ids), mode=mode))
            for mode in ("incremental", "fused")}


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLD) as d:
        return {k: d[k] for k in d.files}


def test_text_encode_matches_jax(t2m):
    jp, tp, ids = t2m
    jk, jv = JText2Mel(jax_test_config()).text_encode(jp, jnp.asarray(ids))
    tk, tv = Text2Mel(CFG).text_encode(tp, torch.as_tensor(ids))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_ssrn_matches_jax_and_golden(gold):
    jp = JSSRN(jax_test_config()).init(jax.random.PRNGKey(1))
    _, jz = JSSRN(jax_test_config()).apply(jp, jnp.asarray(gold["Y"]))
    logits, z = SSRN(CFG).apply(from_jax_params(jp),
                                torch.as_tensor(gold["Y"]))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5, rtol=0)
    np.testing.assert_allclose(torch.sigmoid(logits).numpy(), z.numpy())
    np.testing.assert_allclose(z.numpy(), gold["Z"], atol=1e-4)


def test_decode_matches_golden(gold):
    tp = from_jax_params(JText2Mel(jax_test_config()).init(
        jax.random.PRNGKey(0)))
    for mode in ("incremental", "fused"):
        Yd, Ad = Text2Mel(CFG).decode(tp, torch.as_tensor(gold["ids"]), 8,
                                      mode=mode)
        np.testing.assert_allclose(Yd.numpy(), gold["Yd"], atol=1e-4)
        np.testing.assert_allclose(Ad.numpy(), gold["Ad"], atol=1e-4)


@pytest.mark.parametrize("port_mode", ["incremental", "fused"])
@pytest.mark.parametrize("jax_mode", ["incremental", "fused"])
def test_decode_matches_jax(t2m, jax_decodes, port_mode, jax_mode):
    """port "fused" on CPU tensors is the decode kernel's plain version."""
    _, tp, ids = t2m
    Y, A = Text2Mel(CFG).decode(tp, torch.as_tensor(ids), mode=port_mode)
    jY, jA = jax_decodes[jax_mode]
    assert Y.shape == jY.shape and A.shape == jA.shape
    np.testing.assert_array_equal(A.numpy().argmax(axis=1),
                                  jA.argmax(axis=1))
    np.testing.assert_allclose(Y.numpy(), jY, atol=2e-5, rtol=0)
    np.testing.assert_allclose(A.numpy(), jA, atol=2e-5, rtol=0)


def test_pack_decode_params_matches_jax(t2m):
    jp, tp, _ = t2m
    want = jax_pack(jax_test_config(), jp)
    got = K1.pack_decode_params(CFG, tp)
    # the JAX layout, and the CUDA kernel's transposed copies of the kernels
    want = {k: np.asarray(v) for k, v in want.items()}
    want.update({k + "_t": np.swapaxes(want[k], -1, -2)
                 for k in ("cw", "hcw")})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_decode_wrapper_takes_plain_version_on_cpu(t2m):
    """A CPU tensor goes to the plain version, which counts no launch."""
    _, tp, ids = t2m
    Kt, V = Text2Mel(CFG).text_encode(tp, torch.as_tensor(ids))
    packed = K1.pack_decode_params(CFG, tp)
    before = profiling.counts()
    Y, A = K1.fused_decode(packed, Kt, V, 5, CFG)
    Yp, Ap = K1.fused_decode_plain(packed, Kt, V, 5, CFG)
    assert profiling.counts() == before
    assert torch.equal(Y, Yp) and torch.equal(A, Ap)
    assert K1.ring_rows(CFG) == sum(2 * r + 1 for r in
                                    (1, 3, 9, 27, 1, 3, 9, 27, 3, 3,
                                     1, 3, 9, 27, 1, 1))


def test_unported_modes_raise(t2m):
    """Every decode mode and precision of the JAX package is ported
    (tests/test_torch_decode_modes.py): an unknown one still raises."""
    _, tp, ids = t2m
    with pytest.raises(ValueError, match="decode mode"):
        Text2Mel(CFG).decode(tp, torch.as_tensor(ids), mode="pipelined")
    for mode in ("fused", "incremental", "reference"):
        with pytest.raises(ValueError, match="precision"):
            Text2Mel(CFG).decode(tp, torch.as_tensor(ids), mode=mode,
                                 prec="high")
