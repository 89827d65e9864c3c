"""The port against the original TF graph's outputs, with no JAX at run
time: ``tests/goldens/tf_reference_tiny.npz`` (the TF variables, forward
outputs and the synthesize.py loop's outputs at ``test_config()``) through
the port's own ``convert``, at ``ln_eps=1e-12`` (TF's layer-norm epsilon)
and tests/test_tf_goldens.py's tolerances:

* the port's ``convert`` bit for bit equal to the JAX package's, carried
  across with ``from_jax_params`` (the one test here that imports JAX), and
  ``export_tf_names`` giving back every ``var/`` entry;
* the synthesize-mode forward: K, V, Q (1e-5), the monotonic attention
  (alignments 1e-5, max_attentions equal), Y_logits (rtol 1e-4, atol
  1e-5), Y (1e-5), Z_logits (1e-4), Z (1e-5);
* ``decode(mode="reference")``: cursors equal to ``synth/max_attentions``,
  Y within rtol 1e-4 / atol 2e-5 of ``synth/Y``, and SSRN on it within
  rtol 1e-4 / atol 5e-5 of ``synth/Z``.
"""
import os

import numpy as np
import pytest
import torch

from dc_tts_tpu_torch import convert
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.models import SSRN, Text2Mel
from dc_tts_tpu_torch.train.steps import teacher_forcing_shift

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "goldens",
                    "tf_reference_tiny.npz")
CFG = test_config().replace(ln_eps=1e-12)


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLD) as d:
        return {k: d[k] for k in d.files}


def _tf_vars(gold):
    return {k[len("var/"):]: v for k, v in gold.items()
            if k.startswith("var/")}


@pytest.fixture(scope="module")
def params(gold):
    return convert.convert(_tf_vars(gold), CFG)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol)


def test_convert_matches_jax_convert(gold, params):
    import jax
    from dc_tts_tpu import convert as jconvert
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu_torch.params import from_jax_params

    want = [from_jax_params(jax.device_get(t)) for t in jconvert.convert(
        _tf_vars(gold), jax_test_config().replace(ln_eps=1e-12))]
    for got, ref in zip(params, want):
        g, r = jax.tree_util.tree_flatten(got), jax.tree_util.tree_flatten(ref)
        assert g[1] == r[1]
        assert all(a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
                   for a, b in zip(g[0], r[0]))


def test_export_tf_names_roundtrip(gold, params):
    tf_vars = _tf_vars(gold)
    out = convert.export_tf_names(*params, CFG)
    assert set(out) == set(tf_vars)
    for k, v in tf_vars.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    # numpy trees export the same
    out_np = convert.export_tf_names(*(_to_numpy(p) for p in params), CFG)
    assert all(np.array_equal(out_np[k], out[k]) for k in out)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


def test_text_and_audio_encoders_match_tf(gold, params):
    model = Text2Mel(CFG)
    K, V = model.text_encode(params[0], torch.as_tensor(gold["in/L"]))
    _close(K, gold["out/K"], 1e-5, 1e-5)
    _close(V, gold["out/V"], 1e-5, 1e-5)
    Q = model.audio_encode(params[0], teacher_forcing_shift(
        torch.as_tensor(gold["in/mels"])))
    _close(Q, gold["out/Q"], 1e-5, 1e-5)


def test_attention_and_decoder_match_tf(gold, params):
    logits, Y, align, maxatt = Text2Mel(CFG).apply(
        params[0], torch.as_tensor(gold["in/L"]),
        teacher_forcing_shift(torch.as_tensor(gold["in/mels"])),
        monotonic=True,
        prev_max_attentions=torch.as_tensor(gold["in/prev_max_attentions"]))
    _close(align, gold["out/alignments"], 1e-5, 1e-5)
    np.testing.assert_array_equal(maxatt.numpy(), gold["out/max_attentions"])
    _close(logits, gold["out/Y_logits"], 1e-4, 1e-5)
    _close(Y, gold["out/Y"], 1e-5, 1e-5)


def test_ssrn_matches_tf(gold, params):
    logits, Z = SSRN(CFG).apply(params[1], torch.as_tensor(gold["out/Y"]))
    _close(logits, gold["out/Z_logits"], 1e-4, 1e-4)
    _close(Z, gold["out/Z"], 1e-5, 1e-5)


def test_reference_decode_matches_tf(gold, params):
    """decode(mode="reference") is the original synthesize.py loop."""
    with torch.no_grad():
        Y, A = Text2Mel(CFG).decode(params[0], torch.as_tensor(gold["in/L"]),
                                    mode="reference")
        _, Z = SSRN(CFG).apply(params[1], Y)
    np.testing.assert_array_equal(A.argmax(1).numpy(),
                                  gold["synth/max_attentions"])
    _close(Y, gold["synth/Y"], 1e-4, 2e-5)
    _close(Z, gold["synth/Z"], 1e-4, 5e-5)
