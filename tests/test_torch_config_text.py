"""The port's config, text frontend and parameter I/O against the JAX
package: Config field by field, ids id for id, and checkpoints written by
``dc_tts_tpu.train.checkpoint.save`` restored bit for bit."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dc_tts_tpu import config as jcfg
from dc_tts_tpu import text as jtext
from dc_tts_tpu.models.ssrn import SSRN as JSSRN
from dc_tts_tpu.train import checkpoint as jckpt

from dc_tts_tpu_torch import config as tcfg
from dc_tts_tpu_torch import text as ttext
from dc_tts_tpu_torch.models import SSRN
from dc_tts_tpu_torch.params import from_jax_params
from dc_tts_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SENTS = os.path.join(HERE, "..", "harvard_sentences.txt")
DERIVED = ("hop_length", "win_length", "n_freq", "vocab_size", "max_T_full")


@pytest.mark.parametrize("name", ["base_config", "test_config"])
def test_config_field_by_field(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    jf = [f.name for f in dataclasses.fields(j)]
    assert [f.name for f in dataclasses.fields(t)] == jf
    for f in jf:
        assert getattr(t, f) == getattr(j, f), f
    for p in DERIVED:
        assert getattr(t, p) == getattr(j, p), p
    assert t.replace(n_iter=7).n_iter == 7


def test_base_config_geometry():
    cfg = tcfg.base_config()
    assert (cfg.hop_length, cfg.win_length, cfg.n_freq) == (275, 1102, 1025)


def test_encode_batch_matches_jax():
    sents = jtext.load_test_sentences(SENTS)
    assert ttext.load_test_sentences(SENTS) == sents
    odd = ["Héllo, Wörld!", "  spaces   and\ttabs ", "x" * 400, "", "it's?"]
    for cfg in (tcfg.base_config(), tcfg.test_config()):
        np.testing.assert_array_equal(ttext.encode_batch(sents + odd, cfg),
                                      jtext.encode_batch(sents + odd, cfg))
    cfg = tcfg.base_config()
    for s in odd:
        ids = ttext.encode_text(s, cfg)
        np.testing.assert_array_equal(ids, jtext.encode_text(s, cfg))
        assert ttext.decode_ids(ids, cfg) == jtext.decode_ids(ids, cfg)


@pytest.fixture(scope="module")
def jax_ssrn_params():
    return JSSRN(jcfg.test_config()).init(jax.random.PRNGKey(1))


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_from_jax_params_round_trip(jax_ssrn_params):
    _assert_tree_equal(from_jax_params(jax_ssrn_params), jax_ssrn_params)


@pytest.mark.parametrize("layout", ["params", "train_state"])
def test_restore_jax_checkpoint(tmp_path, jax_ssrn_params, layout):
    """Both the params-only file and a full train state (parameters under
    ``params//``) restore into the port's own template."""
    tree = jax_ssrn_params if layout == "params" else {
        "params": jax_ssrn_params,
        "opt_state": {"count": np.asarray(3, np.int32)}}
    jckpt.save(str(tmp_path), tree, step=3000)
    template = SSRN(tcfg.test_config()).init(torch.Generator().manual_seed(5))
    got, step = tckpt.restore(str(tmp_path), template)
    assert step == 3000
    _assert_tree_equal(got, jax_ssrn_params)


def test_restore_errors(tmp_path, jax_ssrn_params):
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path), {})
    jckpt.save(str(tmp_path), jax_ssrn_params, step=1000)
    cfg = tcfg.test_config().replace(c=8)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path),
                      SSRN(cfg).init(torch.Generator().manual_seed(0)))
    with pytest.raises(KeyError):
        tckpt.restore(str(tmp_path), {"missing": torch.zeros(1)})
