"""The port's training path against the JAX package and the TF goldens, on
the CPU at ``test_config()``:

* dropout: keep rate, 1/keep scale, a fixed generator's fixed mask, and the
  identity outside training;
* losses against the JAX losses (1e-6; the diagonality metric, a sum over
  the whole grid, 1e-5) and against TF's
  ``loss/t2m/*``, ``loss/ssrn/*`` in tests/goldens/tf_reference_tiny.npz
  (rtol 1e-5, atol 1e-6, ``ln_eps=1e-12`` as tests/test_tf_goldens.py);
* the clipped gradients of both networks against TF's ``grad/*`` (all 289,
  rtol 1e-3, atol 1e-4), names mapped by ``convert.export_tf_names``; the
  TF variables reach the port through its own ``convert``, no JAX;
* three optimizer steps on identical gradients against the optax chain
  (rtol 1e-6);
* three full train steps of each network against the JAX step from the
  same state at dropout 0 (parameters atol 1e-5);
* a step's loss and gradients with ``use_pallas`` against without (loss
  rtol 1e-6, gradients atol 5e-5, as the JAX package's
  test_use_pallas_train_grads_match_default); an SSRN step at c = 10 with
  ``use_pallas`` (blocks of 10 channels routed off K4) against JAX's loss
  (rtol 1e-5);
* train-state checkpoints across the two packages, both ways, and the
  legacy params-only restore;
* the prepro and train CLIs on the CPU, resume included, and the train
  CLI's ``--pallas`` (every HC block of SSRN through K4).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.train import checkpoint as jckpt
from dc_tts_tpu.train import losses as jlosses
from dc_tts_tpu.train.optimizer import make_optimizer
from dc_tts_tpu.train.steps import (init_ssrn_state, init_text2mel_state,
                                    make_ssrn_step, make_text2mel_step)

from dc_tts_tpu_torch import convert
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.models import SSRN, Text2Mel
from dc_tts_tpu_torch.models.layers import dropout
from dc_tts_tpu_torch.params import (from_jax_params, from_jax_train_state,
                                     requires_grad)
from dc_tts_tpu_torch.train import checkpoint as tckpt
from dc_tts_tpu_torch.train import losses as tlosses
from dc_tts_tpu_torch.train import steps as TS
from dc_tts_tpu_torch.train.optimizer import (apply_updates, init_opt_state,
                                              tree_leaves, tree_map)

torch.set_num_threads(1)

CFG = test_config()
GOLD = os.path.join(os.path.dirname(__file__), "goldens",
                    "tf_reference_tiny.npz")


def _batch(seed=0, B=2):
    cfg = CFG
    rng = np.random.default_rng(seed)
    tl = np.array([12, cfg.max_N], np.int32)[:B]
    texts = np.zeros((B, cfg.max_N), np.int32)
    for i in range(B):
        texts[i, : tl[i]] = rng.integers(2, cfg.vocab_size, tl[i])
    ml = np.array([18, cfg.max_T], np.int32)[:B]
    return {"texts": texts, "text_lens": tl, "mel_lens": ml,
            "mels": rng.uniform(0, 1, (B, cfg.max_T, cfg.n_mels)
                                ).astype(np.float32),
            "mags": rng.uniform(0, 1, (B, cfg.max_T * cfg.r, cfg.n_freq)
                                ).astype(np.float32)}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _grad_tree(params, grads):
    by_id = dict(zip(map(id, tree_leaves(params)), grads))
    return tree_map(lambda p: by_id[id(p)].numpy(), params)


# ------------------------------------------------------------------ dropout


def test_dropout_keep_rate_and_scale():
    x = torch.ones(400, 500)
    y = dropout(x, 0.05, torch.Generator().manual_seed(0), True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.95) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.95, rtol=1e-7)


def test_dropout_fixed_generator_gives_fixed_mask():
    x = torch.randn(8, 30, 16, generator=torch.Generator().manual_seed(1))
    a = dropout(x, 0.3, torch.Generator().manual_seed(5), True)
    b = dropout(x, 0.3, torch.Generator().manual_seed(5), True)
    c = dropout(x, 0.3, torch.Generator().manual_seed(6), True)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("rate,gen,train", [
    (0.05, 0, False), (0.0, 0, True), (0.05, None, True)])
def test_dropout_is_identity_outside_training(rate, gen, train):
    x = torch.randn(4, 10, 8)
    g = None if gen is None else torch.Generator().manual_seed(gen)
    assert dropout(x, rate, g, train) is x


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("lens", [True, False])
def test_losses_match_jax(lens):
    cfg = CFG
    rng = np.random.default_rng(3)
    B, N, T = 3, cfg.max_N, cfg.max_T
    logits = rng.standard_normal((B, T, cfg.n_mels)).astype(np.float32) * 3
    mels = rng.uniform(0, 1, logits.shape).astype(np.float32)
    align = rng.dirichlet(np.ones(N), (B, T)).transpose(0, 2, 1).astype(
        np.float32)
    tl = np.array([5, 13, 20], np.int32) if lens else None
    ml = np.array([7, 24, 16], np.int32) if lens else None
    Y = 1.0 / (1.0 + np.exp(-logits))
    jc = jlosses.text2mel_loss(logits, Y, align, mels, jax_test_config(),
                               tl, ml)[1]
    t = [torch.as_tensor(a) for a in (logits, Y, align, mels)]
    tt = [None if a is None else torch.as_tensor(a) for a in (tl, ml)]
    tc = tlosses.text2mel_loss(*t, cfg, *tt)[1]
    for k in jc:
        np.testing.assert_allclose(float(tc[k]), float(jc[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        float(tlosses.attention_diagonality(t[2], *tt)),
        float(jlosses.attention_diagonality(align, tl, ml)), rtol=1e-5)
    mags = rng.uniform(0, 1, logits.shape).astype(np.float32)
    jc = jlosses.ssrn_loss(logits, Y, mags, jax_test_config())[1]
    tc = tlosses.ssrn_loss(t[0], t[1], torch.as_tensor(mags), cfg)[1]
    for k in jc:
        np.testing.assert_allclose(float(tc[k]), float(jc[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(
        tlosses.guided_attention_matrix(N, T),
        jlosses.guided_attention_matrix(N, T))


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLD) as d:
        g = {k: d[k] for k in d.files}
    t2m, ssrn = convert.convert({k[len("var/"):]: v for k, v in g.items()
                                 if k.startswith("var/")},
                                CFG.replace(ln_eps=1e-12))
    return g, t2m, ssrn


def _tf_loss(net, gold):
    g, t2m_p, ssrn_p = gold
    cfg = CFG.replace(ln_eps=1e-12)
    mels = torch.as_tensor(g["in/mels"])
    if net == "t2m":
        requires_grad(t2m_p)
        logits, Y, align, _ = Text2Mel(cfg).apply(
            t2m_p, torch.as_tensor(g["in/L"]), TS.teacher_forcing_shift(mels))
        return t2m_p, tlosses.text2mel_loss(logits, Y, align, mels, cfg)
    requires_grad(ssrn_p)
    logits, Z = SSRN(cfg).apply(ssrn_p, mels)
    return ssrn_p, tlosses.ssrn_loss(logits, Z, torch.as_tensor(g["in/mags"]),
                                     cfg)


@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_losses_match_tf_goldens(gold, net):
    _, (_, comps) = _tf_loss(net, gold)
    for name, v in comps.items():
        np.testing.assert_allclose(float(v.detach()),
                                   float(gold[0][f"loss/{net}/{name}"]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_clipped_grads_match_tf_goldens(gold, net):
    g = gold[0]
    params, (loss, _) = _tf_loss(net, gold)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    tree = _grad_tree(params, [torch.clamp(x, -1.0, 1.0) for x in grads])
    cfg = CFG.replace(ln_eps=1e-12)
    if net == "t2m":
        named = convert.export_tf_names(tree, {"stack": []}, cfg)
        prefix = "Text2Mel/"
    else:
        empty = {"embed": {"table": np.zeros((cfg.vocab_size, cfg.e))},
                 "text_enc": [], "audio_enc": [], "audio_dec": []}
        named = convert.export_tf_names(empty, tree, cfg)
        prefix = "SSRN/"
    named = {k: v for k, v in named.items() if k.startswith(prefix)}
    gold_keys = [k for k in g if k.startswith(f"grad/{net}/")]
    assert sorted(f"grad/{net}/{k}" for k in named) == sorted(gold_keys)
    for k, v in named.items():
        np.testing.assert_allclose(v, g[f"grad/{net}/{k}"], rtol=1e-3,
                                   atol=1e-4, err_msg=k)


# ---------------------------------------------------------------- optimizer


def test_optimizer_matches_optax():
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.standard_normal((3, 5)).astype(np.float32)},
              "l": [{"b": rng.standard_normal(7).astype(np.float32)}]}
    grads = [tree_map(lambda p: (rng.standard_normal(p.shape) * 2
                                 ).astype(np.float32), params)
             for _ in range(3)]
    opt = make_optimizer(jax_test_config())
    jp, js = params, opt.init(params)
    tp = from_jax_params(params)
    ts = init_opt_state(tp)
    for g in grads:
        u, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        ts = apply_updates(tp, from_jax_params(g), ts, CFG)
    flat_j = jckpt._flatten({"params": jp, "opt_state": js})
    flat_t = tckpt._flatten({"params": tp, "opt_state": ts})
    assert sorted(flat_j) == sorted(flat_t)
    for k in flat_j:
        assert flat_t[k].dtype == flat_j[k].dtype, k
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=1e-6, atol=0,
                                   err_msg=k)


# ------------------------------------------------------------------ steps


@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_three_train_steps_match_jax(net):
    jcfg = jax_test_config()
    init, make = ((init_text2mel_state, make_text2mel_step) if net == "t2m"
                  else (init_ssrn_state, make_ssrn_step))
    tmake = TS.make_text2mel_step if net == "t2m" else TS.make_ssrn_step
    state = init(jcfg, jax.random.PRNGKey(0))
    tp, to = from_jax_train_state(jax.device_get(state.params),
                                  jax.device_get(state.opt_state))
    tstate = TS.TrainState(tp, to, 0)
    batch = _batch()
    jstep, tstep = jax.jit(make(jcfg)), tmake(CFG)
    for _ in range(3):
        state, jm = jstep(state, batch, jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, _torch(batch), None)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert tstate.step == 3
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(state.params)),
                    tree_leaves(tstate.params)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=1e-5)


def _pallas_loss(net, params, cfg):
    """The JAX package's use_pallas test construction: ids in [1, vocab)
    and a uniform decoder input, so no frame is constant (a constant frame
    makes each layer norm scale gradients by 1/sqrt(eps) and leaves them
    to rounding, in either package)."""
    rng = np.random.default_rng(15)
    if net == "t2m":
        ids = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                           (2, cfg.max_N)))
        S = torch.as_tensor(rng.uniform(0, 1, (2, cfg.max_T, cfg.n_mels)
                                        ).astype(np.float32))
        logits, Y, _, _ = Text2Mel(cfg).apply(params, ids, S, train=True)
    else:
        Yin = torch.as_tensor(rng.uniform(0, 1, (2, cfg.max_T, cfg.n_mels)
                                          ).astype(np.float32))
        logits, Y = SSRN(cfg).apply(params, Yin, train=True)
    return torch.mean(torch.abs(Y)) + torch.mean(logits ** 2)


@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_use_pallas_step_matches_default(net):
    init = TS.init_text2mel_state if net == "t2m" else TS.init_ssrn_state
    params = init(CFG, torch.Generator().manual_seed(13)).params
    out = []
    for use_pallas in (False, True):
        loss = _pallas_loss(net, params, CFG.replace(use_pallas=use_pallas))
        out.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-5)


# ------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def jax_state():
    state = init_text2mel_state(jax_test_config(), jax.random.PRNGKey(2))
    # non-trivial moments and counts
    g = jax.tree.map(lambda p: jnp.full_like(p, 0.3), state.params)
    opt = make_optimizer(jax_test_config())
    u, s = opt.update(g, state.opt_state, state.params)
    return jax.device_get(optax.apply_updates(state.params, u)), \
        jax.device_get(s)


def _flat_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_train_state_resumes_in_port(tmp_path, jax_state):
    jp, js = jax_state
    jckpt.save_train_state(str(tmp_path), jp, js, 7000)
    tmpl = TS.init_text2mel_state(CFG, torch.Generator().manual_seed(0))
    p, s, step, kind = tckpt.restore_train_state(str(tmp_path), tmpl.params,
                                                 tmpl.opt_state)
    assert (step, kind) == (7000, "full")
    _flat_equal(tckpt._flatten({"params": p, "opt_state": s}),
                jckpt._flatten({"params": jp, "opt_state": js}))
    assert s[1]["count"].dtype == torch.int32 and int(s[2]["count"]) == 1


def test_port_train_state_resumes_in_jax(tmp_path, jax_state):
    tp, ts = from_jax_train_state(*jax_state)
    path = tckpt.save_train_state(str(tmp_path), tp, ts, 12000)
    assert os.path.basename(path) == "model_gs_012k.npz"
    with np.load(path) as d:
        keys = set(d.files)
    assert {"__step__", "opt_state//1//count", "opt_state//2//count",
            "opt_state//1//mu//embed//table", "opt_state//1//nu//embed//table",
            "params//embed//table"} <= keys
    state = init_text2mel_state(jax_test_config(), jax.random.PRNGKey(9))
    jp, js, step, kind = jckpt.restore_train_state(
        str(tmp_path), state.params, state.opt_state)
    assert (step, kind) == (12000, "full")
    _flat_equal(jckpt._flatten({"params": jp, "opt_state": js}),
                jckpt._flatten({"params": jax_state[0],
                                "opt_state": jax_state[1]}))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_legacy_params_only_restore_fast_forwards_counts(tmp_path, writer,
                                                         jax_state):
    jp = jax_state[0]
    if writer == "jax":
        jckpt.save(str(tmp_path), jp, 5000)
    else:
        tckpt.save(str(tmp_path), from_jax_params(jp), 5000)
    tmpl = TS.init_text2mel_state(CFG, torch.Generator().manual_seed(0))
    p, s, step, kind = tckpt.restore_train_state(str(tmp_path), tmpl.params,
                                                 tmpl.opt_state)
    assert (step, kind) == (5000, "legacy")
    assert int(s[1]["count"]) == int(s[2]["count"]) == 5000
    assert all(float(m.abs().max()) == 0.0 for m in tree_leaves(s[1]["mu"]))
    _flat_equal(tckpt._flatten(p), jckpt._flatten(jp))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restore_or_init(tmp_path, writer, jax_state):
    """A fresh logdir keeps the template at step 0; a saved one (either
    package's) is restored, as the JAX restore_or_init does."""
    jp = jax_state[0]
    tmpl = from_jax_params(jax.tree.map(np.zeros_like, jp))
    got, step = tckpt.restore_or_init(str(tmp_path / "fresh"), tmpl)
    assert step == 0 and got is tmpl
    if writer == "jax":
        jckpt.save(str(tmp_path), jp, 3000)
    else:
        tckpt.save(str(tmp_path), from_jax_params(jp), 3000)
    got, step = tckpt.restore_or_init(str(tmp_path), tmpl)
    want, jstep = jckpt.restore_or_init(str(tmp_path), jp)
    assert step == jstep == 3000
    _flat_equal(tckpt._flatten(got), jckpt._flatten(want))


def test_save_keeps_newest(tmp_path):
    p = {"w": torch.ones(2)}
    for step in (1000, 2000, 3000):
        tckpt.save(str(tmp_path), p, step, keep=2)
    assert tckpt.sorted_checkpoints(str(tmp_path)) == [
        "model_gs_002k.npz", "model_gs_003k.npz"]


# -------------------------------------------------------------------- CLIs


def test_cli_prepro_train_and_resume_on_cpu(tmp_path, capsys):
    from dc_tts_tpu_torch import prepro
    from dc_tts_tpu_torch.data.synthetic import make_corpus
    from dc_tts_tpu_torch.train.__main__ import main as train_main

    texts = ["the cat sat", "a dog ran", "big red hat", "sun is up"] * 2
    data = make_corpus(str(tmp_path / "corpus"), texts,
                       [0.06 + 0.004 * i for i in range(8)], CFG.sr)
    feats = str(tmp_path / "feats")
    prepro.main(["--tiny", "--device", "cpu", "--data", data, "--out",
                 feats])
    assert len(os.listdir(os.path.join(feats, "mels"))) == 8
    for num in (1, 2):
        logdir = str(tmp_path / f"log{num}")
        common = [str(num), "--tiny", "--device", "cpu", "--data", data,
                  "--features", feats, "--logdir", logdir,
                  "--ckpt-every", "2", "--log-every", "1"]
        train_main(common + ["--max-steps", "2"])
        with np.load(os.path.join(logdir, "model_gs_000k.npz")) as d:
            assert int(d["__step__"]) == 2
            assert int(d["opt_state//1//count"]) == 2
        train_main(common + ["--max-steps", "3"])
        assert "resumed from step 2 (full checkpoint)" in \
            capsys.readouterr().out
        with np.load(os.path.join(logdir, "model_gs_000k.npz")) as d:
            assert int(d["__step__"]) == 3


@pytest.fixture(scope="module")
def tiny_features(tmp_path_factory):
    """(corpus, features) of 8 synthetic utterances at the tiny config."""
    from dc_tts_tpu_torch import prepro
    from dc_tts_tpu_torch.data.synthetic import make_corpus

    root = tmp_path_factory.mktemp("cli")
    data = make_corpus(str(root / "corpus"), ["the cat sat", "a dog ran"] * 4,
                       [0.06 + 0.004 * i for i in range(8)], CFG.sr)
    feats = str(root / "feats")
    prepro.main(["--tiny", "--device", "cpu", "--data", data, "--out",
                 feats])
    return data, feats


@pytest.mark.parametrize("pallas", [False, True])
def test_train_cli_pallas_routes_ssrn_hc_blocks_through_k4(
        pallas, tiny_features, tmp_path, monkeypatch):
    """``--dtype bfloat16 --pallas`` trains SSRN with every one of its 8 HC
    blocks through K4 in bf16 operands: 8 forward and 8 backward calls a
    step, each inside its ``k4.fwd`` / ``k4.bwd`` span; without
    ``--pallas`` none."""
    from dc_tts_tpu_torch.ops import hc_vjp
    from dc_tts_tpu_torch.train.__main__ import main as train_main
    from dc_tts_tpu_torch.utils import profiling

    calls = []
    for d in ("fwd", "bwd"):
        orig = getattr(hc_vjp, f"hc_block_{d}")

        def seam(*a, _d=d, _orig=orig, **k):
            calls.append((_d, a[-1]))           # bf16, the last argument
            return _orig(*a, **k)
        monkeypatch.setattr(hc_vjp, f"hc_block_{d}", seam)
    data, feats = tiny_features
    profiling.reset()
    with profiling.collect():
        train_main(["2", "--tiny", "--device", "cpu", "--data", data,
                    "--features", feats, "--logdir", str(tmp_path / "log"),
                    "--dtype", "bfloat16", "--max-steps", "2"]
                   + ["--pallas"] * pallas)
    spans = profiling.summary()
    profiling.reset()
    step = [("fwd", True)] * 8 + [("bwd", True)] * 8
    assert calls == step * 2 * pallas
    for d in ("fwd", "bwd"):
        assert spans.get(f"k4.{d}", {"count": 0})["count"] == 8 * 2 * pallas


@pytest.mark.parametrize("flag", [["--data-parallel", "2"],
                                  ["--model-parallel", "2"],
                                  ["--dtype", "float16"],
                                  ["--rng", "threefry"]])
def test_train_cli_refuses_unported_flags(flag):
    from dc_tts_tpu_torch.train.__main__ import main as train_main
    with pytest.raises(SystemExit):
        train_main(["1", "--tiny", "--device", "cpu"] + flag)


@pytest.mark.parametrize("cli", ["prepro", "train"])
def test_entry_points_raise_without_a_card(cli, monkeypatch):
    from dc_tts_tpu_torch import prepro
    from dc_tts_tpu_torch.train.__main__ import main as train_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        (prepro.main([]) if cli == "prepro" else train_main(["1", "--tiny"]))


# ---------------------------------------------- K4 at a narrow channel count


def test_ssrn_step_at_c10_with_use_pallas_matches_jax(monkeypatch):
    """c = 10: under ``use_pallas`` every HC block of SSRN takes K4, those
    of 10 channels (not a multiple of the 4 its 16-byte copies take,
    stored padded on the card) as those of 20; one train step's loss
    equals the JAX step's (which runs its own kernel on both,
    interpreted)."""
    from dc_tts_tpu_torch.ops import hc_vjp

    widths = []
    kernel = hc_vjp.hc_block_trainable

    def spy(x, *a, **kw):
        widths.append(x.shape[-1])
        return kernel(x, *a, **kw)
    monkeypatch.setattr(hc_vjp, "hc_block_trainable", spy)
    jcfg = jax_test_config().replace(c=10, use_pallas=True)
    cfg = CFG.replace(c=10, use_pallas=True)
    state = init_ssrn_state(jcfg, jax.random.PRNGKey(0))
    tp, to = from_jax_train_state(jax.device_get(state.params),
                                  jax.device_get(state.opt_state))
    batch = _batch()
    state, jm = jax.jit(make_ssrn_step(jcfg))(state, batch,
                                              jax.random.PRNGKey(1))
    _, tm = TS.make_ssrn_step(cfg)(TS.TrainState(tp, to, 0), _torch(batch),
                                   None)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert set(widths) == {10, 20}
    assert hc_vjp.stored_channels(10, False) == 12
