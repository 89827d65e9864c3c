"""The port's reduced-precision modes and remat against the JAX package on
the CPU, at ``test_config()``, on JAX's parameters carried across with
``from_jax_params``:

* (a) ``Text2Mel.apply`` and ``SSRN.apply`` in training mode under each
  ``compute_dtype`` (``float32_high``, ``bfloat16``, ``bfloat16_full``):
  the loss, the outputs and the loss gradients. JAX's "high" on the CPU is
  true float32, the port's the explicit 3-pass bf16 split (~1e-5 relative).
  In the bf16 modes a float32 sum taken in another order flips a bf16
  rounding of the next block's operand now and then (2^-8 of that
  element), and 30 blocks amplify those flips: the whole networks are held
  at bf16-noise tolerances (below), and every block alone, fed JAX's own
  input and cotangent, at tight ones (``test_every_block_matches_jax``).
* (b) K4's bf16 operand mode: the plain forward, the plain backward and
  the autograd.Function's CPU route against the interpreted TPU kernel
  ``hc_block_trainable(..., interpret=True, bf16=True)`` at
  tests/test_pallas.py's bf16 geometry and a non-causal one: 2e-3 x each
  output's max (that test's bar is 2e-2; the same rounding points here).
* (c) ``use_pallas`` with ``bfloat16``: the whole Text2Mel against JAX's
  same config (K4's bf16 body on both sides).
* (d) ``remat``: loss and gradients bitwise equal to the run without it at
  dropout 0.05, each block's forward run twice.
* (e) ``Synthesizer(ssrn_precision=p)``'s Z against JAX's SSRN at ``p`` on
  JAX's decoded mels.
* (f) the train CLI with ``--dtype`` and the synthesis CLI with
  ``--ssrn-precision``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.models import blocks as JB
from dc_tts_tpu.models.ssrn import SSRN as JSSRN
from dc_tts_tpu.models.text2mel import Text2Mel as JText2Mel
from dc_tts_tpu.ops.pallas_hc_vjp import hc_block_trainable as jax_hc
from dc_tts_tpu.pipeline import Synthesizer as JSynthesizer

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.models import SSRN, Text2Mel
from dc_tts_tpu_torch.models import blocks as TB
from dc_tts_tpu_torch.models.ssrn import ssrn_specs
from dc_tts_tpu_torch.models.text2mel import (audio_dec_specs,
                                              audio_enc_specs,
                                              text_enc_specs)
from dc_tts_tpu_torch.ops import hc_vjp as K4
from dc_tts_tpu_torch.params import from_jax_params
from dc_tts_tpu_torch.pipeline import Synthesizer
from dc_tts_tpu_torch.train.optimizer import tree_leaves
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = test_config()
DTYPES = ("float32_high", "bfloat16", "bfloat16_full")
# whole-network tolerances by compute_dtype: loss (relative), outputs (x
# each output's max |value|), gradients (relative L2 distance over all
# leaves). Measured here: "high" 2.4e-7 / 1.5e-4 / 4.0e-5; bfloat16 6.0e-6
# / 9.3e-3 / 2.5e-2; bfloat16_full 8.9e-5 / 2.4e-2 / 9.7e-3 (Text2Mel, the
# deeper of the two; 5.3e-4 / 9.9e-2 / 6.2e-2 while the port's bf16
# sigmoid rounded once where JAX's program rounds after exp, the add and
# the divide, blocks._sigmoid).
TOL = {"float32_high": (1e-5, 1e-3, 5e-4),
       "bfloat16": (1e-4, 3e-2, 0.1),
       "bfloat16_full": (3e-4, 6e-2, 3e-2)}
_RNG = np.random.default_rng(15)
IDS = _RNG.integers(1, CFG.vocab_size, (2, CFG.max_N)).astype(np.int32)
MELS = _RNG.uniform(0, 1, (2, CFG.max_T, CFG.n_mels)).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return {"t2m": jax.device_get(
                JText2Mel(jax_test_config()).init(jax.random.PRNGKey(0))),
            "ssrn": jax.device_get(
                JSSRN(jax_test_config()).init(jax.random.PRNGKey(1)))}


def _jax_apply(net, params, cfg):
    """(loss, outputs, gradients as leaves) of the JAX network."""
    def loss_fn(p):
        if net == "t2m":
            logits, Y, A, _ = JText2Mel(cfg).apply(
                p, jnp.asarray(IDS), jnp.asarray(MELS), train=True)
            outs = (logits, Y, A)
        else:
            logits, Y = JSSRN(cfg).apply(p, jnp.asarray(MELS), train=True)
            outs = (logits, Y)
        return jnp.mean(jnp.abs(Y)) + jnp.mean(logits ** 2), outs

    (loss, outs), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return (float(loss), [np.asarray(o) for o in outs],
            [np.asarray(a) for a in jax.tree_util.tree_leaves(g)])


def _port_apply(net, params, cfg, gen=None):
    """The port's (loss, outputs, gradients as leaves) on the same data."""
    for t in tree_leaves(params):
        t.requires_grad_(True)
    if net == "t2m":
        logits, Y, A, _ = Text2Mel(cfg).apply(
            params, torch.as_tensor(IDS), torch.as_tensor(MELS), gen=gen,
            train=True)
        outs = (logits, Y, A)
    else:
        logits, Y = SSRN(cfg).apply(params, torch.as_tensor(MELS), gen=gen,
                                    train=True)
        outs = (logits, Y)
    loss = torch.mean(torch.abs(Y)) + torch.mean(logits ** 2)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss, outs, grads


def _rel_l2(got, want):
    num = sum(float(np.sum((g.detach().double().numpy() - w) ** 2))
              for g, w in zip(got, want))
    return (num / sum(float(np.sum(np.square(w, dtype=np.float64)))
                      for w in want)) ** 0.5


def _check_network(loss, outs, grads, jloss, jouts, jgrads, tol):
    tl, to, tg = tol
    np.testing.assert_allclose(loss.item(), jloss, rtol=tl)
    for o, j in zip(outs, jouts):
        assert o.dtype == torch.float32 and o.shape == j.shape
        np.testing.assert_allclose(o.detach().numpy(), j, rtol=0,
                                   atol=to * np.abs(j).max())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert _rel_l2(grads, jgrads) <= tg


# ----------------------------------------------------------------- (a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_apply_matches_jax(jparams, net, dtype):
    jl, jo, jg = _jax_apply(net, jparams[net],
                            jax_test_config().replace(compute_dtype=dtype))
    loss, outs, grads = _port_apply(net, from_jax_params(jparams[net]),
                                    CFG.replace(compute_dtype=dtype))
    _check_network(loss, outs, grads, jl, jo, jg, TOL[dtype])


def _jax_spec(spec):
    kind = {TB.C: JB.C, TB.HC: JB.HC, TB.D: JB.D}[type(spec)]
    return kind(**{f: getattr(spec, f) for f in spec.__dataclass_fields__})


# per-block tolerances by compute_dtype, x each tensor's max |value|:
# (forward, gradients). "high": the split's ~1e-5 (measured 8e-6 / 3e-5);
# bfloat16: float32 rounding forward (3e-7), and the bf16-rounded cotangent
# products, one of which flips by 2^-8 now and then (2.4e-3); bfloat16_full:
# bf16 roundings that a float32 sum taken in another order flips, through
# the gate's three roundings and the layer norms' backward (3.0e-3 /
# 4.7e-2; 1.3e-2 forward with the once-rounded sigmoid). XLA on the CPU
# also keeps the C block's bias add in float32 into its layer norm (a
# convert pair its CPU pipeline drops) where it rounds the HC block's; the
# port rounds both: a choice of that backend, worth nothing measurable
# here (the C blocks' forward reads 2.4e-4 either way).
BLOCK_TOL = {"float32_high": (5e-5, 2e-4), "bfloat16": (1e-5, 1e-2),
             "bfloat16_full": (1e-2, 8e-2)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_block_matches_jax(jparams, dtype):
    """Each block of all four stacks, in training mode, fed the JAX
    block's input: its output and the VJP (parameters and input) for a
    seeded cotangent. A ReLU block's cotangent is 0 where JAX's output is
    below 1e-4, so that a mask decided within rounding of its kink (the
    "high" split moves values by ~1e-5) does not count."""
    jdt, act = TB.operand_modes(dtype)
    jd = {None: None, "high": "high", torch.bfloat16: jnp.bfloat16}[jdt]
    ja = None if act is None else jnp.bfloat16
    rng = np.random.default_rng(3)
    stacks = [(jparams["t2m"]["text_enc"], text_enc_specs(CFG), CFG.e,
               CFG.max_N),
              (jparams["t2m"]["audio_enc"], audio_enc_specs(CFG), CFG.n_mels,
               CFG.max_T),
              (jparams["t2m"]["audio_dec"], audio_dec_specs(CFG), 2 * CFG.d,
               CFG.max_T),
              (jparams["ssrn"]["stack"], ssrn_specs(CFG), CFG.n_mels,
               CFG.max_T)]
    tf, tg = BLOCK_TOL[dtype]
    n = 0
    for params, specs, cin, T in stacks:
        jx = jnp.asarray(rng.uniform(0, 1, (2, T, cin)).astype(np.float32))
        if ja is not None:
            jx = jx.astype(ja)
        for p, spec in zip(params, specs):
            jy, vjp = jax.vjp(
                lambda p_, x_, s=_jax_spec(spec): JB.apply_block(
                    p_, s, x_, ln_eps=CFG.ln_eps, dropout_rate=0.0, rng=None,
                    train=True, dtype=jd, act_dtype=ja), p, jx)
            y32 = np.asarray(jy.astype(jnp.float32))
            cot = rng.standard_normal(jy.shape).astype(np.float32)
            if getattr(spec, "act", None) == "relu":
                cot *= y32 >= 1e-4
            jgp, jgx = vjp(jnp.asarray(cot).astype(jy.dtype))
            tp = from_jax_params(p)
            for t in tree_leaves(tp):
                t.requires_grad_(True)
            x = torch.tensor(np.asarray(jx.astype(jnp.float32)),
                             requires_grad=True)
            y = TB.apply_block(tp, spec, x if act is None else x.to(act),
                               ln_eps=CFG.ln_eps, train=True, dtype=jdt,
                               act_dtype=act)
            assert y.dtype == (act or torch.float32)
            np.testing.assert_allclose(y.float().detach().numpy(), y32,
                                       rtol=0, atol=tf * np.abs(y32).max())
            got = torch.autograd.grad(y, tree_leaves(tp) + [x],
                                      torch.as_tensor(cot).to(y.dtype))
            want = jax.tree_util.tree_leaves(jgp) + [jgx]
            for g, w in zip(got, want):
                w = np.asarray(w.astype(jnp.float32))
                np.testing.assert_allclose(
                    g.float().numpy(), w, rtol=0,
                    atol=tg * max(np.abs(w).max(), 1e-6),
                    err_msg=f"{spec} {dtype}")
            jx = jy
            n += 1
    assert n == len(text_enc_specs(CFG)) + len(audio_enc_specs(CFG)) + len(
        audio_dec_specs(CFG)) + len(ssrn_specs(CFG))


# ----------------------------------------------------------------- (b)

K4_NAMES = ("dx", "dw", "db", "dg1", "db1", "dg2", "db2")


@pytest.mark.parametrize("size,rate,causal,T", [(3, 3, True, 24),
                                                (3, 2, False, 40)])
def test_k4_bf16_plain_matches_jax_kernel(size, rate, causal, T):
    rng = np.random.default_rng(size * 100 + rate + T)
    C, B = 16, 2
    args = [rng.standard_normal((B, T, C)).astype(np.float32),
            (rng.standard_normal((size, C, 2 * C)) * 0.2).astype(np.float32)]
    args += [(rng.standard_normal(n) * 0.3 + (1.0 if i in (1, 3) else 0.0)
              ).astype(np.float32)
             for i, n in enumerate([2 * C, C, C, C, C])]
    dy = rng.standard_normal((B, T, C)).astype(np.float32)
    jy, vjp = jax.vjp(lambda *a: jax_hc(*a, size, rate, causal, 1e-5, True,
                                        True),
                      *[jnp.asarray(a) for a in args])
    jy, jgrads = np.asarray(jy), [np.asarray(g) for g in
                                  vjp(jnp.asarray(dy))]
    geo = (size, rate, causal, 1e-5, True)
    t = [torch.as_tensor(a) for a in args]
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    before = profiling.counts()
    y_auto = K4.hc_block_trainable(*leaves, *geo)
    auto = torch.autograd.grad(y_auto, leaves, torch.as_tensor(dy))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert profiling.counts() == before
    for y in (K4.hc_block_fwd_plain(*t, *geo), y_auto):
        np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0,
                                   atol=2e-3 * np.abs(jy).max())
    for grads in (K4.hc_block_bwd_plain(*t, torch.as_tensor(dy), *geo),
                  auto):
        for n, g, jg in zip(K4_NAMES, grads, jgrads):
            np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                       atol=2e-3 * max(1e-3,
                                                       np.abs(jg).max()),
                                       err_msg=n)
    # bf16 operands really are rounded: the float32 mode differs
    y32 = K4.hc_block_fwd_plain(*t, size, rate, causal, 1e-5)
    assert float((y32 - torch.tensor(jy)).abs().max()) > 1e-4


# the smallest HC width at which the JAX package's VMEM gate keeps a block
# off its K4 whatever T is (the weights alone bust the budget), one block
# of SSRN's HC(3, 1) at T=8; SSRN's C=512 blocks of the trainer (T >= 104)
# are off it too
WIDE_T, WIDE_C = 8, 568
# distances from JAX's XLA route, x each tensor's max |value|, measured
# here: K4's bf16 route y 3.8e-7, dx 2.1e-3, dW 3.8e-3 (its dW and the conv
# part of dx stay float32, where XLA's transpose of the bf16 conv rounds
# them to bf16); the port's own XLA-like route dx 2.9e-4, dW 1.1e-3 (bf16
# roundings flipped by float32 sums taken in another order)
WIDE_PIN = {True: (1e-6, 5e-3, 6e-3), False: (1e-6, 1e-3, 2.5e-3)}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_k4_bf16_on_a_block_jax_keeps_off_k4(use_pallas):
    """Under compute_dtype="bfloat16" + use_pallas the port runs K4's bf16
    body on every HC block, where JAX's hc_train_fits sends the wide ones
    to XLA. Both of the port's routes against JAX's there: y, dx, dW, each
    pinned at its measured distance (WIDE_PIN) and within the bfloat16
    block tolerance. K4's dW is float32 where JAX's is bf16-rounded: no
    more than bf16 noise apart, so the port keeps one route for all
    shapes (models/blocks.py)."""
    from dc_tts_tpu.ops.pallas_hc_vjp import hc_train_fits
    assert not hc_train_fits(WIDE_T, WIDE_C, 3, 1)
    assert hc_train_fits(WIDE_T, WIDE_C - 8, 3, 1)
    jspec, spec = JB.HC(3, 1), TB.HC(3, 1)
    params, _ = JB.init_stack(jax.random.PRNGKey(4), WIDE_C, [jspec])
    p = params[0]
    rng = np.random.default_rng(5)
    for k in ("ln1", "ln2"):
        p[k] = {"gamma": jnp.asarray(1 + 0.3 * rng.standard_normal(WIDE_C),
                                     jnp.float32),
                "beta": jnp.asarray(0.2 * rng.standard_normal(WIDE_C),
                                    jnp.float32)}
    x = rng.standard_normal((2, WIDE_T, WIDE_C)).astype(np.float32)
    cot = rng.standard_normal((2, WIDE_T, WIDE_C)).astype(np.float32)
    jy, vjp = jax.vjp(lambda p_, x_: JB.apply_block(
        p_, jspec, x_, ln_eps=1e-5, dropout_rate=0.0, rng=None, train=True,
        dtype=jnp.bfloat16, use_pallas=True), p, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    want = [np.asarray(a) for a in (jy, jgx, jgp["conv"]["w"])]
    tp = from_jax_params(p)
    w = tp["conv"]["w"].requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    before = profiling.counts()
    y = TB.apply_block(tp, spec, xt, ln_eps=1e-5, train=True,
                       dtype=torch.bfloat16, use_pallas=use_pallas)
    gx, gw = torch.autograd.grad(y, [xt, w], torch.as_tensor(cot))
    assert profiling.counts() == before  # plain versions on the CPU
    # JAX's dW is bf16-rounded, and so is the port's XLA-like route's
    assert torch.equal(gw, gw.to(torch.bfloat16).float()) != use_pallas
    tf, tg = BLOCK_TOL["bfloat16"]
    dist = []
    for got, ref, pin, tol in zip((y, gx, gw), want, WIDE_PIN[use_pallas],
                                  (tf, tg, tg)):
        d = float(np.abs(got.detach().numpy() - ref).max()
                  / np.abs(ref).max())
        dist.append(d)
        assert d <= min(pin, tol)
    print(f"use_pallas={use_pallas}: y {dist[0]:.2e} dx {dist[1]:.2e} "
          f"dW {dist[2]:.2e} (x max)")


# ----------------------------------------------------------------- (c)


def test_use_pallas_bf16_text2mel_matches_jax(jparams):
    jcfg = jax_test_config().replace(compute_dtype="bfloat16",
                                     use_pallas=True)
    jl, jo, jg = _jax_apply("t2m", jparams["t2m"], jcfg)
    cfg = CFG.replace(compute_dtype="bfloat16", use_pallas=True)
    loss, outs, grads = _port_apply("t2m", from_jax_params(jparams["t2m"]),
                                    cfg)
    _check_network(loss, outs, grads, jl, jo, jg, TOL["bfloat16"])


# ----------------------------------------------------------------- (d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_full"])
@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_remat_gradients_equal(jparams, net, dtype, monkeypatch):
    cfg = CFG.replace(compute_dtype=dtype, dropout_rate=0.05)
    calls = []
    apply_block = TB.apply_block

    def counted(*a, **kw):
        calls.append(1)
        return apply_block(*a, **kw)

    monkeypatch.setattr(TB, "apply_block", counted)
    runs = []
    for remat in (False, True):
        calls.clear()
        gen = torch.Generator().manual_seed(7)
        runs.append((_port_apply(net, from_jax_params(jparams[net]),
                                 cfg.replace(remat=remat), gen),
                     len(calls), gen.get_state()))
    ((l0, o0, g0), n0, s0), ((l1, o1, g1), n1, s1) = runs
    assert n1 == 2 * n0          # every block recomputed in the backward
    assert torch.equal(s0, s1)   # the generator moved on as without remat
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    # dropout drew masks: the step differs from one at dropout 0
    l2 = _port_apply(net, from_jax_params(jparams[net]),
                     cfg.replace(dropout_rate=0.0))[0]
    assert not torch.equal(l0, l2)


# ----------------------------------------------------------------- (e)


@pytest.fixture(scope="module")
def decoded(jparams):
    """JAX's synthesis of three short id rows: (ids, Y)."""
    ids = np.zeros((3, CFG.max_N), np.int32)
    for i in range(3):
        ids[i, : 6 + 3 * i] = (np.arange(6 + 3 * i) % 28) + 3
    jcfg = jax_test_config().replace(stft_method="fft")
    Y = JSynthesizer(jcfg, jparams["t2m"], jparams["ssrn"]).synthesize_ids(
        ids)[1]
    return ids, np.asarray(Y)


@pytest.mark.parametrize("prec,tol", [("highest", 1e-4), ("high", 1e-4),
                                      ("bf16", 3e-2)])
def test_synthesizer_ssrn_precision_matches_jax(jparams, decoded, prec, tol):
    """Z at the golden tolerance 1e-4 (the port's "high" is the 3-pass
    split, JAX's on the CPU float32); bf16 at bf16 noise."""
    ids, jY = decoded
    jsynth = JSynthesizer(jax_test_config().replace(stft_method="fft"),
                          jparams["t2m"], jparams["ssrn"],
                          ssrn_precision=prec)
    jZ = np.asarray(jsynth.ssrn.apply(jsynth.ssrn_params,
                                      jnp.asarray(jY))[1])
    synth = Synthesizer(CFG.replace(stft_method="fft"),
                        from_jax_params(jparams["t2m"]),
                        from_jax_params(jparams["ssrn"]), device="cpu",
                        ssrn_precision=prec)
    _, Y, Z, _ = synth.synthesize_ids(ids)
    np.testing.assert_allclose(Y.numpy(), jY, rtol=0, atol=2e-5)
    np.testing.assert_allclose(Z.numpy(), jZ, rtol=0, atol=tol)
    assert synth.ssrn.cfg.compute_dtype == jsynth.ssrn.cfg.compute_dtype
    assert synth.text2mel.cfg.compute_dtype == "float32"


def test_synthesizer_defaults_to_high_and_refuses_unknown(jparams):
    p1, p2 = (from_jax_params(jparams[k]) for k in ("t2m", "ssrn"))
    assert Synthesizer(CFG, p1, p2, device="cpu").ssrn.cfg.compute_dtype \
        == "float32_high"
    with pytest.raises(ValueError, match="ssrn_precision"):
        Synthesizer(CFG, p1, p2, device="cpu", ssrn_precision="fp8")


# ----------------------------------------------------------------- (f)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from dc_tts_tpu_torch import prepro
    from dc_tts_tpu_torch.data.synthetic import make_corpus
    root = tmp_path_factory.mktemp("precision_corpus")
    texts = ["the cat sat", "a dog ran", "big red hat", "sun is up"]
    data = make_corpus(str(root / "corpus"), texts,
                       [0.06 + 0.004 * i for i in range(4)], CFG.sr)
    feats = str(root / "feats")
    prepro.main(["--tiny", "--device", "cpu", "--data", data, "--out",
                 feats])
    return data, feats


@pytest.mark.parametrize("num,dtype", [("1", "bfloat16_full"),
                                       ("2", "bfloat16")])
def test_train_cli_dtype(corpus, tmp_path, capsys, num, dtype):
    from dc_tts_tpu_torch.train.__main__ import main as train_main
    data, feats = corpus
    log = str(tmp_path / "log")
    train_main([num, "--tiny", "--device", "cpu", "--data", data,
                "--features", feats, "--logdir", log, "--dtype", dtype,
                "--max-steps", "2", "--ckpt-every", "2", "--log-every", "1",
                "--batch-size", "2", "--buckets", "1"])
    assert "model_gs_000k.npz" in os.listdir(log)
    with open(os.path.join(log, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f if r.strip()]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)


def test_synthesize_cli_ssrn_precision(tmp_path, monkeypatch):
    from dc_tts_tpu_torch import synthesize
    seen = []
    init = Synthesizer.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("ssrn_precision"))
        init(self, *a, **kw)

    monkeypatch.setattr(Synthesizer, "__init__", spy)
    sents = tmp_path / "s.txt"
    sents.write_text("header\n1. The birch canoe slid.\n")
    out = tmp_path / "wavs"
    synthesize.main(["--tiny", "--random-weights", "--device", "cpu",
                     "--sentences", str(sents), "--out", str(out),
                     "--ssrn-precision", "bf16"])
    assert seen == ["bf16"] and os.listdir(out) == ["1.wav"]
    with pytest.raises(SystemExit):
        synthesize.main(["--tiny", "--ssrn-precision", "fp8"])
