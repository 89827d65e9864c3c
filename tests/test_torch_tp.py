"""Tensor parallelism (``dc_tts_tpu_torch/parallel/tp.py``) against the JAX
package's GSPMD sharding and the port's one-rank step.

Two gloo ranks on the CPU (a data 1 x model 2 grid), spawned once for the
module (``run_ranks``: one thread each, a file store under a temporary
directory), run: ``shard_params`` -> ``gather_params`` round trips;
Text2Mel's teacher-forced forward and SSRN's on this rank's slices; one
sharded conv and one deconv with their gradients; two train steps of both
networks in five routes (float32; K4 under ``use_pallas``, its plain
version here; ``bfloat16`` with K4; ``remat``; ``bfloat16_full`` with
dropout); the training CLI under ``--model-parallel 2`` with checkpoints and
plots, resumed once, and refused on a grid larger than the world. Four
ranks run the round trips at model 4 and a data 2 x model 2 step.

The references run here, in this process: JAX's forward on ``shard_params``
over a data 1 x model 2 mesh of the 8 CPU devices under ``jit`` (1e-5),
and the port's one-rank step, blocks and CLI on the same inputs: the loss
within 1e-6 relative; float32 gradients within 1e-5 x each leaf's max and
parameters after two steps within that plus a tenth of the steps' learning
rates; the bf16 routes at bf16 noise (``_assert_step_close`` says why);
each conv, deconv and K4 block within 1e-6 x its max.
Inputs are seeded with numpy. The ranks import this module, so JAX is
imported only inside the references.
"""
import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.parallel import distributed as D
from dc_tts_tpu_torch.parallel.mesh import (assert_sharded_like, make_mesh,
                                            mesh_grid, param_partition_specs,
                                            shard_batch)
from dc_tts_tpu_torch.parallel.tp import gather_params, shard_params

torch.set_num_threads(1)

CFG_KW = dict(B=4, warmup_steps=4.0)
ROUTES = {"float32": {},
          "pallas": dict(use_pallas=True),
          "bfloat16_pallas": dict(compute_dtype="bfloat16", use_pallas=True),
          "remat": dict(remat=True),
          "bfloat16_full_dropout": dict(compute_dtype="bfloat16_full",
                                        dropout_rate=0.2)}
SEED = 1


def _cfg(route="float32"):
    return test_config().replace(**CFG_KW, **ROUTES[route])


def _batches():
    """The global batches (numpy, seeded): Text2Mel's with uneven lengths,
    and SSRN's."""
    cfg = _cfg()
    rng = np.random.default_rng(0)
    t2m = {"texts": rng.integers(1, cfg.vocab_size, (4, cfg.max_N)
                                 ).astype(np.int32),
           "mels": rng.uniform(size=(4, cfg.max_T, cfg.n_mels)
                               ).astype(np.float32),
           "text_lens": np.array([5, 11, 16, 20], np.int32),
           "mel_lens": np.array([7, 13, 24, 20], np.int32)}
    ssrn = {"mels": rng.uniform(size=(4, cfg.max_T, cfg.n_mels)
                                ).astype(np.float32),
            "mags": rng.uniform(size=(4, cfg.max_T * cfg.r, cfg.n_freq)
                                ).astype(np.float32)}
    return {"t2m": t2m, "ssrn": ssrn}


def _torch_batch(batch):
    return {k: torch.as_tensor(v.astype(np.int64) if k == "texts" else v)
            for k, v in batch.items()}


def _leaves_np(tree):
    from dc_tts_tpu_torch.train.optimizer import tree_leaves
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def _train(net, route, params_np, batch, mesh=None):
    """The step-1 loss and gradients (summed over the data group), then
    the parameters after two steps, from the given whole parameters: one
    rank without a mesh, else this rank's part of the grid -> (loss, whole
    gradients, whole parameters) as numpy."""
    from dc_tts_tpu_torch.params import from_jax_params, requires_grad
    from dc_tts_tpu_torch.train import steps as S
    from dc_tts_tpu_torch.train.optimizer import (init_opt_state,
                                                  tree_unflatten)
    cfg = _cfg(route)
    params = from_jax_params(params_np)
    requires_grad(params)
    state = S.TrainState(params, init_opt_state(params), 0)
    group = model_group = None
    shard = 0
    if mesh is not None:
        group, model_group = mesh.groups["data"], mesh.groups["model"]
        shard = mesh.coords["data"]
        state = S.shard_state(state, mesh)
        batch = shard_batch(batch, mesh)
    batch = _torch_batch(batch)
    grads_fn, make = ((S.text2mel_grads, S.make_text2mel_step) if net == "t2m"
                      else (S.ssrn_grads, S.make_ssrn_step))
    gen = torch.Generator().manual_seed(S.step_seed(SEED, 0, shard))
    metrics, grads = grads_fn(cfg, state.params, batch, gen, group,
                              model_group)
    loss = metrics["loss"]
    D.all_reduce_sum_(grads + [loss], group)
    grads = tree_unflatten(state.params, grads)
    step = make(cfg, seed=SEED, group=group, model_group=model_group)
    for _ in range(2):
        state, _ = step(state, batch, gen)
    if mesh is not None:
        grads = gather_params(grads, mesh)
        state = S.TrainState(gather_params(state.params, mesh), None, 2)
    return float(loss), _leaves_np(grads), _leaves_np(state.params)


def _round_trips(mesh, params_np):
    """Whether shard_params -> gather_params gives back every parameter and
    Adam moment bitwise; the local shapes are checked against the specs."""
    from dc_tts_tpu_torch.params import from_jax_params
    from dc_tts_tpu_torch.train.optimizer import init_opt_state, tree_map
    out = {}
    for net, p in params_np.items():
        full = from_jax_params(p)
        opt = init_opt_state(full)
        opt[1]["mu"] = tree_map(lambda t: t + 1.0, full)   # not all zero
        shards = shard_params(full, mesh)
        assert_sharded_like(shards, param_partition_specs(full, mesh), mesh,
                            full)
        back = gather_params(shards, mesh)
        moments = gather_params(shard_params(opt, mesh), mesh)
        out[net] = (all(np.array_equal(a, b) for a, b in
                        zip(_leaves_np(back), _leaves_np(full)))
                    and all(np.array_equal(a, b) for a, b in
                            zip(_leaves_np(moments), _leaves_np(opt))))
    return out


def _block_case(kind, dtype, mesh=None):
    """One conv (K 3, rate 2) or deconv of 8 -> 12 channels, or one HC
    block (8 -> 16 -> 8) through K4 in training, on seeded inputs: (y, dx,
    dW, db) of sum(y * gy), as numpy; dW this rank's slice under a mesh."""
    from dc_tts_tpu_torch.models import blocks as B
    from dc_tts_tpu_torch.models import layers as L
    rng = np.random.default_rng(7)
    cout = 16 if kind == "hc-k4" else 12
    x = torch.tensor(rng.standard_normal((2, 6, 8)), dtype=torch.float32,
                     requires_grad=True)
    p = {"w": torch.tensor(rng.standard_normal((3, 8, cout)),
                           dtype=torch.float32),
         "b": torch.tensor(rng.standard_normal(cout), dtype=torch.float32)}
    gy = torch.tensor(rng.standard_normal(
        (2, 12 if kind == "deconv" else 6, 8 if kind == "hc-k4" else 12)),
        dtype=torch.float32)
    group = None
    if mesh is not None:
        p, group = shard_params(p, mesh), mesh.groups["model"]
    for t in p.values():
        t.requires_grad_(True)
    dt = torch.bfloat16 if dtype == "bfloat16" else None
    if kind == "conv":
        y = L.conv1d(p, x, size=3, rate=2, dtype=dt, group=group)
    elif kind == "deconv":
        y = L.conv1d_transpose(p, x, dt, group=group)
    else:
        ln = {"gamma": torch.linspace(0.5, 1.5, 8), "beta": torch.zeros(8)}
        y = B.apply_block({"conv": p, "ln1": ln, "ln2": ln}, B.HC(3, 2), x,
                          ln_eps=1e-8, train=True, use_pallas=True, dtype=dt,
                          model_group=group)
    (y * gy).sum().backward()
    return tuple(t.detach().numpy().copy()
                 for t in (y, x.grad, p["w"].grad, p["b"].grad))


BLOCK_CASES = [(k, d) for k in ("conv", "deconv", "hc-k4")
               for d in ("float32", "bfloat16")]


def _forward(params_np, batch_t2m, batch_ssrn, mesh=None):
    """Text2Mel's teacher-forced forward and SSRN's (on this rank's slices
    under a mesh), as numpy."""
    from dc_tts_tpu_torch.models import SSRN, Text2Mel
    from dc_tts_tpu_torch.params import from_jax_params
    from dc_tts_tpu_torch.train.steps import teacher_forcing_shift
    cfg = _cfg()
    t2m, ssrn = (from_jax_params(params_np[k]) for k in ("t2m", "ssrn"))
    model_group = None
    if mesh is not None:
        t2m, ssrn = shard_params(t2m, mesh), shard_params(ssrn, mesh)
        model_group = mesh.groups["model"]
    b = _torch_batch(batch_t2m)
    with torch.no_grad():
        out = Text2Mel(cfg, model_group).apply(
            t2m, b["texts"], teacher_forcing_shift(b["mels"]))
        _, Z = SSRN(cfg, model_group).apply(
            ssrn, torch.as_tensor(batch_ssrn["mels"]))
    return [t.numpy() for t in out] + [Z.numpy()]


def _cli(corpus, logdir, steps, *extra):
    """The Text2Mel training CLI on the corpus, B=4, a checkpoint and its
    plots every step."""
    from dc_tts_tpu_torch.train.__main__ import main
    main(["1", "--tiny", "--device", "cpu", "--data", corpus[0],
          "--features", corpus[1], "--logdir", logdir, "--max-steps",
          str(steps), "--batch-size", "4", "--buckets", "1", "--log-every",
          "1", "--ckpt-every", "1", *extra])


def _tp_rank(rank, n, params_np, batches, corpus):
    import torch.distributed as dist
    mesh = make_mesh(data=1, model=2)
    mg = mesh.groups["model"]
    out = {"round_trip": _round_trips(mesh, params_np),
           "forward": _forward(params_np, batches["t2m"], batches["ssrn"],
                               mesh),
           "blocks": {c: _block_case(*c, mesh) for c in BLOCK_CASES},
           "train": {(net, route): _train(net, route, params_np[net],
                                          batches[net], mesh)
                     for net in ("t2m", "ssrn") for route in ROUTES}}

    # to 2 steps; then, from a copy of that checkpoint, to 3
    logdir = corpus[2] + "-tp"
    _cli(corpus, logdir, 2, "--model-parallel", "2")
    if rank == 0:
        shutil.copytree(logdir, logdir + "-resumed")
    dist.barrier()
    _cli(corpus, logdir + "-resumed", 3, "--model-parallel", "2")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
        _cli(corpus, corpus[2] + "-refused", 1, "--model-parallel", "3")
    out["refusal"] = err.getvalue()
    return out


def _grid_rank(rank, n, params_np, batches):
    return {"round_trip": _round_trips(make_mesh(data=1, model=4),
                                       params_np),
            "train": {net: _train(net, "float32", params_np[net],
                                  batches[net], make_mesh(data=2, model=2))
                      for net in ("t2m", "ssrn")}}


@pytest.fixture(scope="module")
def params():
    """Seeded parameters as numpy trees, which both packages read."""
    from dc_tts_tpu_torch.models import SSRN, Text2Mel
    from dc_tts_tpu_torch.train.optimizer import tree_map
    gen = torch.Generator().manual_seed(0)
    return {k: tree_map(lambda x: x.numpy(), net(test_config()).init(gen))
            for k, net in (("t2m", Text2Mel), ("ssrn", SSRN))}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded corpus of 8 utterances with prepro's features, and a
    logdir prefix."""
    from dc_tts_tpu_torch.data.dataset import prepro_corpus
    from dc_tts_tpu_torch.data.synthetic import make_corpus
    root = tmp_path_factory.mktemp("corpus")
    cfg = test_config()
    data = make_corpus(str(root / "data"), [
        "the cat sat", "a dog ran far", "big red hat", "sun is up",
        "go home now", "it is cold", "we can go", "no way out"],
        [0.05 + 0.01 * i for i in range(8)], cfg.sr, seed=3)
    prepro_corpus(cfg.replace(data=data), str(root / "feats"),
                  progress=False)
    return data, str(root / "feats"), str(root / "logdir")


@pytest.fixture(scope="module")
def tp(params, corpus):
    return D.run_ranks(_tp_rank, 2, (params, _batches(), corpus),
                       timeout=300)


@pytest.fixture(scope="module")
def grid(params):
    return D.run_ranks(_grid_rank, 4, (params, _batches()), timeout=300)


def _lr_sum(cfg, steps):
    """The learning rates of the first ``steps`` updates, summed."""
    from dc_tts_tpu_torch.train.optimizer import noam_lr
    return sum(float(noam_lr(s, cfg.lr, cfg.warmup_steps))
               for s in range(steps))


def _assert_params_close(got, want, lr_sum, names=None):
    """Parameters after some steps: within 1e-5 x each leaf's max plus a
    tenth of the steps' summed learning rates. Adam divides each element's
    first moment by the root of its own second moment, so an element whose
    gradient is within float32 summation noise of zero (or of cancelling
    over the two steps) moves by an update of any size up to the learning
    rate: the difference is counted in learning rates, as a bias that
    started at 0 has moved by little more than them."""
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape
        np.testing.assert_allclose(
            x, y, rtol=0, atol=1e-5 * float(np.abs(y).max()) + 0.1 * lr_sum,
            err_msg=names[i] if names else f"parameter leaf {i}")


def _assert_step_close(got, want, route):
    """The loss within 1e-6 relative (the forward is the one-rank forward:
    each rank's columns take the same products). Float32 routes: the
    step-1 gradients within 1e-5 x each leaf's max, the parameters after
    two steps as ``_assert_params_close``. bf16 routes: a model rank sums
    the float32 partial products of a sharded conv's input gradient before
    rounding it to bf16, as one rank rounds its whole product; a float32
    sum taken in another order flips a bf16 rounding now and then (2^-8 of
    that element), which the blocks below carry on, so the gradients are
    held at bf16 noise (relative L2 over all leaves 3e-2, each leaf 5e-2 x
    its max; measured up to 7.1e-3 and 1.9e-2), every conv alone tightly
    (``test_sharded_block_gradients``), and the parameters after two steps
    only finite: Adam's per-element normalisation makes such noise updates
    of either sign."""
    (loss, grads, params), (wloss, wgrads, wparams) = got, want
    assert loss == pytest.approx(wloss, rel=1e-6)
    assert len(grads) == len(wgrads)
    if "bfloat16" in route:
        num = sum(float(np.sum((x.astype(np.float64) - y) ** 2))
                  for x, y in zip(grads, wgrads))
        den = sum(float(np.sum(np.square(y, dtype=np.float64)))
                  for y in wgrads)
        assert (num / den) ** 0.5 <= 3e-2
        tol_leaf = 5e-2
        assert all(np.isfinite(x).all() for x in params)
    else:
        tol_leaf = 1e-5
        _assert_params_close(params, wparams, _lr_sum(_cfg(route), 2))
    for i, (x, y) in enumerate(zip(grads, wgrads)):
        assert x.shape == y.shape
        np.testing.assert_allclose(
            x, y, rtol=0, atol=tol_leaf * max(float(np.abs(y).max()), 1e-30),
            err_msg=f"gradient leaf {i}")


# ---------------------------------------------------------------------------
# (a) the partition and its round trip


@pytest.mark.parametrize("model", [2, 4])
def test_shard_gather_round_trip(params, tp, grid, model):
    """Every parameter and Adam moment back bitwise at model 2 and 4, the
    local shapes those of the specs (checked on the ranks)."""
    ranks = tp if model == 2 else grid
    for r in ranks:
        assert r["round_trip"] == {"t2m": True, "ssrn": True}


@pytest.mark.parametrize("model", [2, 4])
def test_partition_specs_match_jax(params, model):
    """The specs are JAX's for the same trees, SSRN's n_freq-wide convs
    (129 channels) replicated."""
    import jax
    from jax.sharding import PartitionSpec as P
    from dc_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dc_tts_tpu.parallel.mesh import param_partition_specs as jax_specs
    from dc_tts_tpu_torch.params import from_jax_params
    from dc_tts_tpu_torch.train.optimizer import tree_leaves
    jmesh = jax_make_mesh(data=1, model=model)
    mesh = mesh_grid(model, 0, 1, model)
    for net, p in params.items():
        want = [tuple(s) for s in jax.tree.leaves(
            jax_specs(p, jmesh), is_leaf=lambda x: isinstance(x, P))]
        got = param_partition_specs(from_jax_params(p), mesh)
        assert _spec_leaves(got) == want
        assert len(want) == len(tree_leaves(from_jax_params(p)))
    last = got["stack"][-1]["conv"]["w"]
    assert params["ssrn"]["stack"][-1]["conv"]["w"].shape[-1] == 129
    assert last == ()
    assert got["stack"][0]["conv"]["w"] == (None, None, "model")


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# (b) the forward against JAX's sharded forward


def test_tp_forward_matches_jax_sharded(params, tp):
    """Text2Mel's teacher-forced apply and SSRN's forward on two model
    ranks against JAX's on shard_params over a 1 x 2 mesh, under jit: Y,
    the alignments and Z at 1e-5, the logits (up to ~3 before the sigmoid)
    at 1e-5 x their max, the attention cursors equal; and within 1e-6 of
    the port's one-rank forward."""
    import jax
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.models.ssrn import SSRN as JSSRN
    from dc_tts_tpu.models.text2mel import Text2Mel as JText2Mel
    from dc_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dc_tts_tpu.parallel.mesh import shard_params as jax_shard_params
    from dc_tts_tpu.train.steps import teacher_forcing_shift
    b = _batches()
    jcfg = jax_test_config().replace(**CFG_KW)
    jmesh = jax_make_mesh(data=1, model=2)
    want = list(jax.jit(JText2Mel(jcfg).apply)(
        jax_shard_params(params["t2m"], jmesh), b["t2m"]["texts"],
        teacher_forcing_shift(b["t2m"]["mels"])))
    want.append(jax.jit(JSSRN(jcfg).apply)(
        jax_shard_params(params["ssrn"], jmesh), b["ssrn"]["mels"])[1])
    one = _forward(params, b["t2m"], b["ssrn"])
    for r in tp:
        got = r["forward"]
        for name, g, w, o in zip(("logits", "Y", "alignments",
                                  "max_attentions", "Z"), got, want, one):
            w = np.asarray(w)
            assert g.shape == w.shape, name
            if name == "max_attentions":
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, o)
                continue
            scale = float(np.abs(w).max()) if name == "logits" else 1.0
            np.testing.assert_allclose(g, w, atol=1e-5 * scale, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(g, o, atol=1e-6, rtol=0, err_msg=name)
        for g, o in zip(got, tp[0]["forward"]):
            np.testing.assert_array_equal(g, o)


# ---------------------------------------------------------------------------
# (c) and (d): train steps against the one-rank step


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_tp_step_matches_one_rank(params, tp, net, route):
    """Two model ranks: the step-1 loss and gradients and the parameters
    after two steps are the one-rank step's, and bitwise equal on both
    ranks (with dropout: the same masks on both)."""
    want = _train(net, route, params[net], _batches()[net])
    got = [r["train"][(net, route)] for r in tp]
    for g in got:
        _assert_step_close(g, want, route)
    assert got[0][0] == got[1][0]
    for a, b in zip(got[0][1] + got[0][2], got[1][1] + got[1][2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_data_by_model_step_matches_one_rank(params, grid, net):
    """Four ranks, data 2 x model 2, each data row its half of the global
    batch: the one-rank step on the whole batch."""
    want = _train(net, "float32", params[net], _batches()[net])
    for r in grid:
        _assert_step_close(r["train"][net], want, "float32")


# ---------------------------------------------------------------------------
# (e) one conv and one deconv


@pytest.mark.parametrize("case", BLOCK_CASES, ids=["-".join(c)
                                                   for c in BLOCK_CASES])
def test_sharded_block_gradients(tp, case):
    """y and dx within 1e-6 x their max of the unsharded conv's (HC block
    through K4: its weight gathered whole), dW this rank's slice of the
    unsharded dW and db whole. A gather that summed its gradient would
    double dW; without the input's sum over the group dx would miss the
    other rank's dy_j @ W_j^T."""
    y, dx, dw, db = _block_case(*case)
    n = dw.shape[-1] // 2
    for j, r in enumerate(tp):
        ty, tdx, tdw, tdb = r["blocks"][case]
        assert tdw.shape == (3, 8, n) and tdb.shape == db.shape
        for got, want in ((ty, y), (tdx, dx), (tdw, dw[..., j * n:
                                                        (j + 1) * n]),
                          (tdb, db)):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# (f), (g): checkpoints and the CLI


def test_cli_model_parallel_checkpoints(tp, corpus):
    """train --model-parallel 2 on two ranks runs to its end with a
    checkpoint and plots every step: its checkpoint is the one-rank run's
    file (the same keys, whole arrays; the parameters within the step's
    gate, Adam's moments within 1e-3 x each leaf's max, the counts equal:
    the moments are of gradients clipped to [-1, 1], which caps their max
    but not their differences, 1e-5 of a gradient leaf whose max is ~10),
    and resumed from it (restored whole, then sliced) it continues as a
    one-rank run resumed from the same file does."""
    _cli(corpus, corpus[2] + "-one", 2)
    shutil.copytree(corpus[2] + "-tp", corpus[2] + "-one-resumed")
    _cli(corpus, corpus[2] + "-one-resumed", 3)
    cfg = test_config()
    for suffix, steps in (("", 2), ("-resumed", 3)):
        with np.load(corpus[2] + "-tp" + suffix + "/model_gs_000k.npz") as t, \
                np.load(corpus[2] + "-one" + suffix
                        + "/model_gs_000k.npz") as o:
            assert t.files == o.files
            assert int(t["__step__"]) == int(o["__step__"]) == steps
            params = [k for k in o.files if k.startswith("params//")]
            _assert_params_close([t[k] for k in params],
                                 [o[k] for k in params],
                                 _lr_sum(cfg, steps), params)
            for k in o.files:
                assert t[k].shape == o[k].shape, k
                if k.endswith("count") or k == "__step__":
                    np.testing.assert_array_equal(t[k], o[k])
                elif not k.startswith("params//"):
                    np.testing.assert_allclose(
                        t[k], o[k], rtol=0,
                        atol=1e-3 * max(float(np.abs(o[k]).max()), 1e-30),
                        err_msg=k)
    assert any(f.startswith("alignment") and f.endswith(".png")
               for f in os.listdir(corpus[2] + "-tp"))


def test_cli_refuses_grid_larger_than_world(tp):
    assert all("--data-parallel 1 x --model-parallel 3 needs 3 ranks; this "
               "run has 2" in r["refusal"] for r in tp)
