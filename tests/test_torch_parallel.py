"""The port's rank grid and data parallelism against the JAX package.

Four gloo ranks on the CPU, spawned once for the module (``run_ranks``:
one thread each, a file store under a temporary directory), run every
multi-rank scenario: Text2Mel and SSRN data-parallel steps on a global
batch of 8 with uneven text and mel lengths, data-parallel synthesis of 6
rows padded to 8, whole and in chunks of 3, and the training CLI on a
seeded corpus. The references run here, in this process: JAX's
single-device step on the global batch (loss rel 1e-5, parameters 1e-4:
``tests/test_sharding.py``'s gates), the port's one-rank step and CLI
(1e-5), and JAX's unsharded Synthesizer (Y 1e-4, waveforms 1e-3). The
ranks import this module, so JAX is imported only inside the
references.
"""
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.parallel import distributed as D
from dc_tts_tpu_torch.parallel.mesh import (assert_sharded_like, make_mesh,
                                            mesh_grid, param_partition_specs,
                                            prefetch_to_device, shard_batch)

torch.set_num_threads(1)

CFG_KW = dict(B=8, warmup_steps=4.0)
WORLD = 4


def _batches():
    """The global batches (numpy, seeded): Text2Mel's with uneven lengths,
    rank 0's rows short and rank 3's full, and SSRN's."""
    cfg = test_config().replace(**CFG_KW)
    rng = np.random.default_rng(0)
    t2m = {"texts": rng.integers(1, cfg.vocab_size, (8, cfg.max_N)
                                 ).astype(np.int32),
           "mels": rng.uniform(size=(8, cfg.max_T, cfg.n_mels)
                               ).astype(np.float32),
           "text_lens": np.array([3, 4, 8, 10, 14, 16, 20, 20], np.int32),
           "mel_lens": np.array([5, 6, 10, 12, 18, 20, 24, 24], np.int32)}
    ssrn = {"mels": rng.uniform(size=(8, cfg.max_T, cfg.n_mels)
                                ).astype(np.float32),
            "mags": rng.uniform(size=(8, cfg.max_T * cfg.r, cfg.n_freq)
                                ).astype(np.float32)}
    ids = np.zeros((6, cfg.max_N), np.int32)
    for i in range(6):
        ids[i, : 5 + 2 * i] = (np.arange(5 + 2 * i) % 28) + 3
    return t2m, ssrn, ids


def _torch_batch(batch):
    return {k: torch.as_tensor(v.astype(np.int64) if k == "texts" else v)
            for k, v in batch.items()}


def _step(net, cfg, params_np, batch, group, mesh=None):
    """One port step from the given parameters -> (metrics, parameters)
    as numpy; under a mesh on this rank's rows, after broadcasting."""
    from dc_tts_tpu_torch.params import from_jax_params, requires_grad
    from dc_tts_tpu_torch.train import steps as S
    from dc_tts_tpu_torch.train.optimizer import init_opt_state, tree_leaves
    params = from_jax_params(params_np)
    requires_grad(params)
    state = S.TrainState(params, init_opt_state(params), 0)
    if mesh is not None:
        S.replicate_state(state, mesh)
        batch = shard_batch(batch, mesh)
    make = S.make_text2mel_step if net == "t2m" else S.make_ssrn_step
    state, m = make(cfg, group=group)(state, _torch_batch(batch))
    return ({k: float(v) for k, v in m.items()},
            [t.detach().numpy() for t in tree_leaves(state.params)])


def _train_cli(corpus, logdir):
    """Two Text2Mel steps of the training CLI on the corpus, B=4."""
    from dc_tts_tpu_torch.train.__main__ import main
    main(["1", "--tiny", "--device", "cpu", "--data", corpus[0],
          "--features", corpus[1], "--logdir", logdir, "--max-steps", "2",
          "--batch-size", "4", "--buckets", "1", "--log-every", "1",
          "--ckpt-every", "100"])


def _dp_rank(rank, n, t2m_np, ssrn_np, t2m_batch, ssrn_batch, ids, corpus):
    from dc_tts_tpu_torch.params import from_jax_train_state
    from dc_tts_tpu_torch.pipeline import Synthesizer
    from dc_tts_tpu_torch.train import steps as S
    cfg = test_config().replace(**CFG_KW)
    mesh = make_mesh()
    group = mesh.groups["data"]
    own = S.text2mel_grads(cfg, from_jax_train_state(t2m_np, ())[0],
                           _torch_batch(shard_batch(t2m_batch, mesh))
                           )[0]["loss"]
    out = {"own_loss": float(own),
           "t2m": _step("t2m", cfg, t2m_np, t2m_batch, group, mesh),
           "ssrn": _step("ssrn", cfg, ssrn_np, ssrn_batch, group, mesh)}
    from dc_tts_tpu_torch.params import from_jax_params
    synth = Synthesizer(test_config(), from_jax_params(t2m_np),
                        from_jax_params(ssrn_np), device="cpu", mesh=mesh)
    out["synth"] = [o.numpy() for o in synth.synthesize_ids(ids)]
    out["chunked"] = synth.synthesize_ids_chunked(ids, chunk=3)
    _train_cli(corpus, corpus[2] + "-dp")
    return out


@pytest.fixture(scope="module")
def params():
    """Seeded parameters as numpy trees, which both packages read (made by
    the port: JAX's initialisers compile every op on first use)."""
    from dc_tts_tpu_torch.models import SSRN, Text2Mel
    from dc_tts_tpu_torch.train.optimizer import tree_map
    gen = torch.Generator().manual_seed(0)
    return tuple(tree_map(lambda x: x.numpy(), net(test_config()).init(gen))
                 for net in (Text2Mel, SSRN))


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
def ranks(params, corpus):
    t2m_batch, ssrn_batch, ids = _batches()
    return D.run_ranks(_dp_rank, WORLD, (*params, t2m_batch, ssrn_batch,
                                         ids, corpus), timeout=300)


# ---------------------------------------------------------------------------
# the grid, as pure functions


def test_rank_grid_matches_jax_mesh():
    """Ranks sit on the grid as devices on JAX's mesh (device i is rank
    i); an oversize grid raises as JAX's make_mesh does."""
    from dc_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
    m = mesh_grid(8, 5)
    assert m.shape == {"data": 8, "model": 1}
    assert m.coords == {"data": 5, "model": 0}
    for data, model in ((8, 1), (4, 2), (2, 4), (1, 8)):
        want = np.vectorize(lambda d: d.id)(
            jax_make_mesh(data=data, model=model).devices)
        for rank in range(8):
            m = mesh_grid(8, rank, data, model)
            i, j = m.coords["data"], m.coords["model"]
            assert m.shape == {"data": data, "model": model}
            assert want[i, j] == rank
            assert m.ranks["data"] == tuple(want[:, j])
            assert m.ranks["model"] == tuple(want[i, :])
    assert mesh_grid(8, 6, data=3).coords is None    # left out
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        mesh_grid(8, 0, data=8, model=2)
    # without a process group the mesh is one rank that exchanges nothing
    assert make_mesh().shape == {"data": 1, "model": 1}
    assert make_mesh().groups == {"data": None, "model": None}
    assert D.process_info() == {"process_index": 0, "process_count": 1,
                                "local_devices": 1, "global_devices": 1}


@pytest.mark.parametrize("data,model", [(4, 2), (1, 8)])
def test_param_partition_specs_match_jax(params, data, model):
    import jax
    from jax.sharding import PartitionSpec as P
    from dc_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dc_tts_tpu.parallel.mesh import param_partition_specs as jax_specs
    from dc_tts_tpu_torch.params import from_jax_params
    from dc_tts_tpu_torch.train.optimizer import tree_leaves
    jmesh = jax_make_mesh(data=data, model=model)
    mesh = mesh_grid(8, 0, data, model)
    for p in params:
        want = jax.tree.leaves(jax_specs(p, jmesh),
                               is_leaf=lambda x: isinstance(x, P))
        got = _spec_leaves(param_partition_specs(from_jax_params(p), mesh))
        assert len(got) == len(tree_leaves(from_jax_params(p)))
        assert got == [tuple(s) for s in want]
    assert ("model" in {a for s in got for a in s}) == (model > 1)


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def test_shard_batch_prefetch_and_sharding_check():
    """Each rank its contiguous rows; prefetch hands out every batch in
    order (the last one too); a local shape off its spec is named."""
    batches = [{"x": np.arange(24, dtype=np.float32).reshape(8, 3) + k,
                "i": np.full((8,), k, np.int32)} for k in range(3)]
    for rank in range(4):
        mesh = mesh_grid(4, rank)
        got = shard_batch(batches[0], mesh)
        np.testing.assert_array_equal(got["x"],
                                      batches[0]["x"][2 * rank: 2 * rank + 2])
        out = list(prefetch_to_device(iter(batches), "cpu", mesh))
        assert [int(b["i"][0]) for b in out] == [0, 1, 2]
        assert all(b["x"].shape == (2, 3) for b in out)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": np.zeros((6, 2))}, mesh_grid(4, 0))
    mesh = mesh_grid(8, 0, 4, 2)
    specs = {"a": ("data",), "w": (None, None, "model")}
    shapes = {"a": (8, 4), "w": (3, 5, 6)}
    assert_sharded_like({"a": torch.zeros(2, 4), "w": torch.zeros(3, 5, 3)},
                        specs, mesh, shapes)
    with pytest.raises(AssertionError, match=r"sharding mismatch at \['w'\]"):
        assert_sharded_like({"a": torch.zeros(2, 4),
                             "w": torch.zeros(3, 5, 6)}, specs, mesh, shapes)


# ---------------------------------------------------------------------------
# four ranks


@pytest.mark.parametrize("net", ["t2m", "ssrn"])
def test_data_parallel_step_matches_global_batch(params, ranks, net):
    """Every rank applies the update of the global batch: JAX's
    single-device step on it, and the port's one-rank step."""
    import jax
    import jax.numpy as jnp
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.train import steps as JS
    from dc_tts_tpu.train.optimizer import make_optimizer
    t2m_batch, ssrn_batch, _ = _batches()
    batch = t2m_batch if net == "t2m" else ssrn_batch
    p = params[0] if net == "t2m" else params[1]
    jcfg = jax_test_config().replace(**CFG_KW)
    state_cls, make = ((JS.Text2MelTrainState, JS.make_text2mel_step)
                       if net == "t2m" else
                       (JS.SSRNTrainState, JS.make_ssrn_step))
    state = state_cls(p, make_optimizer(jcfg).init(p),
                      jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(make(jcfg))(state, batch, jax.random.PRNGKey(2))
    want = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
    one_m, one_p = _step(net, test_config().replace(**CFG_KW), p, batch,
                         None)
    for r in ranks:
        m, got = r[net]
        assert m.keys() == {k for k in jm}
        for k in m:
            assert m[k] == pytest.approx(float(jm[k]), rel=1e-5), k
            assert m[k] == pytest.approx(one_m[k], rel=1e-5), k
        assert len(got) == len(want)
        for g, w, o in zip(got, want, one_p):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
            np.testing.assert_allclose(g, o, atol=1e-5, rtol=0)
    if net == "t2m":
        # the lengths differ over the ranks, so a mean of each rank's own
        # loss is not the global batch's loss
        own = np.mean([r["own_loss"] for r in ranks])
        assert abs(own - ranks[0]["t2m"][0]["loss"]) > 1e-3


def test_data_parallel_synthesis_matches_jax(params, ranks):
    """6 rows padded to 8 over 4 ranks, and chunks of 3 rounded up to 4:
    every rank returns the whole batch, equal to JAX's unsharded run."""
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.pipeline import Synthesizer as JSynthesizer
    ids = _batches()[2]
    jwav, jY, _, _ = (np.asarray(o) for o in JSynthesizer(
        jax_test_config().replace(stft_method="fft"), *params
    ).synthesize_ids(ids))
    for r in ranks:
        wav, Y, Z, A = r["synth"]
        assert wav.shape == jwav.shape and Z.shape[0] == A.shape[0] == 6
        np.testing.assert_allclose(Y, jY, atol=1e-4, rtol=0)
        np.testing.assert_allclose(wav, jwav, atol=1e-3, rtol=0)
        assert r["chunked"].shape == jwav.shape
        np.testing.assert_allclose(r["chunked"], jwav, atol=1e-3, rtol=0)
        np.testing.assert_array_equal(wav, ranks[0]["synth"][0])


def test_train_cli_data_parallel_matches_one_rank(ranks, corpus):
    """train --data-parallel (every rank by default) on 4 ranks: rank 0's
    checkpoint after 2 steps equals the one-rank CLI's on the same seeded
    batches (the loader hands them out in the shuffle's order)."""
    _train_cli(corpus, corpus[2] + "-one")
    with np.load(corpus[2] + "-dp/model_gs_000k.npz") as dp, \
            np.load(corpus[2] + "-one/model_gs_000k.npz") as one:
        assert dp.files == one.files and int(dp["__step__"]) == 2
        for k in one.files:
            np.testing.assert_allclose(dp[k], one[k], atol=1e-5, rtol=0,
                                       err_msg=k)
