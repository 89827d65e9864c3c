"""Time sharding (SSRN, Griffin-Lim, the time-sharded synthesis) and the
two-stage pipeline against the JAX package.

Two and four gloo ranks on the CPU, each world spawned once for the module
(``run_ranks``), run every scenario; the JAX references run here, under
jit, on the virtual CPU mesh at the same shard count. Gates: time-sharded SSRN and the
block stacks 2e-5 (``tests/test_sp.py``'s), Griffin-Lim 2e-5 against JAX's
``griffin_lim_sp`` (measured 1.8e-6; ``tests/test_sp_gl.py`` holds JAX's
to its unsharded loop at 2e-3), the time-sharded synthesis Y 2e-5, Z 1e-4,
waveform 1e-4 (measured 8.8e-6: Y's 4e-6 through SSRN and 4 rounds), and
the pipeline 2e-3 against JAX's plain synthesis (``tests/test_pipeline.py``'s
gate; measured 6.6e-4 on 1 + 1 ranks, 1.5e-3 on 2 + 2: the rows a rank
vocodes change SSRN's float32 sums, which Griffin-Lim amplifies). The ranks
import this module, so JAX is imported only inside the references.
"""
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.parallel import distributed as D
from dc_tts_tpu_torch.parallel.mesh import mesh_grid

torch.set_num_threads(1)

# tests/test_sp.py's stacks, as (kind, fields) pairs the ranks rebuild
STACKS = ((("C", (3, 1, 8, "relu")), ("C", (3, 3, None, None))),
          (("HC", (3, 1)), ("HC", (3, 3))),
          (("C", (1, 1, 6)), ("D", (3,)), ("HC", (3, 1))),
          (("HC", (3, 3)),))
GL_FRAMES, GL_ITER = 256, 4


def _specs(stack, blocks):
    return tuple(getattr(blocks, kind)(*fields) for kind, fields in stack)


def _inputs():
    """Seeded inputs: SSRN's Y, the stacks' x, the Griffin-Lim magnitude
    (tests/test_sp_gl.py's: |stft| of noise, 256 frames) and ids."""
    cfg = test_config()
    rng = np.random.default_rng(0)
    Y = rng.uniform(size=(2, cfg.max_T, cfg.n_mels)).astype(np.float32)
    x = rng.standard_normal((2, 32, 4)).astype(np.float32)
    y = rng.standard_normal(GL_FRAMES * cfg.hop_length - 1
                            ).astype(np.float32) * 0.2
    from dc_tts_tpu_torch.dsp.stft import stft
    mag = stft(torch.as_tensor(y)[None], cfg.n_fft, cfg.hop_length,
               cfg.win_length).abs().numpy()
    ids = np.zeros((6, cfg.max_N), np.int32)
    for i in range(6):
        ids[i, : 5 + 2 * i] = (np.arange(5 + 2 * i) % 28) + 3
    return Y, x, mag, ids


def _sp_rank(rank, n, t2m_np, ssrn_np, stacks_np):
    from dc_tts_tpu_torch.models import blocks
    from dc_tts_tpu_torch.params import from_jax_params
    from dc_tts_tpu_torch.parallel.mesh import make_mesh
    from dc_tts_tpu_torch.parallel.sp import apply_stack_sp, ssrn_apply_sp
    from dc_tts_tpu_torch.parallel.sp_gl import griffin_lim_sp, time_slice
    from dc_tts_tpu_torch.pipeline import (PipelinedSynthesizer,
                                           synthesize_time_sharded)
    cfg = test_config()
    Y, x, mag, ids = _inputs()
    mesh = make_mesh()
    t2m, ssrn = from_jax_params(t2m_np), from_jax_params(ssrn_np)
    out = {"Z": ssrn_apply_sp(cfg, ssrn, time_slice(torch.as_tensor(Y),
                                                    mesh), mesh).numpy()}
    out["stacks"] = [apply_stack_sp(from_jax_params(p),
                                    _specs(stack, blocks),
                                    time_slice(torch.as_tensor(x), mesh),
                                    mesh, ln_eps=cfg.ln_eps).numpy()
                     for p, stack in zip(stacks_np, STACKS)]
    out["gl"] = griffin_lim_sp(time_slice(torch.as_tensor(mag), mesh),
                               cfg.replace(n_iter=GL_ITER), mesh).numpy()
    try:
        ts = synthesize_time_sharded(cfg, t2m, ssrn, ids[:2], device="cpu")
        out["time_sharded"] = [o.numpy() for o in ts]
    except ValueError as e:
        out["time_sharded"] = str(e)
    out["pipeline"] = PipelinedSynthesizer(cfg, t2m, ssrn, microbatch=4,
                                           device="cpu").synthesize_ids(ids)
    try:
        PipelinedSynthesizer(cfg, t2m, ssrn, microbatch=3, device="cpu")
    except ValueError as e:
        out["bad_microbatch"] = str(e)
    return out


@pytest.fixture(scope="module")
def jax_params():
    """Seeded parameters as numpy trees, which both packages read (made by
    the port: JAX's initialisers compile every op on first use)."""
    from dc_tts_tpu_torch.models import SSRN, Text2Mel, blocks
    from dc_tts_tpu_torch.train.optimizer import tree_map
    gen = torch.Generator().manual_seed(0)
    to_np = lambda t: tree_map(lambda x: x.numpy(), t)  # noqa: E731
    stacks = [to_np(blocks.init_stack(gen, 4, _specs(s, blocks))[0])
              for s in STACKS]
    return (to_np(Text2Mel(test_config()).init(gen)),
            to_np(SSRN(test_config()).init(gen)), stacks)


@pytest.fixture(scope="module")
def ranks(jax_params):
    return {n: D.run_ranks(_sp_rank, n, jax_params, timeout=300)
            for n in (2, 4)}


def _jax_mesh(n):
    import jax
    from dc_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
    return jax_make_mesh(data=n, model=1, devices=jax.devices()[:n])


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("n", [2, 4])
def test_ssrn_and_stacks_match_jax(jax_params, ranks, n):
    import jax.numpy as jnp
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.models import blocks as jblocks
    from dc_tts_tpu.models.ssrn import SSRN as JSSRN
    import jax
    Y, x, _, _ = _inputs()
    _, Zj = jax.jit(JSSRN(jax_test_config()).apply)(jax_params[1],
                                                    jnp.asarray(Y))
    np.testing.assert_allclose(_cat(ranks[n], "Z"), np.asarray(Zj),
                               atol=2e-5, rtol=0)
    for i, (p, stack) in enumerate(zip(jax_params[2], STACKS)):
        want = jblocks.apply_stack(p, _specs(stack, jblocks), jnp.asarray(x),
                                   ln_eps=test_config().ln_eps)
        got = np.concatenate([r["stacks"][i] for r in ranks[n]], axis=1)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_griffin_lim_matches_jax(ranks, n):
    """Every rank returns the whole waveform, JAX's at the same shard
    count."""
    import jax.numpy as jnp
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.parallel.sp_gl import griffin_lim_sp as jax_gl
    import jax
    mag = _inputs()[2]
    cfg, mesh = jax_test_config().replace(n_iter=GL_ITER), _jax_mesh(n)
    want = np.asarray(jax.jit(lambda m: jax_gl(m, cfg, mesh))(
        jnp.asarray(mag)))
    for r in ranks[n]:
        assert r["gl"].shape == want.shape
        np.testing.assert_allclose(r["gl"], want, atol=2e-5, rtol=0)


def test_griffin_lim_refuses_a_shard_too_fine():
    """96 frames of hop 8 over 4 ranks own 192 samples, under the 248 of
    the overlap halo: the same error as JAX's, before any exchange."""
    import jax.numpy as jnp
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.parallel.sp_gl import griffin_lim_sp as jax_gl
    from dc_tts_tpu_torch.parallel.sp_gl import griffin_lim_sp, time_slice
    cfg = test_config()
    mag = torch.rand(1, cfg.max_T * cfg.r, cfg.n_freq)
    mesh = mesh_grid(4, 0)
    with pytest.raises(ValueError, match="too fine") as got:
        griffin_lim_sp(time_slice(mag, mesh), cfg, mesh)
    with pytest.raises(ValueError, match="too fine") as want:
        jax_gl(jnp.asarray(mag.numpy()), jax_test_config(), _jax_mesh(4))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="divide by the shard count"):
        time_slice(mag[:, :95], mesh)


def test_time_sharded_synthesis_matches_jax(jax_params, ranks):
    """Two shards: rank 0 decodes, SSRN and Griffin-Lim run time-sharded;
    both ranks return JAX's outputs (JAX's function under jit: outside it
    the sharded stages run op by op; it decodes incrementally here, equal
    to its fused kernel within 2e-6 and faster on the CPU). Four shards at
    24 frames are too fine for the Griffin-Lim halo: every rank raises
    JAX's error."""
    import jax.numpy as jnp
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.parallel.sp_gl import griffin_lim_sp as jax_gl
    from dc_tts_tpu.pipeline import synthesize_time_sharded as jax_ts
    import jax
    jcfg = jax_test_config()
    ids = _inputs()[3][:2]
    want = [np.asarray(o) for o in jax.jit(
        lambda p1, p2, i: jax_ts(jcfg, p1, p2, i, n_shards=2,
                                 decode_mode="incremental"))(
            *jax_params[:2], ids)]
    for r in ranks[2]:
        wav, Y, Z, A = r["time_sharded"]
        np.testing.assert_array_equal(A.argmax(1), want[3].argmax(1))
        np.testing.assert_allclose(Y, want[1], atol=2e-5, rtol=0)
        np.testing.assert_allclose(Z, want[2], atol=1e-4, rtol=0)
        np.testing.assert_allclose(wav, want[0], atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="too fine") as e:
        jax_gl(jnp.zeros((2, jcfg.max_T * jcfg.r, jcfg.n_freq)), jcfg,
               _jax_mesh(4))
    assert all(r["time_sharded"] == str(e.value) for r in ranks[4])


def test_pipeline_matches_jax_plain_synthesis(jax_params, ranks):
    """1 + 1 and 2 + 2 ranks, microbatch 4, 6 rows padded to 8: every
    rank returns JAX's plain waveforms; a microbatch the stages do not
    divide raises JAX's error on every rank."""
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.pipeline import Synthesizer as JSynthesizer
    ids = _inputs()[3]
    want = np.asarray(JSynthesizer(jax_test_config().replace(
        stft_method="fft"), *jax_params[:2]
                                   ).synthesize_ids(ids)[0])
    for n in (2, 4):
        for r in ranks[n]:
            assert r["pipeline"].shape == want.shape
            np.testing.assert_allclose(r["pipeline"], want, atol=2e-3,
                                       rtol=0)
    assert "bad_microbatch" not in ranks[2][0]
    assert all(r["bad_microbatch"] ==
               "--microbatch 3 must be divisible by both stage sizes (2 "
               "and 2 of 4 ranks)" for r in ranks[4])
