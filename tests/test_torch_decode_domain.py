"""K1's domain: every config the JAX package's ``fused_decode`` runs, checked
on the CPU.

JAX's decode kernel is bounded only by VMEM. The port's kernel takes any
d, n_mels, window and layer width: its weight slots pad each tap's depth to
the 16-byte copy width with zero weights (``kernel_slot``, ``layer_depth``),
its attention walks the window in register chunks of keys and the features
in chunks of 256, and its layer norms take rows wider than a lane's
registers in a second loop. Only shared memory and co-residency refuse a
config. Here, at ``test_config()`` widths past each limit the kernel once
had (d % 4, n_mels % 4, d > 256, a window > 4, a C layer wider than 512;
d = 17 also puts C layers' norm parameters off 16-byte boundaries):
the host-side plan and packing, and the plain version against JAX's
interpret-mode kernel at 2e-5 (tests/test_torch_text2mel.py's tolerance)
with identical cursors. Also the plain version's forced cursor trajectory,
which the card's checks use to compare every step of a run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.models.text2mel import Text2Mel as JText2Mel

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.models import Text2Mel
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.params import from_jax_params

torch.set_num_threads(1)

# one config past each old limit of the kernel
PAST = {"d17": dict(d=17), "d18": dict(d=18), "d264": dict(d=264),
        "n_mels10": dict(n_mels=10),
        "win5": dict(attention_win_size=5), "win9": dict(attention_win_size=9),
        "c520": dict(n_mels=520)}


def _ids(cfg, rows=3):
    ids = np.zeros((rows, cfg.max_N), np.int32)
    for i in range(rows):
        ids[i, : 6 + 3 * i] = (np.arange(6 + 3 * i) % 28) + 3
    return ids


def _unslot(w_t: torch.Tensor, depth: int, taps: int) -> torch.Tensor:
    """``kernel_slot``'s inverse: (..., N, taps * Kp) -> (..., depth, N)."""
    *lead, n, kp = w_t.shape
    t = w_t.reshape(*lead, n, taps, kp // taps)[..., : depth // taps]
    return t.reshape(*lead, n, depth).transpose(-1, -2)


@pytest.mark.parametrize("name", sorted(PAST))
def test_plan_takes_configs_past_the_old_limits(name):
    """decode_plan lays out every precision at B = 1, 20 and 72 over the
    H100's 132 blocks within one block's shared memory, every weight slot's
    pitch and every tap's depth on the 16-byte copy width; a C layer wider
    than 512 and an HC layer wider than 256 are among the layers."""
    cfg = test_config().replace(**PAST[name])
    enc, dec = K1._programs(cfg)
    layers = enc + dec
    widest_c = max(l.cout for l in layers if l.kind == "C")
    assert (widest_c > 512) == (name == "c520")
    assert (cfg.d > 256) == (name == "d264")
    params = Text2Mel(cfg).init(torch.Generator().manual_seed(3), "cpu")
    for prec in K1.PRECS:
        packed = K1.pack_decode_params(cfg, params, prec)
        for B in (1, 20, 72):
            plan = K1.decode_plan(cfg, B, 132, prec)
            assert plan.smem <= K1.SMEM_MAX
            # every region on a 16-byte boundary (its copies move 16 bytes)
            assert all(o % 16 == 0 for o in (plan.part_off, plan.prev_off,
                                             plan.ln_off, plan.z_off,
                                             *plan.woff) if o >= 0)
            assert plan.xw % K1.PAD == 0
            assert plan.xw >= max(2 * cfg.d, cfg.n_mels)
            assert all(K1.layer_depth(l) % K1.PAD == 0
                       and K1.layer_depth(l) <= (3 if l.kind == "HC" else 1)
                       * plan.xw for l in layers)
        ints, ptrs = K1._layer_arrays(packed, cfg, prec, plan)
        ints = np.asarray(ints[:]).reshape(-1, K1.LAYER_INTS)
        ldw, kp, lnv = ints[:, 7], ints[:, 10], ints[:, 11]
        assert (ldw % K1.PAD == 0).all() and (kp % K1.PAD == 0).all()
        # 16-byte copies of the norm parameters only where they are aligned
        lns = [ptrs[4 * i + 3] for i in range(len(layers))]
        assert all(v == (a % 16 == 0 and (4 * c.cout if c.kind == "HC"
                                          else 2 * widest_c) % 4 == 0)
                   for v, a, c in zip(lnv, lns, layers))


@pytest.mark.parametrize("name", sorted(PAST))
def test_kernel_slots_round_trip(name):
    """Each kernel copy ``<key>_t`` holds the JAX-layout key bit for bit,
    transposed, with exactly zero weights in each tap's padding."""
    cfg = test_config().replace(**PAST[name])
    params = Text2Mel(cfg).init(torch.Generator().manual_seed(3), "cpu")
    for prec in K1.PRECS:
        got = K1.pack_decode_params(cfg, params, prec)
        K1._check_packed(got, cfg, prec, torch.device("cpu"))
        for k in [k for k in got if k.startswith(("cw", "hcw"))
                  and not k.endswith("_t")]:
            taps = 3 if k.startswith("hcw") else 1
            w, w_t = got[k], got[k + "_t"]
            back = _unslot(w_t, w.shape[-2], taps)
            assert torch.equal(back.float(), w.float())
            kp = w_t.shape[-1] // taps
            pad = w_t.reshape(*w_t.shape[:-1], taps, kp)[
                ..., w.shape[-2] // taps:]
            assert kp % K1.PAD == 0 and not pad.float().any()


def _jax_and_port(cfg_kw):
    jcfg = jax_test_config().replace(**cfg_kw)
    cfg = test_config().replace(**cfg_kw)
    jp = JText2Mel(jcfg).init(jax.random.PRNGKey(0))
    ids = _ids(cfg)
    jY, jA = (np.asarray(o) for o in JText2Mel(jcfg).decode(
        jp, jnp.asarray(ids), mode="fused"))
    tp = from_jax_params(jp)
    Kt, V = Text2Mel(cfg).text_encode(tp, torch.as_tensor(ids))
    packed = K1.pack_decode_params(cfg, tp)
    Y, A = K1.fused_decode_plain(packed, Kt, V, cfg.max_T, cfg)
    return (Y, A), (jY, jA)


@pytest.mark.parametrize("name", ["d18", "win9"])
def test_plain_matches_jax_kernel_past_the_limits(name):
    """d = 18, and a window of 9 keys: the decode kernel's plain version
    against JAX's fused_decode in interpret mode, cursors identical, Y and A
    within 2e-5."""
    (Y, A), (jY, jA) = _jax_and_port(PAST[name])
    assert Y.shape == jY.shape and A.shape == jA.shape
    np.testing.assert_array_equal(A.numpy().argmax(axis=1),
                                  jA.argmax(axis=1))
    np.testing.assert_allclose(Y.numpy(), jY, atol=2e-5, rtol=0)
    np.testing.assert_allclose(A.numpy(), jA, atol=2e-5, rtol=0)
    if name == "win9":  # the window reaches past 8 keys somewhere
        assert int((A.numpy() > 0).sum(axis=1).max()) == 9


@pytest.fixture(scope="module")
def free_runs():
    cfg = test_config()
    params = Text2Mel(cfg).init(torch.Generator().manual_seed(5), "cpu")
    Kt, V = Text2Mel(cfg).text_encode(params, torch.as_tensor(_ids(cfg)))
    runs = {}
    for prec in K1.PRECS:
        packed = K1.pack_decode_params(cfg, params, prec)
        runs[prec] = (packed, Kt, V,
                      K1.fused_decode_plain(packed, Kt, V, cfg.max_T, cfg,
                                            prec))
    return cfg, runs


@pytest.mark.parametrize("prec", K1.PRECS)
def test_forced_cursors_reproduce_the_free_run(free_runs, prec):
    """Replaying the plain version's own cursors reproduces its free run bit
    for bit, in every precision."""
    cfg, runs = free_runs
    packed, Kt, V, (Y, A) = runs[prec]
    Yf, Af = K1.fused_decode_plain(packed, Kt, V, cfg.max_T, cfg, prec,
                                   cursors=A.argmax(1))
    assert torch.equal(Yf, Y) and torch.equal(Af, A)


def test_forced_cursors_set_every_window(free_runs):
    """A forced trajectory that differs from the free one moves each step's
    window to the forced cursor of the step before: A is nonzero only in
    [cursor, cursor + win)."""
    cfg, runs = free_runs
    packed, Kt, V, (_, A) = runs["highest"]
    T, N, win = cfg.max_T, cfg.max_N, cfg.attention_win_size
    forced = torch.clamp(torch.arange(T) // 2, max=N - 1).repeat(
        A.shape[0], 1)
    assert not torch.equal(forced, A.argmax(1))
    _, Af = K1.fused_decode_plain(packed, Kt, V, T, cfg, cursors=forced)
    prev = torch.cat([torch.zeros(A.shape[0], 1, dtype=torch.long),
                      forced[:, :-1]], dim=1)
    pos = torch.arange(N)[None, :, None]
    inside = (pos >= prev[:, None, :]) & (pos < prev[:, None, :] + win)
    assert not Af[~inside.expand_as(Af)].any()
    assert torch.allclose(Af.sum(1), torch.ones(A.shape[0], T))
