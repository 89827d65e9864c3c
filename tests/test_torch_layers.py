"""The port's layers and blocks against the JAX package on the CPU: each
block type in batch and one-frame step mode on the same parameters and
inputs (atol 1e-5, float32 on both sides), and the random init's
distribution."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.models import blocks as JB
from dc_tts_tpu.models import layers as JL

from dc_tts_tpu_torch.models import blocks as TB
from dc_tts_tpu_torch.models import layers as TL
from dc_tts_tpu_torch.params import from_jax_params

torch.set_num_threads(1)

EPS = 1e-5
CIN = 8

SPECS = [
    ("C1relu", JB.C(1, 1, None, "relu"), TB.C(1, 1, None, "relu")),
    ("C3sig", JB.C(3, 2, 6, "sigmoid"), TB.C(3, 2, 6, "sigmoid")),
    ("C1causal", JB.C(1, 1, 6, None, True), TB.C(1, 1, 6, None, True)),
    ("C3causal", JB.C(3, 2, 6, "relu", True), TB.C(3, 2, 6, "relu", True)),
    ("HC3", JB.HC(3, 3), TB.HC(3, 3)),
    ("HC1", JB.HC(1, 1), TB.HC(1, 1)),
    ("HC3causal", JB.HC(3, 3, True), TB.HC(3, 3, True)),
    ("HC3causal27", JB.HC(3, 27, True), TB.HC(3, 27, True)),
    ("D", JB.D(3, 6, "relu"), TB.D(3, 6, "relu")),
]
CAUSAL = [s for s in SPECS if s[0].endswith(("causal", "causal27"))]


def _setup(jspec, seed):
    params, _ = JB.init_stack(jax.random.PRNGKey(seed), CIN, [jspec])
    p = params[0]
    # non-trivial layer-norm affine so gamma/beta order is exercised
    for k in ("ln", "ln1", "ln2"):
        if k in p:
            n = p[k]["gamma"].shape[0]
            r = np.random.default_rng(seed + len(k))
            p[k] = {"gamma": jnp.asarray(1 + 0.3 * r.standard_normal(n),
                                         jnp.float32),
                    "beta": jnp.asarray(0.2 * r.standard_normal(n),
                                        jnp.float32)}
    x = np.random.default_rng(seed).standard_normal(
        (2, 33, CIN)).astype(np.float32)
    return p, from_jax_params(p), x


@pytest.mark.parametrize("name,jspec,tspec", SPECS, ids=[s[0] for s in SPECS])
def test_apply_block_matches_jax(name, jspec, tspec):
    jp, tp, x = _setup(jspec, 1)
    want = JB.apply_block(jp, jspec, jnp.asarray(x), ln_eps=EPS,
                          dropout_rate=0.0, rng=None, train=False)
    got = TB.apply_block(tp, tspec, torch.as_tensor(x), ln_eps=EPS)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name,jspec,tspec", CAUSAL,
                         ids=[s[0] for s in CAUSAL])
def test_step_block_matches_jax(name, jspec, tspec):
    """Frame by frame through the history buffers, against the JAX step,
    and against the port's own batch apply."""
    jp, tp, x = _setup(jspec, 2)
    T = x.shape[1]
    jbuf = JB.init_stack_state([jspec], [CIN], 2, T)[0]
    tbuf = TB.init_stack_state([tspec], [CIN], 2, T)[0]
    outs = []
    for t in range(T):
        jy, jbuf = JB.step_block(jp, jspec, jnp.asarray(x[:, t]), jbuf, t,
                                 ln_eps=EPS)
        ty = TB.step_block(tp, tspec, torch.as_tensor(x[:, t]), tbuf, t,
                           ln_eps=EPS)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
        outs.append(ty)
    batch = TB.apply_block(tp, tspec, torch.as_tensor(x), ln_eps=EPS)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), batch.numpy(),
                               atol=1e-5, rtol=0)


def test_embedding_and_layer_norm_match_jax():
    table = np.random.default_rng(3).standard_normal((10, 8)).astype(
        np.float32)
    ids = np.array([[0, 3, 9, 0, 1]], np.int32)
    want = JL.embedding_lookup({"table": jnp.asarray(table)},
                               jnp.asarray(ids))
    got = TL.embedding_lookup({"table": torch.as_tensor(table)},
                              torch.as_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[0, 0].any()

    x = np.random.default_rng(4).standard_normal((3, 5, 16)).astype(
        np.float32)
    ln = {"gamma": np.linspace(0.5, 2, 16, dtype=np.float32),
          "beta": np.linspace(-1, 1, 16, dtype=np.float32)}
    want = JL.layer_norm({k: jnp.asarray(v) for k, v in ln.items()},
                         jnp.asarray(x), EPS)
    got = TL.layer_norm(from_jax_params(ln), torch.as_tensor(x), EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_init_distribution_matches_jax():
    """Different random numbers, the same distribution: He truncated
    normal (+-2 sigma) with fan_in = K*Cin for convs, 0.1 * truncated
    normal for the embedding, LN gamma 1 / beta 0, biases 0."""
    gen = torch.Generator().manual_seed(0)
    K, cin, cout = 3, 64, 128
    tw = TL.init_conv(gen, cin, cout, K)
    jw = JL.init_conv(jax.random.PRNGKey(0), cin, cout, K)
    std = math.sqrt(2.0 / (K * cin))
    bound = 2 * std / 0.87962566103423978
    for w in (tw["w"].numpy(), np.asarray(jw["w"])):
        assert w.shape == (K, cin, cout)
        assert np.abs(w).max() <= bound * (1 + 1e-6)
        assert abs(w.std() / std - 1) < 0.03
    assert not tw["b"].any()
    emb = TL.init_embedding(gen, 32, 128)["table"].numpy()
    jemb = np.asarray(JL.init_embedding(jax.random.PRNGKey(1), 32,
                                        128)["table"])
    for e in (emb, jemb):
        assert np.abs(e).max() <= 0.2 * (1 + 1e-6)
        assert abs(e.std() / (0.1 * 0.87962566103423978) - 1) < 0.05
    ln = TL.init_layer_norm(4)
    assert ln["gamma"].tolist() == [1.0] * 4 and not ln["beta"].any()


def test_highway_matches_jax():
    """The classic highway net on JAX's parameters at 1e-6, and the port's
    init as JAX's (Glorot-uniform kernels, -1 gate bias)."""
    key = jax.random.PRNGKey(0)
    jp = JL.init_highway(key, 8)
    x = np.random.default_rng(0).standard_normal((2, 5, 8)).astype(np.float32)
    want = np.asarray(JL.highway(jp, jnp.asarray(x)))
    got = TL.highway(from_jax_params(jp), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    tp = TL.init_highway(torch.Generator().manual_seed(0), 8)
    lim = math.sqrt(6.0 / 16)
    for k in ("h", "t"):
        assert tp[k]["w"].shape == (8, 8)
        assert float(tp[k]["w"].abs().max()) <= lim
    assert torch.equal(tp["t"]["b"], torch.full((8,), -1.0))
    assert torch.equal(tp["h"]["b"], torch.zeros(8))
    y = TL.highway(tp, torch.as_tensor(x))
    assert y.shape == x.shape
    assert float((y - torch.as_tensor(x)).abs().mean()) < 1.0
