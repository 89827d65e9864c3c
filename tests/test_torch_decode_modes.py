"""Every decode mode and precision of the port against the JAX package on
the CPU, on the same parameters (JAX ``init(PRNGKey(0))`` carried across
with ``from_jax_params``, the ids of tests/test_torch_text2mel.py):

* ``split_hilo`` and the packing of each precision bit for bit equal to
  JAX's ``astype(bfloat16)`` on JAX's packed weights;
* the decode kernel's plain version in "high3" and "hybrid" against JAX's
  Pallas kernel in interpret mode: cursors equal, Y and A within
  max(2e-5, 2 x the distance of the port's float32 plain version from its
  float64 one). 2e-5 is the "highest" test's tolerance; the split modes
  round x - bf16(x) to bf16, so where two float32 sums taken in another
  order (the port's and XLA's CPU bf16 dot's, which depends on the CPU)
  differ by an ulp, a rounding of the lo half can flip, worth ~2^-15 of the
  element, and the feedback carries it on. That is what the float64
  distance measures; the card holds the kernel to the same gate. And, as
  in the JAX tests, Y within 1e-4 of JAX's incremental mode;
* "default" (one bf16 pass): its layer product against float64 numpy on
  the rounded operands at 1e-6 relative, and the whole decode finite. JAX's
  interpret mode computes "default" in float32 on the CPU (the TPU rounds),
  so it is no oracle for it;
* "reference": against JAX's ``decode(mode="reference")`` (cursors equal,
  Y and A within 2e-5), against the original synthesize.py loop re-stated
  in torch (a full forward per step), and equal to "incremental" while the
  cursor stays at 0;
* the step API: a loop over ``decode_step`` equals ``decode(mode=
  "incremental")`` within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.models.text2mel import Text2Mel as JText2Mel
from dc_tts_tpu.ops.pallas_decode import pack_decode_params as jax_pack

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.models import Text2Mel
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.params import from_jax_params
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = test_config()
REDUCED = ("high3", "hybrid", "default")


@pytest.fixture(scope="module")
def t2m():
    params = JText2Mel(jax_test_config()).init(jax.random.PRNGKey(0))
    ids = np.zeros((3, CFG.max_N), np.int32)
    for i in range(3):
        ids[i, : 6 + 3 * i] = (np.arange(6 + 3 * i) % 28) + 3
    return params, from_jax_params(params), ids


@pytest.fixture(scope="module")
def jax_decodes(t2m):
    """JAX's decodes on the fixture: fused high3/hybrid (interpret mode),
    incremental, and reference (one jit)."""
    jp, _, ids = t2m
    m = JText2Mel(jax_test_config())
    ids = jnp.asarray(ids)
    out = {p: m.decode(jp, ids, mode="fused", prec=p)
           for p in ("high3", "hybrid")}
    out["incremental"] = m.decode(jp, ids, mode="incremental")
    out["reference"] = jax.jit(
        lambda p, i: m.decode(p, i, mode="reference"))(jp, ids)
    return {k: tuple(np.asarray(o) for o in v) for k, v in out.items()}


def _jax_hilo(w):
    hi = w.astype(jnp.bfloat16)
    lo = (w - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return np.stack([np.asarray(hi.astype(jnp.float32)),
                     np.asarray(lo.astype(jnp.float32))])


def _bits_equal(got: torch.Tensor, want: np.ndarray):
    """bf16 tensor against bf16 values held in float32 (exact widening)."""
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_split_hilo_matches_jax(t2m):
    jp, tp, _ = t2m
    want = jax_pack(jax_test_config(), jp)
    got = K1.pack_decode_params(CFG, tp)
    for k in ("cw", "hcw"):
        _bits_equal(K1.split_hilo(got[k]), _jax_hilo(want[k]))
    # a value exactly between two bf16 numbers rounds to the even one
    w = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8)])
    hi, lo = K1.split_hilo(w).float()
    assert hi.tolist() == [1.0, 1.0 + 2 * 2.0 ** -7 * 1.0, -1.0]
    assert torch.equal(hi + lo, w)


@pytest.mark.parametrize("prec", REDUCED)
def test_pack_decode_params_by_prec_matches_jax(t2m, prec):
    """The kernel inputs of each precision, as the JAX fused_decode builds
    them from its packing (pallas_decode.py:313-323)."""
    jp, tp, _ = t2m
    base = jax_pack(jax_test_config(), jp)
    got = K1.pack_decode_params(CFG, tp, prec)
    n_c, n_hc = K1._enc_counts(CFG)
    want = {k: np.asarray(v) for k, v in base.items()}
    if prec == "high3":
        want.update(cw=_jax_hilo(base["cw"]), hcw=_jax_hilo(base["hcw"]))
    elif prec == "hybrid":
        want.update(cw2=_jax_hilo(base["cw"][n_c:]),
                    hcw2=_jax_hilo(base["hcw"][n_hc:]))
    else:
        want.update({k: np.asarray(base[k].astype(jnp.bfloat16)
                                   .astype(jnp.float32))
                     for k in ("cw", "hcw")})
    # the CUDA kernel's copies: every kernel slot transposed
    want.update({k + "_t": np.swapaxes(v, -1, -2)
                 for k, v in list(want.items()) if k.startswith(("cw", "hcw"))})
    assert set(got) == set(want)
    for k, v in got.items():
        if v.dtype == torch.bfloat16:
            _bits_equal(v, want[k])
        else:
            np.testing.assert_array_equal(v.numpy(), want[k])


def test_hybrid_split_holds_audiodec_only(t2m):
    """The split stacks start at AudioDec's first layer: an index off by the
    AudioEnc counts would read other weights (every layer's differ here)."""
    _, tp, _ = t2m
    p = K1.pack_decode_params(CFG, tp, "hybrid")
    n_c, n_hc = K1._enc_counts(CFG)
    assert (n_c, n_hc) == (3, 10)
    hi = p["hcw2"][0].float()
    assert torch.equal(hi[0], p["hcw"][n_hc].to(torch.bfloat16).float())
    assert not torch.equal(hi[0], p["hcw"][0].to(torch.bfloat16).float())
    assert torch.equal(p["cw2"][0, 0].float(),
                       p["cw"][n_c].to(torch.bfloat16).float())
    assert p["cw2"].shape[1] == p["cw"].shape[0] - n_c


def _noise_gate(packed, Kt, V, prec):
    """max(2e-5, 2 x the float32 plain version's distance from float64) for
    Y and A (module docstring)."""
    Y, A = K1.fused_decode_plain(packed, Kt, V, CFG.max_T, CFG, prec)
    Y64, A64 = K1.fused_decode_plain(packed, Kt, V, CFG.max_T, CFG, prec,
                                     torch.float64)
    return (max(2e-5, 2 * float((Y.double() - Y64).abs().max())),
            max(2e-5, 2 * float((A.double() - A64).abs().max())))


@pytest.mark.parametrize("prec", ["high3", "hybrid"])
def test_reduced_plain_matches_jax_kernel(t2m, jax_decodes, prec):
    _, tp, ids = t2m
    model = Text2Mel(CFG)
    Y, A = model.decode(tp, torch.as_tensor(ids), mode="fused", prec=prec)
    jY, jA = jax_decodes[prec]
    Kt, V = model.text_encode(tp, torch.as_tensor(ids))
    gate_y, gate_a = _noise_gate(K1.pack_decode_params(CFG, tp, prec), Kt, V,
                                 prec)
    dY, dA = np.abs(Y.numpy() - jY).max(), np.abs(A.numpy() - jA).max()
    print(f"{prec}: max|dY| {dY:.3e} (gate {gate_y:.3e}), max|dA| "
          f"{dA:.3e} (gate {gate_a:.3e})")
    assert Y.shape == jY.shape and A.shape == jA.shape
    np.testing.assert_array_equal(A.numpy().argmax(axis=1),
                                  jA.argmax(axis=1))
    assert dY <= gate_y and dA <= gate_a
    np.testing.assert_allclose(Y.numpy(), jax_decodes["incremental"][0],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["f32", "split", "bf16"])
def test_layer_product_against_float64(kind):
    """Each operand kind against float64 numpy on the same rounded operands
    (the split's xl@Wl term is left out on both sides)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((4, 96)), dtype=torch.float32)
    w32 = torch.as_tensor(rng.standard_normal((96, 64)) / 10,
                          dtype=torch.float32)
    w = {"f32": w32, "split": K1.split_hilo(w32),
         "bf16": w32.to(torch.bfloat16)}[kind]
    got = K1.layer_product(x, w, kind).numpy()

    def f64(t):
        return t.double().numpy()

    if kind == "f32":
        want = f64(x) @ f64(w)
    elif kind == "bf16":
        want = f64(x.to(torch.bfloat16)) @ f64(w)
    else:
        xh, xl = K1.split_hilo(x)
        want = f64(xh) @ f64(w[0]) + f64(xh) @ f64(w[1]) + f64(xl) @ f64(w[0])
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_default_decode_is_finite(t2m):
    """No JAX oracle (module docstring): finite, of the right shape, and its
    distance from "highest" printed."""
    _, tp, ids = t2m
    model = Text2Mel(CFG)
    Y, A = model.decode(tp, torch.as_tensor(ids), mode="fused",
                        prec="default")
    Yh, Ah = model.decode(tp, torch.as_tensor(ids), mode="fused")
    assert Y.shape == Yh.shape and A.shape == Ah.shape
    assert bool(torch.isfinite(Y).all()) and bool(torch.isfinite(A).all())
    torch.testing.assert_close(A.sum(1), torch.ones_like(A.sum(1)))
    print(f"default vs highest: max|dY| {float((Y - Yh).abs().max()):.3e}, "
          f"cursors equal {bool(torch.equal(A.argmax(1), Ah.argmax(1)))}")


@pytest.mark.parametrize("prec", K1.PRECS)
def test_wrapper_takes_plain_version_on_cpu(t2m, prec):
    """CPU tensors run the plain version in every precision and count no
    launch; a packing of another precision raises."""
    _, tp, ids = t2m
    Kt, V = Text2Mel(CFG).text_encode(tp, torch.as_tensor(ids))
    packed = K1.pack_decode_params(CFG, tp, prec)
    before = profiling.counts()
    Y, A = K1.fused_decode(packed, Kt, V, 4, CFG, prec)
    Yp, Ap = K1.fused_decode_plain(packed, Kt, V, 4, CFG, prec)
    assert profiling.counts() == before
    assert torch.equal(Y, Yp) and torch.equal(A, Ap)
    other = "high3" if prec != "high3" else "highest"
    with pytest.raises(ValueError, match="packed"):
        K1.fused_decode(K1.pack_decode_params(CFG, tp, other), Kt, V, 4,
                        CFG, prec)
    with pytest.raises(ValueError, match="precision"):
        K1.fused_decode(packed, Kt, V, 4, CFG, prec + "x")


def test_reference_matches_jax(t2m, jax_decodes):
    _, tp, ids = t2m
    Y, A = Text2Mel(CFG).decode(tp, torch.as_tensor(ids), mode="reference")
    jY, jA = jax_decodes["reference"]
    assert Y.shape == jY.shape and A.shape == jA.shape
    np.testing.assert_array_equal(A.numpy().argmax(axis=1),
                                  jA.argmax(axis=1))
    np.testing.assert_allclose(Y.numpy(), jY, atol=2e-5, rtol=0)
    np.testing.assert_allclose(A.numpy(), jA, atol=2e-5, rtol=0)


def _rand_ids(seed, b):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(1, CFG.vocab_size, (b, CFG.max_N)))


def reference_style_decode(model, params, ids, max_t):
    """The original synthesize.py loop, literally: the full graph again at
    every step on the whole padded mel buffer, column j kept, the cursor
    carried as max_attentions[:, j] (tests/test_networks.py's oracle)."""
    B = ids.shape[0]
    K, V = model.text_encode(params, ids)
    Y = torch.zeros(B, max_t, model.cfg.n_mels)
    prev = torch.zeros(B, dtype=torch.long)
    aligns = []
    for j in range(max_t):
        S = torch.cat([torch.zeros_like(Y[:, :1]), Y[:, :-1]], dim=1)
        Q = model.audio_encode(params, S)
        R, align, maxatt = model.attention(params, Q, K, V, monotonic=True,
                                           prev_max_attentions=prev)
        y = torch.sigmoid(model.audio_decode(params, R))
        Y[:, j] = y[:, j]
        prev = maxatt[:, j]
        aligns.append(align[:, :, j])
    return Y, torch.stack(aligns, dim=-1)


def test_reference_equals_reference_loop(t2m):
    """Including the re-masking of earlier rows by the current cursor."""
    _, tp, _ = t2m
    model = Text2Mel(CFG)
    ids = _rand_ids(7, 2)
    max_t = 12  # keeps the O(T^2) loop cheap
    Y_ref, A_ref = reference_style_decode(model, tp, ids, max_t)
    Y, A = model.decode(tp, ids, max_t, mode="reference")
    torch.testing.assert_close(Y, Y_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(A, A_ref, atol=2e-5, rtol=0)


def test_reference_equals_incremental_until_cursor_moves(t2m):
    """While the cursor stays at 0 every row's mask is the same in both
    modes, so their frames agree up to its first move."""
    _, tp, _ = t2m
    model = Text2Mel(CFG)
    ids = _rand_ids(7, 1)
    max_t = 12
    Y_ref, _ = model.decode(tp, ids, max_t, mode="reference")
    Y_inc, A_inc = model.decode(tp, ids, max_t, mode="incremental")
    moves = torch.nonzero(A_inc.argmax(1)[0] != 0)
    first = int(moves[0]) if len(moves) else max_t - 1
    torch.testing.assert_close(Y_inc[:, : first + 1], Y_ref[:, : first + 1],
                               atol=2e-5, rtol=0)


def test_decode_step_loop_equals_incremental(t2m):
    _, tp, _ = t2m
    model = Text2Mel(CFG)
    ids = _rand_ids(8, 2)
    max_t = 10
    K, V = model.text_encode(tp, ids)
    state = model.init_decode_state(2, max_t)
    assert state.prev_max_attention.tolist() == [0, 0]
    ys, als = [], []
    for t in range(max_t):
        y_t, a_t, state = model.decode_step(tp, K, V, state, t)
        ys.append(y_t)
        als.append(a_t)
    Y, A = model.decode(tp, ids, max_t, mode="incremental")
    torch.testing.assert_close(Y, torch.stack(ys, 1), atol=1e-5, rtol=0)
    torch.testing.assert_close(A, torch.stack(als, 2), atol=1e-5, rtol=0)
    assert torch.equal(state.prev_max_attention, A[:, :, -1].argmax(1))
    assert torch.equal(state.prev_y, Y[:, -1])
