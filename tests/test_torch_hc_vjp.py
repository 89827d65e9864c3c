"""Kernel K4's CPU side against the JAX package: the plain forward, the
plain (hand-derived) backward and the autograd.Function's CPU route
against ``hc_block_trainable`` run interpreted, as tests/test_pallas.py
runs it, with its four (size, rate, causal) cases and a T=100 case.
Forward at rtol 1e-5 and all 7 gradients at atol 2e-4 (the JAX test's
bars). The plain backward is also held to torch.autograd of the plain
forward in float64 (1e-10). The float32 core's arithmetic, a three-term
TF32 split (3xTF32), is checked here without the card: ``tf32_split``'s
rounding (cvt.rna.tf32.f32 in torch bit operations), and the emulated
3xTF32 product with float32 sums at SSRN HC(3,1)'s depths within K4's gate,
max(2e-5 x max |value|, 2 x the float32 product's distance), of float64.
The bf16 body's core is checked the same way: rounding commutes with the
tap gather (bf16(taps(x)) == taps(bf16(x)) bitwise, which lets the kernels
round x once a call), and its emulated arithmetic (exact bf16 products,
float32 sums per 16-deep step, promotion every 2 64-deep k-tiles) at SSRN
HC(3,1)'s depths within K4's gate. A block whose C the cores' 16-byte
copies cannot take is stored padded with zero channels: the padded layout
gives the real channels' output and gradients exactly (float64, through
autograd). The CUDA kernels themselves are checked on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.ops.pallas_hc_vjp import hc_block_trainable as jax_hc

from dc_tts_tpu_torch.ops import hc_vjp as K4
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

EPS = 1e-5
CASES = [(3, 1, True, 24), (3, 3, False, 24), (1, 1, True, 24),
         (3, 27, True, 24), (3, 2, True, 100)]
NAMES = ("dx", "dw", "db", "dg1", "db1", "dg2", "db2")


def _inputs(size, T, seed, C=16, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((size, C, 2 * C)) * 0.2).astype(np.float32)
    vecs = [(rng.standard_normal(n) * 0.3 + (1.0 if i in (1, 3) else 0.0)
             ).astype(np.float32)
            for i, n in enumerate([2 * C, C, C, C, C])]
    dy = rng.standard_normal((B, T, C)).astype(np.float32)
    return [x, w, *vecs], dy


def _jax(args, dy, size, rate, causal):
    """y and the 7 gradients of sum(y * dy) from the interpreted kernel."""
    ja = [jnp.asarray(a) for a in args]

    def f(*a):
        return jax_hc(*a, size, rate, causal, EPS, True)

    y, vjp = jax.vjp(f, *ja)
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"K{s}-r{r}-{'causal' if c else 'same'}-T{t}"
                     for s, r, c, t in CASES])
def case(request):
    size, rate, causal, T = request.param
    args, dy = _inputs(size, T, seed=size * 100 + rate + T)
    return (size, rate, causal), args, dy, _jax(args, dy, size, rate, causal)


def test_plain_versions_match_jax_kernel(case):
    geo, args, dy, (jy, jgrads) = case
    t = [torch.as_tensor(a) for a in args]
    y = K4.hc_block_fwd_plain(*t, *geo, EPS)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-6)
    grads = K4.hc_block_bwd_plain(*t, torch.as_tensor(dy), *geo, EPS)
    for n, g, jg in zip(NAMES, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, atol=2e-4, err_msg=n)


def test_autograd_function_cpu_route_matches_jax_kernel(case):
    geo, args, dy, (jy, jgrads) = case
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    before = profiling.counts()
    y = K4.hc_block_trainable(*leaves, *geo, EPS)
    grads = torch.autograd.grad(y, leaves, torch.as_tensor(dy))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert profiling.counts() == before
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5, atol=1e-6)
    for n, g, jg in zip(NAMES, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, atol=2e-4, err_msg=n)


def test_plain_backward_matches_autograd_of_plain_forward(case):
    geo, args, dy, _ = case
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in args]
    dy64 = torch.as_tensor(dy, dtype=torch.float64)
    y = K4.hc_block_fwd_plain(*leaves, *geo, EPS)
    auto = torch.autograd.grad(y, leaves, dy64)
    hand = K4.hc_block_bwd_plain(*[a.detach() for a in leaves], dy64, *geo,
                                 EPS)
    for n, a, h in zip(NAMES, auto, hand):
        np.testing.assert_allclose(h.numpy(), a.numpy(), atol=1e-10,
                                   err_msg=n)


def test_wrapper_splits_and_pads():
    """The schedule constants fixed by the shape alone, and the pads."""
    assert K4._pads(3, 27, True) == (54, 0)
    assert K4._pads(3, 9, False) == (9, 9)
    assert K4._pads(1, 1, False) == (0, 0)
    # full-width trainer shapes: dW splits and backward row chunks
    assert K4._dw_splits(3, 256, 32 * 210) == 11
    assert K4._dw_splits(3, 1024, 32 * 840) == 1
    assert K4._dw_splits(3, 512, 32 * 180) == 3
    assert K4._dw_splits(3, 256, 32 * 210, bf16=True) == 11
    assert K4._row_chunk(32 * 840) == 51
    assert K4._row_chunk(10) == 8
    # dh^T's rows, padded to the 32-deep k-tile
    assert K4._pad_rows(32 * 210) == 6720
    assert K4._pad_rows(10) == 32


def test_float32_core_shape_rules():
    """Both cores copy 16 bytes at a time, 4 float32 or 8 bf16 channels: a
    block of any other C is stored padded to the next such width, so the
    wrapper's check takes every C whose stored width fits the row kernel's
    shared memory (never a quiet fallback to the plain version)."""
    def check(C, bf16):
        K4._check("hc", torch.zeros(2, 5, C), torch.zeros(3, C, 2 * C),
                  [torch.zeros(2 * C)] + [torch.zeros(C)] * 4, 3, bf16)
    assert [K4.stored_channels(C, False) for C in (6, 8, 10, 12)] == \
        [8, 8, 12, 12]
    assert [K4.stored_channels(C, True) for C in (6, 8, 10, 12)] == \
        [8, 8, 16, 16]
    for C in (6, 8, 10, 12):
        check(C, False)
        check(C, True)
    check(K4._MAX_C - 3, True)
    with pytest.raises(ValueError, match="does not fit"):
        check(K4._MAX_C + 1, False)


@pytest.mark.parametrize("C,bf16", [(10, False), (6, False), (10, True)])
def test_padded_channels_leave_the_real_ones_exact(C, bf16):
    """What the kernels compute for a block of C channels stored in
    ``stored_channels(C)``: the tap product over every stored channel of
    ``pad_channels``' tensors, the row part (layer norms, gate, residual)
    over the C real ones, nothing flowing back from the padding. In float64
    through autograd, ``unpad_grads`` of that gives the plain version's
    output and gradients within 1e-10, and h is exactly 0 in the
    padding."""
    size, rate, causal = 3, 2, False
    args, dy = _inputs(size, 20, seed=C, C=C)
    args = [torch.tensor(a, dtype=torch.float64) for a in args]
    dy = torch.tensor(dy, dtype=torch.float64)
    Cp = K4.stored_channels(C, bf16)
    assert Cp > C
    padded = [t.requires_grad_(True) for t in K4.pad_channels(Cp, *args)]
    xp, wp, bp, *vecs = padded
    h = K4._taps(xp, size, rate, causal) @ wp.reshape(size * Cp, 2 * Cp) + bp
    assert not h[..., C:Cp].any() and not h[..., Cp + C:].any()
    g1, b1, g2, b2 = (v[:C] for v in vecs)
    n1, _ = K4._ln(h[..., :C], EPS)
    n2, _ = K4._ln(h[..., Cp:Cp + C], EPS)
    g = torch.sigmoid(n1 * g1 + b1)
    y = g * (n2 * g2 + b2) + (1.0 - g) * xp[..., :C]
    grads = K4.unpad_grads(C, *torch.autograd.grad(y, padded, dy))
    want = K4.hc_block_bwd_plain(*args, dy, size, rate, causal, EPS)
    yw = K4.hc_block_fwd_plain(*args, size, rate, causal, EPS)
    np.testing.assert_allclose(y.detach().numpy(), yw.numpy(), atol=1e-10)
    for n, a, b in zip(NAMES, grads, want):
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the 3xTF32 split of the float32 products (csrc/hc_vjp.cu, csrc/sm90.cuh)


def test_tf32_split_parts():
    """hi and lo are TF32 values (low 13 mantissa bits zero) and hi + lo is
    t within 2^-22 |t|, over magnitudes from 1e-30 to 1e30."""
    rng = np.random.default_rng(0)
    t = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    hi, lo = K4.tf32_split(torch.as_tensor(t))
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    t64 = t.astype(np.float64)
    err = np.abs(hi.double().numpy() + lo.double().numpy() - t64)
    assert np.all(err <= 2.0 ** -22 * np.abs(t64))


def test_tf32_split_rounds_to_nearest_ties_away():
    """cvt.rna's rounding: a value halfway between two TF32 values goes away
    from zero, either sign; just below halfway goes to the nearer."""
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F803000,
                     0x3F8FF000], np.uint32).view(np.int32)
    want = np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x3F804000,
                     0x3F900000], np.uint32).view(np.int32)
    hi, _ = K4.tf32_split(torch.as_tensor(bits).view(torch.float32))
    np.testing.assert_array_equal(hi.view(torch.int32).numpy(), want)


PROMOTE = 4  # csrc/hc_vjp.cu PROMOTE, fixed: k-tiles a tensor-core sum


def _three_tf32(a, b, promote_every):
    """a (R, Q) @ b (Q, N) as the tensor-core core computes it: per 8-deep
    step the three products hi*hi + hi*lo + lo*hi (exact, float64) added to
    a float32 accumulator, which is added to a float32 sum and restarted
    every ``promote_every`` 32-deep k-tiles."""
    ah, al = (p.double().numpy() for p in K4.tf32_split(torch.as_tensor(a)))
    bh, bl = (p.double().numpy() for p in K4.tf32_split(torch.as_tensor(b)))
    R, Q = a.shape
    steps = Q // 8
    def per_step(x, y):
        return np.einsum("rsk,skn->srn", x.reshape(R, steps, 8),
                         y.reshape(steps, 8, -1))
    parts = per_step(ah, bh) + per_step(ah, bl) + per_step(al, bh)
    acc = np.zeros(parts.shape[1:], np.float32)
    total = np.zeros_like(acc)
    window = 4 * promote_every
    for s in range(steps):
        acc = (acc + parts[s]).astype(np.float32)
        if s % window == window - 1 or s == steps - 1:
            total = (total + acc).astype(np.float32)
            acc[:] = 0
    return total


@pytest.mark.parametrize("Q", [3072, 6144, 26880],
                         ids=["fwd-Q3072", "dx-Q6144", "dw-Q26880"])
def test_three_tf32_product_within_k4_gate(Q):
    """The design's numerics at SSRN HC(3,1)'s depths (forward K*C, dx K*2C,
    dW B*T): the emulated 3xTF32 product with float32 sums sits within K4's
    gate, max(2e-5 x max |value|, 2 x the float32 product's distance), of
    the float64 product."""
    rng = np.random.default_rng(Q)
    a = rng.standard_normal((4, Q)).astype(np.float32)
    b = (rng.standard_normal((Q, 6)) * (2.0 / Q) ** 0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = _three_tf32(a, b, PROMOTE)
    plain = (torch.as_tensor(a) @ torch.as_tensor(b)).double().numpy()
    err = float(np.abs(got - ref).max())
    gate = max(2e-5 * float(np.abs(ref).max()),
               2 * float(np.abs(plain - ref).max()))
    print(f"Q={Q}: 3xTF32 {err:.3e}, gate {gate:.3e}, margin "
          f"{gate / max(err, 1e-30):.1f}x")
    assert err <= gate


# ---------------------------------------------------------------------------
# the bf16 body's core (csrc/bf16_wgmma.cuh)


@pytest.mark.parametrize("size,rate,causal", [(3, 1, True), (3, 9, False),
                                              (3, 27, True), (1, 1, False)])
def test_taps_commute_with_bf16_rounding(size, rate, causal):
    """taps(bf16(x)) == bf16(taps(x)) bitwise, for causal and centred
    padding: the bf16 body rounds x once a call and gathers taps of the
    rounded copy."""
    rng = np.random.default_rng(size * 100 + rate)
    x = torch.from_numpy((rng.standard_normal((2, 40, 16)) * 3
                          ).astype(np.float32))
    a = K4._taps(K4._bf16(x), size, rate, causal)
    b = K4._bf16(K4._taps(x, size, rate, causal))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


BF16_PROMOTE = 2  # csrc/bf16_wgmma.cuh PROMOTE: 64-deep k-tiles a sum


def _bf16_core(a, b, promote_every):
    """a (R, Q) @ b (Q, N) of bf16 values as the bf16 wgmma core computes
    it: per 16-deep step the exact products (float64) summed and added to a
    float32 accumulator, which is added to a float32 sum and restarted every
    ``promote_every`` 64-deep k-tiles."""
    R, Q = a.shape
    steps = Q // 16
    parts = np.einsum("rsk,skn->srn", a.astype(np.float64).reshape(R, steps,
                                                                  16),
                      b.astype(np.float64).reshape(steps, 16, -1))
    acc = np.zeros(parts.shape[1:], np.float32)
    total = np.zeros_like(acc)
    window = 4 * promote_every
    for s in range(steps):
        acc = (acc + parts[s]).astype(np.float32)
        if s % window == window - 1 or s == steps - 1:
            total = (total + acc).astype(np.float32)
            acc[:] = 0
    return total


@pytest.mark.parametrize("Q", [3072, 6144, 26880],
                         ids=["fwd-Q3072", "dx-Q6144", "dw-Q26880"])
def test_bf16_core_product_within_k4_gate(Q):
    """The bf16 body's numerics at SSRN HC(3,1)'s depths (forward K*C, dx
    K*2C, dW B*T): the emulated core on bf16-rounded operands sits within
    K4's gate, max(2e-5 x max |value|, 2 x the float32 product's distance),
    of the float64 product of the same rounded operands."""
    rng = np.random.default_rng(Q + 1)
    a = K4._bf16(torch.from_numpy(rng.standard_normal((4, Q)).astype(
        np.float32))).numpy()
    b = K4._bf16(torch.from_numpy((rng.standard_normal((Q, 6))
                                   * (2.0 / Q) ** 0.5).astype(np.float32))
                 ).numpy()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = _bf16_core(a, b, BF16_PROMOTE)
    plain = (torch.as_tensor(a) @ torch.as_tensor(b)).double().numpy()
    err = float(np.abs(got - ref).max())
    gate = max(2e-5 * float(np.abs(ref).max()),
               2 * float(np.abs(plain - ref).max()))
    print(f"Q={Q}: bf16 core {err:.3e}, gate {gate:.3e}, margin "
          f"{gate / max(err, 1e-30):.1f}x")
    assert err <= gate
