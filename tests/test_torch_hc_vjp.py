"""Kernel K4's CPU side against the JAX package: the plain forward, the
plain (hand-derived) backward and the autograd.Function's CPU route
against ``hc_block_trainable`` run interpreted, as tests/test_pallas.py
runs it, with its four (size, rate, causal) cases and a T=100 case.
Forward at rtol 1e-5 and all 7 gradients at atol 2e-4 (the JAX test's
bars). The plain backward is also held to torch.autograd of the plain
forward in float64 (1e-10). The CUDA kernels themselves are checked on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.ops.pallas_hc_vjp import hc_block_trainable as jax_hc

from dc_tts_tpu_torch.ops import hc_vjp as K4

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
    n_f, n_b = K4.hc_block_fwd.launches, K4.hc_block_bwd.launches
    y = K4.hc_block_trainable(*leaves, *geo, EPS)
    grads = torch.autograd.grad(y, leaves, torch.as_tensor(dy))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (K4.hc_block_fwd.launches, K4.hc_block_bwd.launches) == (n_f, n_b)
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
    assert K4._row_chunk(32 * 840) == 51
    assert K4._row_chunk(10) == 8
