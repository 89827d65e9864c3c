"""``train/optimizer.apply_updates`` (clip, Adam, Noam as multi-tensor
launches over every leaf) bit for bit the per-leaf loop it replaced, kept
here as the reference: the same elementwise operations in the same order,
over five steps whose gradients run from 1e-3 to 10 (so clipping bites).
On the CPU in the suite; on the card, marked ``cuda``:
``python -m pytest --noconftest -m cuda tests/test_torch_optimizer_foreach.py``.
"""
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import base_config
from dc_tts_tpu_torch.train import optimizer as O

SHAPES = [(3, 64, 128), (128,), (64,), (1, 33, 7), (1000,)]


def _loop(params, grads, state, cfg):
    """The per-leaf loop: ~13 kernels a leaf."""
    adam, sched = state[1], state[2]
    c = int(adam["count"]) + 1
    f = np.float32
    bc1 = float(f(1.0) - f(O.B1) ** f(c))
    bc2 = float(f(1.0) - f(O.B2) ** f(c))
    lr = float(O.noam_lr(int(sched["count"]), cfg.lr, cfg.warmup_steps))
    for p, g, mu, nu in zip(params, grads, adam["mu"], adam["nu"]):
        g = torch.clamp(g, -1.0, 1.0)
        mu.mul_(O.B1).add_(g, alpha=1.0 - O.B1)
        nu.mul_(O.B2).add_(g * g, alpha=1.0 - O.B2)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + O.EPS)
        p.sub_(lr * u)
    return [{}, {"count": torch.tensor(c, dtype=torch.int32),
                 "mu": adam["mu"], "nu": adam["nu"]},
            {"count": torch.tensor(int(sched["count"]) + 1,
                                   dtype=torch.int32)}, {}]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_apply_updates_matches_the_per_leaf_loop_bitwise(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(s, generator=gen).to(device) for s in SHAPES]
    cfg = base_config()
    a, b = [p.clone() for p in params], [p.clone() for p in params]
    sa, sb = O.init_opt_state(a), O.init_opt_state(b)
    for step in range(5):
        grads = [torch.randn(s, generator=gen).to(device) * 10.0 ** (step - 3)
                 for s in SHAPES]
        sa = O.apply_updates(a, grads, sa, cfg)
        sb = _loop(b, grads, sb, cfg)
    for x, y in zip(a + sa[1]["mu"] + sa[1]["nu"],
                    b + sb[1]["mu"] + sb[1]["nu"]):
        assert torch.equal(x, y)
    assert int(sa[1]["count"]) == int(sb[1]["count"]) == 5
    assert int(sa[2]["count"]) == int(sb[2]["count"]) == 5
