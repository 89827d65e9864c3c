"""SSRN must fit a functional mel -> mag mapping: ``tests/test_learning.py``'s
SSRN checks on the port, from JAX's initial parameters (``PRNGKey(3)``)
and batch, at JAX's calibrated gates (``test_torch_learning.py`` has the
helpers and the Text2Mel checks)."""
import numpy as np
import pytest
import torch

from test_torch_learning import CFG, overfit, ssrn_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [
    "float32", pytest.param("bfloat16_full", marks=pytest.mark.slow)])
def test_ssrn_overfits_functional_mapping(dtype):
    """mags ARE a function of mels, so a working SSRN drives L1 near zero
    (JAX's calibration for bfloat16_full: 0.022 at step 400)."""
    run = overfit(CFG.replace(compute_dtype=dtype), "ssrn", 3, ssrn_batch(),
                  400)
    first, final = run[1]["loss_mags"], run[400]["loss_mags"]
    assert final < 0.07, (first, final)
    assert final < first / 3
    assert np.isfinite(final)
