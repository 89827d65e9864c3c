"""The port's Text2Mel training trajectory against JAX's: from the same
initial state (``PRNGKey(0)``) on the same batch, at ``test_config()``
(no dropout), the port's ``loss_mels`` after 10 and after 50 steps against
JAX's jitted step's.

Both run float32 with sums taken in other orders. Step 10 agrees to
2.7e-7 relative (measured); by step 50 the runs are 5.3e-3 apart
(measured): Adam divides each gradient by its own running scale, so an
element whose gradient lies within float32 noise of zero takes an update
of up to the learning rate with the noise's sign, and later steps grow
those differences (PERF.md §6)."""
import jax
import numpy as np

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.train.steps import init_text2mel_state, make_text2mel_step

from test_torch_learning import CFG, overfit, t2m_batch

# measured: 2.7e-7 at step 10, 5.3e-3 at step 50 (relative)
RTOL = {10: 1e-5, 50: 2e-2}


def test_text2mel_loss_trajectory_matches_jax():
    batch = t2m_batch()
    jcfg = jax_test_config().replace(warmup_steps=50.0)
    jstate = init_text2mel_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(make_text2mel_step(jcfg))
    jbatch = {k: v.numpy() for k, v in batch.items()}
    want = {}
    for i in range(1, 51):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(2))
        if i in RTOL:
            want[i] = float(m["loss_mels"])
    got = overfit(CFG, "t2m", 0, batch, 50, record=tuple(RTOL))
    for i, rtol in RTOL.items():
        rel = abs(got[i]["loss_mels"] - want[i]) / want[i]
        print(f"step {i}: loss_mels port {got[i]['loss_mels']:.8f} JAX "
              f"{want[i]:.8f}, relative {rel:.3e} (rtol {rtol})")
        np.testing.assert_allclose(got[i]["loss_mels"], want[i], rtol=rtol,
                                   err_msg=f"step {i}")
