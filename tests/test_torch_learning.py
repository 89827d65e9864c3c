"""The port's training must FIT data: ``tests/test_learning.py``'s and
``tests/test_quality_e2e.py``'s checks on the port, from the JAX package's
initial parameters (the same ``PRNGKey``s, carried across by
``from_jax_train_state``) and the same batch, so JAX's calibrated gates
apply unchanged. ``test_config()`` has no dropout, so the runs are
deterministic.

Tier-1: one 400-step float32 Text2Mel run (module fixture) holds both
``test_text2mel_overfits_one_batch``'s gates at step 400 and the
diagonality gates at step 200 (the JAX tests' two runs are this one
trajectory). SSRN's overfit is in ``test_torch_learning_ssrn.py`` and the
trajectory against JAX's in ``test_torch_learning_jax.py`` (xdist puts a
whole file on one worker). Slow, as in JAX: the bf16 and bfloat16_full
Text2Mel runs and the 1500-step quality check through the production
synthesis path.
"""
import jax
import numpy as np
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.train.steps import init_ssrn_state as jax_init_ssrn
from dc_tts_tpu.train.steps import init_text2mel_state as jax_init_t2m

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.params import from_jax_train_state
from dc_tts_tpu_torch.train import steps as TS

torch.set_num_threads(1)

CFG = test_config().replace(warmup_steps=50.0)


def structured_mels(cfg=CFG):
    """JAX's ``_structured_mels``: smooth per-example mel trajectories."""
    t = np.arange(cfg.max_T)
    return np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (i + 1) * t / cfg.max_T)[:, None]
        * np.cos(np.linspace(0, np.pi, cfg.n_mels))[None, :]
        for i in range(cfg.B)
    ]).astype(np.float32).clip(1e-8, 1)


def t2m_batch(cfg=CFG) -> dict:
    """JAX's Text2Mel batch: ids from ``PRNGKey(1)``, full lengths."""
    texts = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (cfg.B, cfg.max_N), 1, cfg.vocab_size))
    return {"texts": torch.as_tensor(texts),
            "mels": torch.as_tensor(structured_mels(cfg)),
            "text_lens": torch.full((cfg.B,), cfg.max_N, dtype=torch.int32),
            "mel_lens": torch.full((cfg.B,), cfg.max_T, dtype=torch.int32)}


def ssrn_batch(cfg=CFG) -> dict:
    """JAX's SSRN batch: mags a function of mels (frame repeat, channel
    tile)."""
    mels = structured_mels(cfg)
    up = np.repeat(mels, cfg.r, axis=1)
    reps = -(-cfg.n_freq // cfg.n_mels)
    mags = np.tile(up, (1, 1, reps))[:, :, :cfg.n_freq].astype(np.float32)
    return {"mels": torch.as_tensor(mels), "mags": torch.as_tensor(mags)}


def jax_initial_state(net: str, key: int, warmup_steps: float = 50.0):
    """The port's TrainState holding JAX's initial parameters and
    optimizer state for ``PRNGKey(key)``."""
    jcfg = jax_test_config().replace(warmup_steps=warmup_steps)
    init = jax_init_t2m if net == "t2m" else jax_init_ssrn
    state = init(jcfg, jax.random.PRNGKey(key))
    params, opt = from_jax_train_state(jax.device_get(state.params),
                                       jax.device_get(state.opt_state))
    return TS.TrainState(params, opt, 0)


def overfit(cfg, net: str, key: int, batch: dict, steps: int,
            record=()) -> dict:
    """``steps`` steps from JAX's initial state -> the metrics (floats) of
    step 1, of each step in ``record`` and of the last step."""
    make = TS.make_text2mel_step if net == "t2m" else TS.make_ssrn_step
    state, step = jax_initial_state(net, key), make(cfg)
    out = {}
    for i in range(1, steps + 1):
        state, m = step(state, batch, None)
        if i in (1, steps, *record):
            out[i] = {k: float(v) for k, v in m.items()}
    return out


@pytest.fixture(scope="module")
def t2m_run():
    return overfit(CFG, "t2m", 0, t2m_batch(), 400, record=(200,))


def test_text2mel_overfits_one_batch(t2m_run):
    first, final = t2m_run[1]["loss_mels"], t2m_run[400]["loss_mels"]
    # JAX's calibration: 0.25 -> ~0.04 by step 400 on this config
    assert final < 0.07, (first, final)
    assert final < first / 3
    assert t2m_run[400]["loss_att"] < 0.01


def test_attention_diagonality_improves_at_fixed_budget(t2m_run):
    """JAX's calibration (r5): 0.324 at init -> 0.094 at step 200."""
    first_diag = t2m_run[1]["attention_diagonality"]
    diag = t2m_run[200]["attention_diagonality"]
    assert diag < 0.18, (first_diag, diag)
    assert diag < first_diag / 1.6, (first_diag, diag)
    assert t2m_run[200]["loss_mels"] < 0.10


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16_full"])
def test_text2mel_reduced_precision_training_matches_f32_floor(dtype):
    """JAX's bf16 and bfloat16_full gates: the f32 floor 0.07 plus a pinned
    0.015 band."""
    run = overfit(CFG.replace(compute_dtype=dtype), "t2m", 0, t2m_batch(),
                  400)
    first, final = run[1]["loss_mels"], run[400]["loss_mels"]
    assert np.isfinite(final)
    assert final < 0.085, (first, final)
    assert final < first / 3
    assert run[400]["loss_att"] < 0.01


@pytest.mark.slow
def test_trained_nets_through_production_bench_path():
    """tests/test_quality_e2e.py on the port: train both networks 1500
    steps on one utterance from JAX's initial parameters, then synthesize
    through the bench's configuration (pcm16, the chunked path with a
    padded last chunk, K1 "highest" and K2's plain versions on the CPU)
    and pin the output's mel-spectral match against the target; the float
    waveform path gives the same quality."""
    from dc_tts_tpu_torch.pipeline import Synthesizer
    from dc_tts_tpu_torch.scripts import overfit_demo as demo

    cfg = demo.demo_config()
    assert cfg.stft_method == "dft_pallas2"
    data = demo.utterance(cfg)
    s1 = jax_initial_state("t2m", 0, warmup_steps=200.0)
    s2 = jax_initial_state("ssrn", 1, warmup_steps=200.0)
    s1, s2, m1, m2 = demo.train(cfg, data, 1500, s1, s2, "cpu")
    assert m1["loss_mels"] < 0.08, "t2m failed to overfit"
    assert m2["loss_mags"] < 0.08, "ssrn failed to overfit"

    r = demo.evaluate(cfg, data, s1.params, s2.params, "cpu")
    assert np.isfinite(r["wav"]).all() and np.abs(r["wav"]).max() > 1e-3
    # JAX's calibration: corr ~0.8, L1 ~0.07 on this config
    assert r["corr"] > 0.6, f"mel correlation {r['corr']:.3f}"
    assert r["l1"] < 0.12, f"mel L1 {r['l1']:.3f}"

    with torch.no_grad():
        synth = Synthesizer(cfg, s1.params, s2.params, device="cpu")
        w32 = synth.synthesize_ids(data["ids"])[0][0].numpy()
    corr32, l1_32 = demo.spectral_match(cfg, data, w32)
    assert abs(r["corr"] - corr32) < 0.02, (r["corr"], corr32)
    assert abs(r["l1"] - l1_32) < 0.01, (r["l1"], l1_32)

