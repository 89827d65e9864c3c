"""SSRN training against the benchmark's plain references
(``benchmark/reference/``) at ``test_config()`` sizes, on seeded random
weights (the benchmark's ``make_params``: biases, shifts and gains' offsets
at std 0.1) and batches, dropout on: three steps of the port, then the
reference's three steps from the same parameters, batches and dropout
masks, compared on the losses, every leaf of the first step's clipped
gradient and every parameter's change after the third step.

Cases: the port at ``compute_dtype="bfloat16"`` with every HC block through
K4 (its plain path on the CPU) against the reference with bf16 operands
(``dctts_bf16``), and the port at float32 against the float64 reference
(``dctts``): both within the tolerances; the float8-operand control
(``dctts_bf16`` at float8 e4m3) in the port's place against the bf16
reference: outside at least one. The numbers are the benchmark's own
(``benchmark/harness/check.train_readings``). Also K4's counted work
(``benchmark/harness/k4_work.py``) at SSRN's published widths."""
import pytest
import torch

from benchmark.harness import check, inputs, k4_work, work
from benchmark.reference import dctts as R
from benchmark.reference import dctts_bf16 as Q
from dc_tts_tpu_torch.config import Config, test_config
from dc_tts_tpu_torch.params import requires_grad
from dc_tts_tpu_torch.train import steps as TS
from dc_tts_tpu_torch.train.optimizer import B1, init_opt_state

torch.set_num_threads(1)

CFG = test_config().replace(dropout_rate=0.05)
SIZES = {k: getattr(CFG, k) for k in Config.__dataclass_fields__}
SIZES["vocab"] = CFG.vocab
SEED, DROP_SEED = 2 ** 31 + 41, 977

# Tolerances on ``benchmark/harness/check.train_readings``' numbers, the
# ones a training cell's limits hold (in brackets over seeds 2**31 + 40 ...
# 47: the bf16 port's largest reading; the float8 control's least; the
# float32 port's largest against the float64 reference):
TOL = {
    # the losses' largest relative gap: float32 sums against float64 ones,
    # and the bf16 roundings that float32 noise flips (3.15e-5; 1.96e-4;
    # 1.6e-7)
    "loss": 1e-4,
    # a gradient leaf's norm's gap over the larger of its and the median
    # leaf's norm, the worst leaf (0.030; 0.132; 9.3e-7): the L1 loss's
    # gradient is the sign of Z - mags, so an element of Z within rounding
    # noise of its target takes either sign
    "grad": 0.08,
    # the same, the median leaf (2.51e-3; 1.85e-2; 1.2e-7)
    "grad_median": 7.5e-3,
    # a parameter's change after the third step, the same measure over the
    # leaves that move, the worst leaf (0.033; 0.082; 0.027): Adam's first
    # steps move each element about a learning rate whatever the precision,
    # so float32 reads near bf16 and the control does not clear it; set
    # against a state left unchanged, which reads 1
    "change": 0.1,
    # the same, the median leaf (5.0e-3; 1.64e-2; 1.5e-3)
    "change_median": 1.2e-2,
}


def _batches(seed: int):
    """A batch of B rows per bucket of (T mel frames): mels and mags in
    [0, 1), zero past each row's length."""
    gen = torch.Generator().manual_seed(seed)
    out, r, B = [], CFG.r, CFG.B
    for T in (10, 16, CFG.max_T):
        lens = torch.randint(T // 2, T + 1, (B,), generator=gen)
        ok = torch.arange(T)[None] < lens[:, None]
        okf = torch.arange(r * T)[None] < r * lens[:, None]
        out.append({"mels": torch.rand(B, T, CFG.n_mels, generator=gen)
                    * ok[..., None],
                    "mags": torch.rand(B, r * T, CFG.n_freq, generator=gen)
                    * okf[..., None]})
    return out


def _port(seed: int, compute_dtype: str, use_pallas: bool, batches):
    """(losses, first clipped gradient, change) of the port's steps."""
    cfg = CFG.replace(compute_dtype=compute_dtype, use_pallas=use_pallas)
    p0 = inputs.make_params(SIZES, "ssrn", seed, "cpu")
    params = inputs.to_tree({k: v.clone() for k, v in p0.items()})
    requires_grad(params)
    state = TS.TrainState(params, init_opt_state(params), 0)
    step = TS.make_ssrn_step(cfg, seed=DROP_SEED)
    gen = torch.Generator()
    losses = []
    for i, b in enumerate(batches):
        state, metrics = step(state, b, gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad = {k: v / (1 - B1) for k, v in inputs.flatten(
                state.opt_state[1]["mu"]).items()}
    p = inputs.flatten(state.params)
    return losses, grad, {k: p[k].detach().double() - p0[k].double()
                          for k in p0}


def _reference(seed: int, fmt, batches):
    """The same of the reference (operands rounded to ``fmt``; None: the
    float64 reference itself)."""
    p0 = {k: v.double() for k, v in
          inputs.make_params(SIZES, "ssrn", seed, "cpu").items()}
    batches = [{k: v.double() for k, v in b.items()} for b in batches]
    tr = R.Trainer(SIZES, "ssrn", p0, DROP_SEED) if fmt is None else \
        Q.Trainer(SIZES, "ssrn", p0, DROP_SEED, fmt)
    losses = []
    for i, b in enumerate(batches):
        loss, g = tr.step(b)
        losses.append(loss)
        if i == 0:
            grad = g
    return losses, grad, {k: tr.p[k].detach() - p0[k] for k in p0}


def _norms(run) -> dict:
    """The losses and per-leaf norms that ``check.train_readings`` takes."""
    losses, grad, change = run
    return {"losses": losses, "grad_norms": check._norms(grad),
            "change_norms": check._norms(change)}


CASES = {"bf16_k4": ("bfloat16", True, torch.bfloat16),
         "float32": ("float32", False, None)}


@pytest.mark.parametrize("case", ["bf16_k4", "float32", "float8_control"])
def test_ssrn_steps_against_reference(case):
    batches = _batches(SEED)
    if case == "float8_control":
        run = _reference(SEED, torch.float8_e4m3fn, batches)
        ref = _reference(SEED, torch.bfloat16, batches)
    else:
        dtype, pallas, fmt = CASES[case]
        run = _port(SEED, dtype, pallas, batches)
        ref = _reference(SEED, fmt, batches)
    got = check.train_readings(_norms(run), _norms(ref))
    print(case, got)
    within = {k: got[k] <= TOL[k] for k in TOL}
    if case == "float8_control":
        assert not all(within.values()), got
    else:
        assert all(within.values()), got


def test_k4_work_at_published_widths():
    """SSRN's 8 HC blocks at B 32 and 210 mel frames: widths 512 twice at
    210, 420 and 840 frames and 1024 at 840; the last ones' forward 2 * 32
    * 840 * 3072 * 2048 FLOPs, 338.2 GFLOP, 0.342 ms at 989 TFLOP/s."""
    cfg = {"n_mels": 80, "c": 512, "n_fft": 2048}
    blocks = k4_work.hc_blocks(cfg, 210)
    assert blocks == [(3, 512, 210)] * 2 + [(3, 512, 420)] * 2 + \
        [(3, 512, 840)] * 2 + [(3, 1024, 840)] * 2
    w = k4_work.hc_work(32, 840, 3, 1024)
    assert w["fwd"][0] == 2 * 32 * 840 * 3072 * 2048 == 338_228_674_560
    assert w["bwd"][0] == 2 * w["fwd"][0]
    act = 4 * 32 * 840 * 1024
    par = 4 * (3 * 1024 * 2048 + 6 * 1024)
    assert w["fwd"][1] == 2 * act + par and w["bwd"][1] == 3 * act + 2 * par
    least = k4_work.least_seconds(cfg, 32, 210)
    flops = sum(3 * k4_work.hc_work(32, t, K, C)["fwd"][0]
                for K, C, t in blocks)
    assert least == pytest.approx(flops / work.PEAK_FLOPS, rel=1e-12)
    assert least * 1e3 == pytest.approx(2.9497, abs=1e-4)
