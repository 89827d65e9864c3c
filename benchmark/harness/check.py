"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference (``reference/dctts.py``) on the inputs the
benchmark made, each number against its limit in ``checks/<cell>.json``
(the numbers a cell compares are the ones that file names).

The reference judges in float64. Synthesis: it decodes the sampled rows
on the cursors that the program's attention chose (its own argmax of each
row), so that every step is compared from the same cursor state; at random
weights attention rows hold near-ties that rounding flips. Numbers: ``Y``
and ``A``, the largest differences of the mels and the attention; ``Z``,
that of SSRN run by the reference on its own Y; ``wav_median`` and
``wav_q75``, the median and the 75th percentile of the rows' relative L2
distances of the pcm16 waveforms on the host from the reference's chain
(Griffin-Lim in float64 on its own Z, de-emphasis, quantisation): a fault
in the vocoder on a quarter of the sampled rows moves the second, while a
row or two that fifty rounds carry further from the reference than the
others, as sound runs have, does not. Recorded beside them: ``cursor_gap``, the most by which the reference's probability at
the program's chosen key lies below its best (``A`` bounds it), and
``wav``, all rows pooled.

Training. The reference follows the checked steps from the same parameters
and batches, with the dropout masks drawn as the program documents: the
steps' losses (``loss``, the worst relative gap; ``loss_first``, the first
step's), the first step's clipped gradient and the parameters' change
after the last checked step as per-leaf norms, a leaf's gap over the
larger of its and the median leaf's reference norm: ``grad`` and
``change`` the worst leaf's, ``grad_median`` and ``change_median`` the
median leaf's. Leaves whose first gradient is under a thousandth of the
median leaf's move by round-off under Adam and are left out of the change.

The control (``tools/calibrate.py``) is the reference put in the program's
place in float32 with TF32 on, judged by the same numbers."""
from __future__ import annotations

import contextlib
import gc
import statistics

import numpy as np
import torch

from ..reference import dctts as R
from . import inputs


@contextlib.contextmanager
def tf32(on: bool):
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = on
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = was


def release(device) -> None:
    """Frees what the collector and the card's caching allocator hold."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _params(cfg, network, seed, device, dtype=torch.float64):
    return {k: v.to(dtype) for k, v in
            inputs.make_params(cfg, network, seed, device).items()}


def synth_readings(cfg: dict, seed: int, ids, Y, A, Z, wav, device) -> dict:
    """The numbers of one sample of synthesised rows."""
    with tf32(False):
        p = _params(cfg, "text2mel", seed, device)
        ids_t = torch.as_tensor(ids, device=device)
        cursors = A.argmax(1)
        Yr, Ar = R.decode(cfg, p, ids_t, cursors)
        chosen = Ar.gather(1, cursors[:, None, :].to(device))[:, 0]
        out = {"cursor_gap": float((Ar.max(1).values - chosen).max()),
               "Y": float((Y.to(device) - Yr).abs().max()),
               "A": float((A.to(device) - Ar).abs().max())}
        del p, Ar
        Zr = R.ssrn_apply(cfg, _params(cfg, "ssrn", seed, device), Yr)
        out["Z"] = float((Z.to(device) - Zr).abs().max())
        wr = R.vocode(cfg, Zr).astype(np.float64)
    d = np.asarray(wav, np.float64) - wr
    out["wav"] = float(np.linalg.norm(d) / max(np.linalg.norm(wr), 1.0))
    rows = np.sort(np.linalg.norm(d, axis=1) / np.maximum(
        np.linalg.norm(wr, axis=1), 1.0))
    out["wav_median"] = float(np.median(rows))
    out["wav_q75"] = float(np.quantile(rows, 0.75))
    return out


def synth_control(cfg: dict, seed: int, ids, device,
                  tf32_on: bool = True) -> dict:
    """The reference in the program's place, in float32 with matmuls in
    TF32 (without, a witness of what float32 itself reads), Griffin-Lim in
    float32, judged as the program is."""
    with tf32(tf32_on):
        p = _params(cfg, "text2mel", seed, device, torch.float32)
        Y, A = R.decode(cfg, p, torch.as_tensor(ids, device=device))
        Z = R.ssrn_apply(cfg, _params(cfg, "ssrn", seed, device,
                                      torch.float32), Y)
        wav = R.vocode(cfg, Z, torch.float32)
        del p
    return synth_readings(cfg, seed, ids, Y, A, Z, wav, device)


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v)) for k, v in d.items()}


def reference_training(cfg: dict, network: str, seed: int, drop_seed: int,
                       batches, device, tf32_on: bool = False,
                       dtype=torch.float64) -> dict:
    """Losses, first clipped gradient's and change's per-leaf norms of the
    reference over ``batches``, in ``dtype`` (float32 for the control)."""
    with tf32(tf32_on):
        p0 = _params(cfg, network, seed, device, dtype)
        batches = [{k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in b.items()} for b in batches]
        tr = R.Trainer(cfg, network, p0, drop_seed)
        losses = []
        for i, b in enumerate(batches):
            loss, g = tr.step(b)
            losses.append(loss)
            if i == 0:
                grads = _norms(g)
            del g
        change = _norms({k: tr.p[k].detach() - p0[k] for k in p0})
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def leaf_gaps(run: dict, ref: dict) -> dict:
    """{"grad": {leaf: gap}, "change": {leaf: gap}}: each leaf's norm's gap
    from the reference's over the larger of that leaf's and the median
    leaf's reference norm; ``change`` over the leaves whose first gradient
    is at least a thousandth of the median leaf's."""
    g_ref = ref["grad_norms"]
    med_g = statistics.median(g_ref.values())
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
    c_ref = ref["change_norms"]
    med_c = statistics.median(c_ref[k] for k in moved)
    return {"grad": {k: abs(run["grad_norms"][k] - g) / max(g, med_g)
                     for k, g in g_ref.items()},
            "change": {k: abs(run["change_norms"][k] - c_ref[k])
                       / max(c_ref[k], med_c) for k in moved}}


def train_readings(run: dict, ref: dict) -> dict:
    """The numbers of a run (losses, grad_norms, change_norms) against the
    reference's: ``loss`` over the checked steps and ``loss_first`` of the
    first alone; ``grad`` and ``change`` the worst leaf's, ``grad_median``
    and ``change_median`` the median leaf's."""
    gaps = leaf_gaps(run, ref)
    loss = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                 ref["losses"])]
    return {"loss": max(loss), "loss_first": loss[0],
            "grad": max(gaps["grad"].values()),
            "grad_median": statistics.median(gaps["grad"].values()),
            "change": max(gaps["change"].values()),
            "change_median": statistics.median(gaps["change"].values())}


def verdict(readings: dict, limits: dict):
    """(correct, failed numbers, {name: {"value", "limit"}}); a number with
    no limit, or no reading, fails."""
    out, failed = {}, 0
    for name, lim in limits.items():
        v = readings.get(name)
        ok = v is not None and np.isfinite(v) and v <= lim["limit"]
        failed += not ok
        out[name] = {"value": v, "limit": lim["limit"]}
    return failed == 0, failed, out
