"""The forward-rDFT prototypes X1-X4 on the card: the port of
``scripts/ct_kernel_exp.py``'s ``main`` and ``ablation_main``.

    python -m dc_tts_tpu_torch.scripts.ct_kernel_exp [variant] [prec] [iters]
        [--device cuda|cpu]
    python -m dc_tts_tpu_torch.scripts.ct_kernel_exp ablate

variant: ``full`` (X1), ``fact-swap`` (default) or ``fact-stack`` (X3),
``fact-tiled`` (X2, tiles of 512 frames); prec: ``f32`` or ``bf16``
(default); iters: calls timed (30). The environment variable ``CT_F``
(default 840) is the frame count; ``fact-tiled`` needs a multiple of 512.
Seeded frames (numpy ``default_rng(0)``) go through the kernel; it prints
the distance to numpy's float64 FFT over its max ("rel err") and, on the
card, the CUDA-event time per call and per launch inside one CUDA graph of
50 launches ("in-loop", the script's 50 rounds in one jit dispatch).
``ablate`` times X4 at each of the script's 8 stage sets (bf16, tiles of
512: at F = 840 only frames 0..511 are covered). It times kernels, so it
runs only on the card, as the script's ``ablate_fwd`` runs only on the TPU.
With ``--device cpu`` the plain versions run and nothing is timed.
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ct_fwd import (N_FFT, NF, STAGE_SETS, ablate_fwd, consts,
                          fact_fwd, fact_fwd_tiled, full_fwd, unscramble)

VARIANTS = ("full", "fact-swap", "fact-stack", "fact-tiled")


def timeit(fn, iters: int = 50) -> float:
    """Seconds per call of fn(): CUDA events around ``iters`` calls after
    two warm-up calls."""
    fn()
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def timeit_looped(kernel_fn, x, m, rounds: int = 50, reps: int = 5) -> float:
    """Seconds per launch of kernel_fn(x, m) with the host out of the way:
    ``rounds`` calls captured in one CUDA graph, replayed ``reps`` times
    after one warm-up replay. Stream order sequences the launches (the
    script's scalar feedback is not needed). A replay runs the kernels
    without calling the wrappers: (reps + 1) * rounds launches that no
    launch counter (``x1.launches`` ... ``x4.launches``) counts."""
    kernel_fn(x, m)     # builds and sets up the kernel outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            kernel_fn(x, m)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / (reps * rounds)


def kernel(variant: str, bf16: bool):
    """The wrapper a variant runs, as kernel_fn(x, m)."""
    if variant == "full":
        return lambda x, m: full_fwd(x, m, bf16)
    if variant == "fact-tiled":
        return lambda x, m: fact_fwd_tiled(x, m, bf16)
    if variant in ("fact-swap", "fact-stack"):
        mode = variant.split("-")[1]
        return lambda x, m: fact_fwd(x, m, bf16, mode)
    raise ValueError(f"variant: one of {VARIANTS}, got {variant!r}")


def frames(F: int) -> np.ndarray:
    """The seeded (F, 2048) float32 frames of both entry points."""
    return np.random.default_rng(0).standard_normal((F, N_FFT)).astype(
        np.float32)


def rel_err(variant: str, out, ref: np.ndarray) -> float:
    """max |kernel - FFT| / max |FFT| over the bins the variant gives (X1:
    the 1025 of the rDFT; the factored ones: all 2048, unscrambled)."""
    a, b = out
    if variant == "full":
        got, ref_ = a.cpu().numpy() + 1j * b.cpu().numpy(), ref[:, :NF]
    else:
        got = unscramble(a).cpu().numpy() + 1j * unscramble(b).cpu().numpy()
        ref_ = ref
    return float(np.abs(got - ref_).max() / np.abs(ref).max())


def run(variant: str, prec: str, iters: int, dev: torch.device, F: int):
    """The script's ``main`` for one variant and precision: prints and
    returns (rel err, s/call, s/launch in-loop), the times None off the
    card."""
    bf16 = prec == "bf16"
    kfn = kernel(variant, bf16)
    x_np = frames(F)
    x = torch.from_numpy(x_np).to(dev)
    ref = np.fft.fft(x_np.astype(np.float64), axis=-1)
    m = consts(bf16, dev)
    print(f"{datetime.datetime.now():%H:%M:%S} compiling {variant}/{prec}",
          flush=True)
    err = rel_err(variant, kfn(x, m), ref)
    print(f"[{variant}/{prec}] rel err {err:.2e}", flush=True)
    if dev.type != "cuda":
        return err, None, None
    t = timeit(lambda: kfn(x, m), iters)
    tl = timeit_looped(kfn, x, m)
    print(f"[{variant}/{prec}] {t*1e3:.3f} ms/call  "
          f"{tl*1e3:.3f} ms/call in-loop", flush=True)
    return err, t, tl


def ablation_main(dev: torch.device, F: int) -> dict:
    """The script's ``ablation_main``: X4 in bf16 with tiles of 512 at each
    stage set, s/launch in-loop; prints one line each."""
    x = torch.from_numpy(frames(F)).to(dev)
    m = consts(True, dev)
    times = {}
    for stages in STAGE_SETS:
        kfn = lambda x_, m_, s=stages: ablate_fwd(x_, m_, True, s)  # noqa
        times[stages] = t = timeit_looped(kfn, x, m)
        print(f"stages={stages or '-':5s} {t*1e3:.3f} ms/call", flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Forward-rDFT prototypes X1-X4 (CT_F frames, default "
                    "840)")
    ap.add_argument("variant", nargs="?", default="fact-swap",
                    choices=VARIANTS + ("ablate",))
    ap.add_argument("prec", nargs="?", default="bf16", choices=("f32", "bf16"))
    ap.add_argument("iters", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) runs the kernels; cpu the plain "
                         "versions, untimed")
    args = ap.parse_args(argv)
    F = int(os.environ.get("CT_F", "840"))
    if args.variant == "ablate":
        if args.device == "cpu":
            ap.error("ablate times the kernels on the card: it has no CPU "
                     "mode")
        ablation_main(resolve_device(args.device), F)
    else:
        run(args.variant, args.prec, args.iters, resolve_device(args.device),
            F)
    return 0


if __name__ == "__main__":
    sys.exit(main())
