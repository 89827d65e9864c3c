"""Synthesis time per Griffin-Lim method and conv precision, the port of
``scripts/bench_variants.py``:
``python -m dc_tts_tpu_torch.scripts.bench_variants [--device cpu] [--tiny]``.

The 40 Harvard sentences in one batch through a seeded-weight
``Synthesizer`` for each ``stft_method`` (all 8) with float32 convs, and
``dft_3x`` with bf16 conv operands (``compute_dtype="bfloat16"``). SSRN
runs at the config's ``compute_dtype`` (``ssrn_precision="highest"``), as
the JAX script applies SSRN directly. Each variant's time is the best of
``--reps`` runs after one warm-up, on the host clock, fenced by copying the
waveforms' float32 sum to the host. ``BENCH_ONLY="dft_mixed,pallas"`` runs
the variants whose label holds one of the comma-separated substrings.
Prints one line a variant.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time


def chosen(items, only: str) -> list:
    """The (label, ...) items whose label holds one of ``only``'s
    comma-separated substrings (``BENCH_ONLY``); every item for an empty
    ``only``."""
    keys = [k.strip() for k in only.split(",") if k.strip()]
    return [it for it in items if not keys or any(k in it[0] for k in keys)]


def variants(base) -> list:
    """(label, config) of every variant, in the JAX script's order."""
    return [
        ("fft GL, f32 convs", base.replace(stft_method="fft")),
        ("dft GL, f32 convs", base.replace(stft_method="dft")),
        ("dft_3x GL, f32 convs", base.replace(stft_method="dft_3x")),
        ("dft_mixed GL, f32 convs", base.replace(stft_method="dft_mixed")),
        ("dft_pallas2 GL, f32 convs (default)",
         base.replace(stft_method="dft_pallas2")),
        ("dft_pallas GL, f32 convs", base.replace(stft_method="dft_pallas")),
        ("ct GL, f32 convs", base.replace(stft_method="ct")),
        ("dft_bf16 GL, f32 convs", base.replace(stft_method="dft_bf16")),
        ("dft_3x GL, bf16 convs", base.replace(stft_method="dft_3x",
                                               compute_dtype="bfloat16")),
    ]


def bench(cfg, ids, device, reps: int = 3) -> dict:
    """Best seconds of synthesizing ``ids`` and the audio-s/s it gives."""
    from ..bench import seeded_synthesizer
    synth = seeded_synthesizer(cfg, device, ssrn_precision="highest")
    best = float("inf")
    for i in range(reps + 1):
        t0 = time.perf_counter()
        wav = synth.synthesize_ids(ids)[0]
        total = float(wav.float().sum())
        if i:
            best = min(best, time.perf_counter() - t0)
    if not math.isfinite(total):
        raise RuntimeError(f"{cfg.stft_method}: the waveforms are not "
                           "finite")
    return {"seconds": best, "audio_s_per_s": wav.numel() / cfg.sr / best}


def main(argv=None) -> int:
    from ..bench import bench_ids
    from ..config import base_config, test_config
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = test_config() if args.tiny else base_config()
    ids = bench_ids(base, 40)
    print(f"batch {ids.shape[0]}, {device}", flush=True)
    for label, cfg in chosen(variants(base),
                             os.environ.get("BENCH_ONLY", "")):
        r = bench(cfg, ids, device, args.reps)
        print(f"{label:42s} {r['seconds']:9.4f}s  "
              f"{r['audio_s_per_s']:10.1f} audio-s/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
