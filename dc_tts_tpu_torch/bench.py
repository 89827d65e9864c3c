"""Synthesis throughput on one card, the port of the repository's
``bench.py``: ``python -m dc_tts_tpu_torch.bench [--device cpu] [--tiny]``.

Metric: audio-seconds of speech synthesized per wall-clock second per card,
for the whole chain text -> Text2Mel's 210-step decode (kernel K1, fused,
"highest") -> SSRN -> 50 Griffin-Lim rounds (kernel K2, "dft_pallas2") ->
16-bit PCM quantised on the device, delivered to the host.

Workload (``bench.py``'s): ``BENCH_SENTENCES`` (720) sentences tiled from
``harvard_sentences.txt``, in chunks of ``BENCH_CHUNK`` (72) rows through
``Synthesizer.synthesize_ids_chunked``, the median of ``BENCH_REPS`` (5)
reps after one warm-up chunk; seeded random weights (a ``torch.Generator``;
throughput does not depend on the weights: every utterance decodes the
whole frame grid). The device channel runs the same chain per chunk,
reduces each chunk's waveforms to a float32 sum on the device, enqueues
every chunk and then waits on the scalars: no waveform crosses to the
host. ``vs_baseline`` divides by ``baseline_cpu.json``'s CPU figure (read
only). A failure raises (there is no fallback to another ``stft_method``);
a run still going after ``BENCH_WATCHDOG_S`` seconds prints an ``error``
line and exits 2.

Prints one JSON line: ``bench.py``'s keys and ``card``, the card's name and
power limit from nvidia-smi ("cpu" under ``--device cpu``, whose figures
are the CPU's, not a card's). Numbers are printed unrounded.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "audio_seconds_per_second_per_chip"
# bench.py's fallback when baseline_cpu.json is absent
DEFAULT_CPU_BASELINE_AUDIO_S_PER_S = 0.5


def _watchdog(seconds: float) -> threading.Timer:
    """A run that hangs prints an error line (no value) and exits 2."""
    def fire():
        print(json.dumps({"metric": METRIC, "unit": "audio-s/s",
                          "error": f"no result after {seconds:.0f} s "
                                   "(watchdog)"}), flush=True)
        os._exit(2)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def card_name(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bench_ids(cfg, n_total: int) -> np.ndarray:
    """The first ``n_total`` of the Harvard sentences tiled, encoded."""
    from . import text as text_mod
    sents = text_mod.load_test_sentences(
        os.path.join(ROOT, "harvard_sentences.txt"))
    reps = -(-n_total // len(sents))
    return text_mod.encode_batch((sents * reps)[:n_total], cfg)


def seeded_nets(cfg):
    """Seeded random (Text2Mel, SSRN) parameters on the CPU: seed 0,
    Text2Mel drawn first (the bench's weights and chip_smoke.py's)."""
    import torch

    from .models.ssrn import SSRN
    from .models.text2mel import Text2Mel
    gen = torch.Generator().manual_seed(0)
    return Text2Mel(cfg).init(gen), SSRN(cfg).init(gen)


def seeded_synthesizer(cfg, device, **kw):
    """A Synthesizer on ``seeded_nets``' weights."""
    from .pipeline import Synthesizer
    return Synthesizer(cfg, *seeded_nets(cfg), device=device, **kw)


def device_pass(synth, ids: np.ndarray, chunk: int) -> list:
    """The chain on every chunk, each reduced to a float32 sum on the
    device; one wait for all the scalars at the end."""
    import torch
    sums = [synth._synthesize_rows(ids[i: i + chunk])[0].float().sum()
            for i in range(0, ids.shape[0], chunk)]
    return torch.stack(sums).cpu().tolist()


def run(cfg, device, n_total: int, chunk: int, n_reps: int) -> dict:
    """The benchmark; returns the JSON line's fields."""
    synth = seeded_synthesizer(cfg, device, pcm16=True)
    ids = bench_ids(cfg, n_total)
    synth.synthesize_ids_chunked(ids[:chunk], chunk)          # warm-up
    times = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        wavs = synth.synthesize_ids_chunked(ids, chunk)
        times.append(time.perf_counter() - t0)
    if wavs.dtype != np.int16 or wavs.shape[0] != ids.shape[0]:
        raise RuntimeError(f"synthesis returned {wavs.dtype} {wavs.shape} "
                           f"for {ids.shape[0]} sentences")
    audio_s = wavs.size / cfg.sr
    dt = float(np.median(times))

    device_pass(synth, ids[:chunk], chunk)                    # warm-up
    dev_times = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        sums = device_pass(synth, ids, chunk)
        dev_times.append(time.perf_counter() - t0)
    if not np.isfinite(sums).all():
        raise RuntimeError(f"the device channel's sums are not finite: "
                           f"{sums}")
    dt_dev = float(np.median(dev_times))

    baseline = DEFAULT_CPU_BASELINE_AUDIO_S_PER_S
    bl_path = os.path.join(ROOT, "baseline_cpu.json")
    if os.path.exists(bl_path):
        with open(bl_path) as f:
            baseline = json.load(f)["audio_s_per_s"]
    value = audio_s / dt
    return {
        "metric": METRIC,
        "value": value,
        "unit": "audio-s/s",
        "vs_baseline": value / baseline,
        # waveforms are quantised to 16-bit PCM on the device and copied
        # to the host as such: delivery is part of the metric
        "delivery": "pcm16",
        "value_device": audio_s / dt_dev,
        "rep_times_device_s": dev_times,
        "stft_method": cfg.stft_method,
        "sentences": int(ids.shape[0]),
        "chunk": chunk,
        "reps": n_reps,
        "rep_times_s": times,
        "rep_spread": (max(times) - min(times)) / dt,
        "card": card_name(synth.device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; no CPU fallback)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test config (CPU checks)")
    args = ap.parse_args(argv)
    watchdog = _watchdog(float(os.environ.get("BENCH_WATCHDOG_S", 1800)))
    try:
        from .config import base_config, test_config
        from .device import resolve_device
        cfg = test_config() if args.tiny else base_config()
        result = run(cfg, resolve_device(args.device),
                     int(os.environ.get("BENCH_SENTENCES", 720)),
                     int(os.environ.get("BENCH_CHUNK", 72)),
                     int(os.environ.get("BENCH_REPS", 5)))
    finally:
        watchdog.cancel()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
