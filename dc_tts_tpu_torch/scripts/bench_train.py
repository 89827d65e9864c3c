"""Training-step time per variant, the port of ``scripts/bench_train.py``:
``python -m dc_tts_tpu_torch.scripts.bench_train [defaults] [--device cpu]
[--tiny] [--iters N]``.

Times both networks' train steps at ``base_config()`` (B = 32, the full
180 x 210 grid) on synthetic batches already on the device (a step's cost
does not depend on the content), per variant: float32, ``bfloat16`` conv
operands, ``bfloat16_full``, float32 ``remat``, float32 with ``use_pallas``
(kernel K4), ``bfloat16`` with ``use_pallas`` (K4's bf16 body), and
float32 on the (104, 136) bucket. ``defaults`` times the training CLI's
three length buckets (72 x 96, 104 x 136 and the full grid, equal weights)
in float32, ``bfloat16`` and ``bfloat16_full``. Dropout draws from a
``torch.Generator`` (the JAX script's PRNG choice has no counterpart).

Per variant: pipelined ms/step (the best of three spans of ``--iters``
steps, one wait for the device at each span's end, as the training loop
never waits per step), the fenced per-step time (the best single step,
waiting for its loss), steps/s, examples/s and MFU: 3 x the forward's
algorithmic FLOPs over the H100's peak for the variant's products: float32
67 TFLOP/s; float32 ``use_pallas`` 495 / 3 TFLOP/s (K4 runs the HC blocks'
products, most of the FLOPs, on the tensor cores in three TF32 passes; the
rest run at the float32 rate, so against this peak the MFU reads low,
never high); the bf16 modes 989 TFLOP/s. A failing variant raises.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def synth_batch(cfg, seed: int, device, n=None, t=None) -> dict:
    """A seeded synthetic batch of the given (text, frame) lengths (the
    full grid by default), on the device."""
    n, t = n or cfg.max_N, t or cfg.max_T
    rng = np.random.default_rng(seed)
    batch = {
        "texts": rng.integers(1, cfg.vocab_size, (cfg.B, n)),
        "mels": rng.uniform(0, 1, (cfg.B, t, cfg.n_mels)).astype(np.float32),
        "mags": rng.uniform(0, 1, (cfg.B, t * cfg.r, cfg.n_freq)
                            ).astype(np.float32),
        "text_lens": np.full((cfg.B,), int(n * 0.6), np.int64),
        "mel_lens": np.full((cfg.B,), int(t * 0.8), np.int64),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def net_step(cfg, which: str, device):
    """(state, step, batch keys, forward FLOPs as a function of (N, T)) of
    one network, its state from seed 0."""
    from ..models.ssrn import ssrn_specs
    from ..models.text2mel import (audio_dec_specs, audio_enc_specs,
                                   text_enc_specs)
    from ..train import steps as TS
    from ..utils.profiling import conv_stack_flops

    gen = torch.Generator().manual_seed(0)
    if which == "t2m":
        def flops(n, t):
            return (conv_stack_flops(cfg.B, n, text_enc_specs(cfg), cfg.e)
                    + conv_stack_flops(cfg.B, t, audio_enc_specs(cfg),
                                       cfg.n_mels)
                    + conv_stack_flops(cfg.B, t, audio_dec_specs(cfg),
                                       2 * cfg.d))
        return (TS.init_text2mel_state(cfg, gen, device),
                TS.make_text2mel_step(cfg),
                ("texts", "mels", "text_lens", "mel_lens"), flops)
    return (TS.init_ssrn_state(cfg, gen, device), TS.make_ssrn_step(cfg),
            ("mels", "mags"),
            lambda n, t: conv_stack_flops(cfg.B, t, ssrn_specs(cfg),
                                          cfg.n_mels))


def _spans(step, state, b, gen, iters: int):
    """(state, best ms/step over three spans of ``iters`` steps, each ended
    by one wait for the device)."""
    span = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = step(state, b, gen)
        loss = float(metrics["loss"])
        span = min(span, time.perf_counter() - t0)
    if not np.isfinite(loss):
        raise RuntimeError(f"the loss is not finite: {loss}")
    return state, span / iters * 1e3


def bench_step(label: str, cfg, which: str, batch: dict, device,
               iters: int = 5) -> dict:
    """Pipelined and fenced ms/step of one variant; prints its line."""
    from ..utils.profiling import (H100_BF16_PEAK_FLOPS, H100_FP32_PEAK_FLOPS,
                                   H100_TF32_PEAK_FLOPS, mfu)
    state, step, keys, fwd_flops = net_step(cfg, which, device)
    b = {k: batch[k] for k in keys}
    gen = torch.Generator(device=device)
    state, metrics = step(state, b, gen)                      # warm-up
    float(metrics["loss"])
    state, pipelined = _spans(step, state, b, gen, iters)
    fenced = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        state, metrics = step(state, b, gen)
        float(metrics["loss"])
        fenced = min(fenced, (time.perf_counter() - t0) * 1e3)
    flops = 3 * fwd_flops(batch["texts"].shape[1], batch["mels"].shape[1])
    if cfg.compute_dtype.startswith("bfloat16"):
        passes, peak, of = 1, H100_BF16_PEAK_FLOPS, "989"
    elif cfg.use_pallas:                                   # K4's 3xTF32
        passes, peak, of = 3, H100_TF32_PEAK_FLOPS, "495/3"
    else:
        passes, peak, of = 1, H100_FP32_PEAK_FLOPS, "67"
    on_card = torch.device(device).type == "cuda"
    r = {"label": label, "ms_per_step": pipelined, "fenced_ms": fenced,
         "steps_per_s": 1e3 / pipelined,
         "examples_per_s": cfg.B * 1e3 / pipelined, "train_flops": flops,
         "mfu": (mfu(flops, pipelined / 1e3, passes, peak) if on_card
                 else None)}
    util = ("mfu not measured (CPU run)" if r["mfu"] is None else
            f"mfu {100 * r['mfu']:5.1f}% of {of} TFLOP/s")
    print(f"{label:34s} {pipelined:8.1f} ms/step  "
          f"{r['steps_per_s']:6.2f} steps/s {r['examples_per_s']:7.1f} ex/s"
          f"  {util}  (fenced {fenced:.1f} ms)", flush=True)
    return r


def bench_combo(label: str, cfg, which: str, shapes, device,
                iters: int = 5) -> dict:
    """Pipelined ms/step on each bucket shape, combined with equal weights
    (the buckets split a corpus into equal-count groups); prints its
    line."""
    times = []
    for n, t in shapes:
        state, step, keys, _ = net_step(cfg, which, device)
        batch = synth_batch(cfg, 7, device, n=n, t=t)
        b = {k: batch[k] for k in keys}
        gen = torch.Generator(device=device)
        state, metrics = step(state, b, gen)                  # warm-up
        float(metrics["loss"])
        times.append(_spans(step, state, b, gen, iters)[1])
    avg = sum(times) / len(times)
    per = "  ".join(f"({n},{t}) {ms:.1f}ms" for (n, t), ms
                    in zip(shapes, times))
    print(f"{label:34s} {avg:8.1f} ms/step  {1e3 / avg:6.2f} steps/s  "
          f"-> {2_000_000 * avg / 3.6e6:6.1f} h to 2M steps   [{per}]",
          flush=True)
    return {"label": label, "ms_per_step": avg, "bucket_ms": times}


def variants(cfg) -> list:
    """(label, network, config, bucket) of every variant; bucket None is
    the full grid."""
    out = []
    for which in ("t2m", "ssrn"):
        out += [
            (f"{which} f32", which, cfg, None),
            (f"{which} bf16 convs", which,
             cfg.replace(compute_dtype="bfloat16"), None),
            (f"{which} bf16_full (bf16 activations)", which,
             cfg.replace(compute_dtype="bfloat16_full"), None),
            (f"{which} f32 remat", which, cfg.replace(remat=True), None),
            (f"{which} f32 pallas-vjp", which, cfg.replace(use_pallas=True),
             None),
            (f"{which} bf16 pallas-vjp", which,
             cfg.replace(use_pallas=True, compute_dtype="bfloat16"), None),
            (f"{which} f32 bucket(104,136)", which, cfg, (104, 136)),
        ]
    return out


def run(cfg, device, iters: int = 5) -> list:
    """Every variant -> their results."""
    print(f"{device}, B={cfg.B}, full grid ({cfg.max_N}, {cfg.max_T})",
          flush=True)
    full = synth_batch(cfg, 7, device)
    out = []
    for label, which, vcfg, bucket in variants(cfg):
        batch = full if bucket is None else synth_batch(
            cfg, 7, device, n=min(bucket[0], cfg.max_N),
            t=min(bucket[1], cfg.max_T))
        out.append(bench_step(label, vcfg, which, batch, device, iters))
    return out


def run_defaults(cfg, device, iters: int = 5) -> list:
    """The CLI's three buckets in each --dtype -> their results."""
    shapes = [(min(72, cfg.max_N), min(96, cfg.max_T)),
              (min(104, cfg.max_N), min(136, cfg.max_T)),
              (cfg.max_N, cfg.max_T)]
    print(f"{device}, B={cfg.B}, bucket shapes {shapes}", flush=True)
    items = []
    for which in ("t2m", "ssrn"):
        items += [(f"{which} DEFAULTS (f32+buckets)", which, cfg),
                  (f"{which} bf16+buckets", which,
                   cfg.replace(compute_dtype="bfloat16")),
                  (f"{which} bf16_full+buckets", which,
                   cfg.replace(compute_dtype="bfloat16_full"))]
    return [bench_combo(label, c, which, shapes, device, iters)
            for label, which, c in items]


def main(argv=None) -> int:
    from ..config import base_config, test_config
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?", default="variants",
                    choices=["variants", "defaults"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = test_config() if args.tiny else base_config()
    fn = run_defaults if args.what == "defaults" else run
    fn(cfg, device, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
