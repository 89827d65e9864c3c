"""Device times of K1 and X1-X4 alone, on one CUDA card, for comparing two
builds of the port in one call.

    python -m dc_tts_tpu_torch.scripts.kernel_times k1 [--package DIR]
    python -m dc_tts_tpu_torch.scripts.kernel_times ct [--package DIR]

``k1``: the decode kernel in "highest" at base_config(), B = 20 (the first
20 Harvard sentences, seeded random weights), T = 210: CUDA-event ms a
launch over 5 launches after one warm-up, and the sum of Y (two builds that
compute the same bits print the same sum). ``ct``: X1-X4 at the smoke's
sizes (840 seeded frames; X4 at tiles of 512, stage sets "", "T", "TAW",
"TAWC"), both precisions: torch.profiler's device µs a call over 20 calls,
by kernel (the wrapper's zero fills apart). ``--package DIR`` imports
dc_tts_tpu_torch from DIR (a ``git archive`` of another commit) instead of
this one. Prints one line per reading; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys


def _k1() -> None:
    import torch
    from dc_tts_tpu_torch import text
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models import Text2Mel
    from dc_tts_tpu_torch.ops import decode as K1

    cfg, dev = base_config(), torch.device("cuda")
    model = Text2Mel(cfg)
    params = model.init(torch.Generator().manual_seed(1), dev)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sents = text.load_test_sentences(os.path.join(root,
                                                  "harvard_sentences.txt"))
    ids = torch.as_tensor(text.encode_batch(sents[:20], cfg), device=dev)
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
        packed = K1.pack_decode_params(cfg, params)
        run = lambda: K1.fused_decode(packed, Kt, V, cfg.max_T, cfg)  # noqa
        Y, _ = run()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
    print(f"[k1] ms={start.elapsed_time(end) / 5:.3f} "
          f"sum_Y={float(Y.double().sum()):.6f}", flush=True)


def _ct() -> None:
    import numpy as np
    import torch
    from dc_tts_tpu_torch.ops import ct_fwd as X

    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (840, 2048)).astype(np.float32)).to(dev)
    for bf16 in (True, False):
        m = X.consts(bf16, dev)
        cases = {"X1": lambda: X.full_fwd(x, m, bf16),
                 "X3": lambda: X.fact_fwd(x, m, bf16),
                 **{f"X4-{st or '-'}": (lambda st=st: X.ablate_fwd(
                     x, m, bf16, st, 512)) for st in ("", "T", "TAW", "TAWC")}}
        for name, fn in cases.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            times = {e.key[:48]: e.device_time_total / 20
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA}
            parts = " ".join(f"[{k}]={v:.2f}" for k, v in sorted(
                times.items(), key=lambda kv: -kv[1]))
            print(f"[ct] {'bf16' if bf16 else 'f32'} {name} "
                  f"total_us={sum(times.values()):.2f} {parts}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("k1", "ct"))
    ap.add_argument("--package", default="")
    args = ap.parse_args(argv)
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
        for name in [n for n in sys.modules if n.startswith(
                "dc_tts_tpu_torch")]:
            del sys.modules[name]
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from dc_tts_tpu_torch.device import fp32_numerics
    fp32_numerics()
    import dc_tts_tpu_torch
    print(f"[package] {os.path.dirname(dc_tts_tpu_torch.__file__)}",
          flush=True)
    _k1() if args.what == "k1" else _ct()
    return 0


if __name__ == "__main__":
    sys.exit(main())
