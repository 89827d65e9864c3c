"""Weak scaling of data-parallel synthesis, the port of
``scripts/scaling_bench.py``.

    torchrun --nproc-per-node N -m dc_tts_tpu_torch.scripts.scaling_bench
    python -m dc_tts_tpu_torch.scripts.scaling_bench --device cpu --tiny

For each mesh size s = 1, 2, 4, ... up to the world size, the first s ranks
form ``parallel.make_mesh(data=s)`` and synthesize ``SCALE_PER_DEV_BATCH``
(8) rows a rank through ``Synthesizer(mesh=)``: seeded random weights,
seeded random ids, rows [0, 8 s) of one array, so rank 0's rows are the
same at every size. Each size's time is the best of 3 runs after one
warm-up, on the host clock, ended by the gathered waveforms' float32 sum
on the host. Rank 0 prints audio-s/s and the scaling efficiency (rate / (s
x size 1's rate)) a size. One rank a device: NCCL under ``torchrun`` on
cards, gloo with ``--device cpu``; without ``torchrun`` one rank.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def sizes(n: int) -> list:
    """1, 2, 4, ... up to ``n``."""
    return [1 << k for k in range(n.bit_length()) if 1 << k <= n]


def run(rank: int, n: int, tiny: bool = False, per_dev: int = 8,
        device="cuda", reps: int = 3) -> list:
    """Every mesh size on this rank (every rank of the world calls it) ->
    per size: s, the batch, best seconds, audio-s/s, efficiency and, on
    rank 0, the gathered waveforms (host numpy); the sizes whose mesh
    leaves this rank out give None."""
    from ..config import base_config, test_config
    from ..models.ssrn import SSRN
    from ..models.text2mel import Text2Mel
    from ..parallel.mesh import make_mesh
    from ..pipeline import Synthesizer

    cfg = test_config() if tiny else base_config()
    gen = torch.Generator().manual_seed(0)
    p1, p2 = Text2Mel(cfg).init(gen), SSRN(cfg).init(gen)
    ids_all = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (per_dev * n, cfg.max_N)).astype(np.int32)
    out, base_rate = [], None
    for s in sizes(n):
        mesh = make_mesh(data=s, ranks=range(s))          # collective
        if mesh.coords is None:
            out.append(None)
            continue
        synth = Synthesizer(cfg, p1, p2, device=device, mesh=mesh)
        ids = ids_all[: per_dev * s]
        best = float("inf")
        for i in range(reps + 1):
            t0 = time.perf_counter()
            wav = synth.synthesize_ids(ids)[0]
            total = float(wav.float().sum())
            if i:
                best = min(best, time.perf_counter() - t0)
        if not np.isfinite(total):
            raise RuntimeError(f"size {s}: the waveforms are not finite")
        rate = wav.numel() / cfg.sr / best
        base_rate = base_rate or rate
        r = {"devices": s, "batch": int(ids.shape[0]), "seconds": best,
             "audio_s_per_s": rate, "efficiency": rate / (base_rate * s),
             "wav": wav.cpu().numpy() if rank == 0 else None}
        if rank == 0:
            print(f"devices={s:2d}  batch={r['batch']:3d}  {best:8.4f}s  "
                  f"{rate:10.1f} audio-s/s  scaling-eff "
                  f"{100 * r['efficiency']:5.1f}%", flush=True)
        out.append(r)
    return out


def main(argv=None) -> int:
    from ..device import resolve_device
    from ..parallel import distributed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    distributed.initialize(device=device)
    rank, n = distributed.world()
    if rank == 0:
        print(f"{device}, {n} ranks, per-device batch "
              f"{os.environ.get('SCALE_PER_DEV_BATCH', '8')}", flush=True)
    run(rank, n, args.tiny, int(os.environ.get("SCALE_PER_DEV_BATCH", "8")),
        device)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
