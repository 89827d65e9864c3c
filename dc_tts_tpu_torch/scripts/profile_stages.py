"""Per-stage time of the synthesis chain, the port of
``scripts/profile_stages.py``:
``python -m dc_tts_tpu_torch.scripts.profile_stages [--device cpu] [--tiny]``.

The 40 Harvard sentences in one batch through a seeded-weight
``Synthesizer`` (pcm16; K1 "highest", SSRN "high", ``cfg.stft_method``),
run stage by stage as the Synthesizer chains them: TextEnc, the decode (K1),
SSRN, denormalize + Griffin-Lim (K2 by default), de-emphasis + pcm16. On the
card each stage is timed with CUDA events (the best of ``--reps`` runs);
under ``--device cpu`` with the host clock. Prints each stage's ms and share,
then its algorithmic FLOPs (``utils/profiling``'s counters, the JAX
package's; Griffin-Lim's FFT methods as real FFTs) and its MFU against the
H100's peak for the arithmetic the stage runs: float32 (67 TFLOP/s) for
TextEnc, the decode and Griffin-Lim's float32 methods; SSRN's 3-pass bf16
split and the bf16 Griffin-Lim methods at the dense bf16 peak (989
TFLOP/s) times their passes.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

STAGES = ("text_enc_ms", "decode_k1_ms", "ssrn_ms", "griffin_lim_ms",
          "deemph_pcm16_ms")


def stage_times(synth, ids):
    """Milliseconds of each stage of ``synthesize_ids`` on one batch, run
    stage by stage as the Synthesizer chains them (CUDA events on the card,
    the host clock on the CPU), and the batch's int16 waveforms."""
    from ..dsp.features import deemphasis
    from ..dsp.griffin_lim import denormalize_mag, griffin_lim
    from ..ops import decode as K1

    cfg, p = synth.cfg, synth.t2m_params
    cuda = synth.device.type == "cuda"
    if cuda:
        def mark():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
    else:
        mark = time.perf_counter
    with torch.no_grad():
        ids = torch.as_tensor(ids, device=synth.device)
        if cuda:
            torch.cuda.synchronize()
        ev = [mark()]
        Kt, V = synth.text2mel.text_encode(p, ids)
        ev.append(mark())
        Y, _ = K1.fused_decode(synth.packed, Kt.contiguous(),
                               V.contiguous(), cfg.max_T, cfg,
                               synth.decode_prec)
        ev.append(mark())
        _, Z = synth.ssrn.apply(synth.ssrn_params, Y)
        ev.append(mark())
        wav = griffin_lim(denormalize_mag(Z, cfg), cfg.n_fft, cfg.hop_length,
                          cfg.win_length, cfg.n_iter, method=cfg.stft_method)
        ev.append(mark())
        wav = deemphasis(wav, cfg.preemphasis)
        wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0
                          ).to(torch.int16)
        ev.append(mark())
        if cuda:
            torch.cuda.synchronize()
    ms = (lambda a, b: a.elapsed_time(b)) if cuda else \
        (lambda a, b: (b - a) * 1e3)
    return {n: ms(ev[i], ev[i + 1]) for i, n in enumerate(STAGES)}, wav


def gl_arithmetic(cfg):
    """(passes, peak FLOP/s) of the Griffin-Lim loop's products under
    ``cfg.stft_method``: the bf16 methods at the bf16 peak (3 passes for
    the split; dft_mixed and dft_pallas mix 3-pass head and tail rounds
    with single-pass middle ones), the others float32."""
    from ..dsp.griffin_lim import gl_schedule
    from ..utils.profiling import H100_BF16_PEAK_FLOPS, H100_FP32_PEAK_FLOPS
    m = cfg.stft_method
    if m in ("dft_mixed", "dft_pallas"):
        head, mid, tail = gl_schedule(cfg.n_iter)
        return ((3 * (head + tail) + mid) / cfg.n_iter,
                H100_BF16_PEAK_FLOPS)
    if m in ("dft_3x", "dft_bf16"):
        return (3 if m == "dft_3x" else 1), H100_BF16_PEAK_FLOPS
    return 1, H100_FP32_PEAK_FLOPS


def stage_flops(cfg, B: int, N: int) -> dict:
    """Algorithmic FLOPs of each timed stage for a batch of B rows of N ids
    (the JAX script's counts, TextEnc split from the decode). Griffin-Lim
    under "fft" and "dft_pallas2" is counted as the port computes it: FFTs
    of real frames, 2.5 N log2 N a transform (half the counter's complex
    "fft" count; chip_smoke.py's K2 bound counts the same), not the TPU
    kernel's factored DFT products."""
    from ..models.ssrn import ssrn_specs
    from ..models.text2mel import (audio_dec_specs, audio_enc_specs,
                                   text_enc_specs)
    from ..utils.profiling import conv_stack_flops, griffin_lim_flops
    T = cfg.max_T
    gl_args = (B, T * cfg.r + 1, cfg.n_fft, cfg.n_iter)
    if cfg.stft_method in ("fft", "dft_pallas2"):
        gl = griffin_lim_flops(*gl_args, "fft") // 2
    else:
        gl = griffin_lim_flops(*gl_args, cfg.stft_method)
    return {
        "text_enc_ms": conv_stack_flops(B, N, text_enc_specs(cfg), cfg.e),
        "decode_k1_ms": (conv_stack_flops(B, T, audio_enc_specs(cfg),
                                          cfg.n_mels)
                         + conv_stack_flops(B, T, audio_dec_specs(cfg),
                                            2 * cfg.d)
                         + 2 * 2 * B * T * N * cfg.d),      # QK^T + A*V
        "ssrn_ms": conv_stack_flops(B, T, ssrn_specs(cfg), cfg.n_mels),
        "griffin_lim_ms": gl,
    }


def profile(cfg, device, reps: int = 3) -> dict:
    """Stage ms (the best of ``reps`` runs after one warm-up), shares,
    FLOPs and MFU for the 40 Harvard sentences."""
    from ..bench import bench_ids, seeded_synthesizer
    from ..utils.profiling import (H100_BF16_PEAK_FLOPS, H100_FP32_PEAK_FLOPS,
                                   mfu)
    synth = seeded_synthesizer(cfg, device, pcm16=True)
    ids = bench_ids(cfg, 40)
    stage_times(synth, ids)                                   # warm-up
    runs = [stage_times(synth, ids)[0] for _ in range(reps)]
    ms = {k: min(r[k] for r in runs) for k in STAGES}
    total = sum(ms.values())
    flops = stage_flops(cfg, ids.shape[0], ids.shape[1])
    gl_passes, gl_peak = gl_arithmetic(cfg)
    arith = {"text_enc_ms": (1, H100_FP32_PEAK_FLOPS),
             "decode_k1_ms": (1, H100_FP32_PEAK_FLOPS),
             "ssrn_ms": (3, H100_BF16_PEAK_FLOPS),       # ssrn "high"
             "griffin_lim_ms": (gl_passes, gl_peak)}
    n_samples = ids.shape[0] * cfg.hop_length * (cfg.max_T_full - 1)
    on_card = synth.device.type == "cuda"
    return {"batch": int(ids.shape[0]), "ms": ms, "total_ms": total,
            "share": {k: v / total for k, v in ms.items()},
            "flops": flops,
            # a CPU run's times say nothing of the card's utilisation
            "mfu": {k: mfu(f, ms[k] / 1e3, *arith[k]) if on_card else None
                    for k, f in flops.items()},
            "audio_s_per_s": n_samples / cfg.sr / (total / 1e3),
            "device": str(synth.device)}


def main(argv=None) -> int:
    from ..config import base_config, test_config
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    cfg = test_config() if args.tiny else base_config()
    r = profile(cfg, resolve_device(args.device), args.reps)
    clock = "CUDA events" if r["device"].startswith("cuda") else \
        "host clock, CPU"
    print(f"batch {r['batch']}, {r['device']}, stft_method "
          f"{cfg.stft_method} ({clock})", flush=True)
    for k in STAGES:
        print(f"{k:18s} {r['ms'][k]:10.3f} ms  {100 * r['share'][k]:5.1f}%")
    print(f"{'total':18s} {r['total_ms']:10.3f} ms  -> "
          f"{r['audio_s_per_s']:.1f} audio-s/s")
    print("MFU against the H100's peak for each stage's arithmetic "
          "(float32 67 TFLOP/s; bf16 989 TFLOP/s x passes):")
    for k, f in r["flops"].items():
        util = ("not measured (CPU run)" if r["mfu"][k] is None else
                f"{f / (r['ms'][k] / 1e3) / 1e12:8.2f} TFLOP/s  "
                f"mfu {100 * r['mfu'][k]:6.2f}%")
        print(f"  {k:16s} {f / 1e12:9.4f} TFLOP  {util}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
