#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one output line each; any failure exits non-zero with no ``ok``
line:

1. device  - the card's name and power limit (nvidia-smi); TF32 off.
2. build   - nvcc builds the kernels from dc_tts_tpu_torch/csrc/.
3. K1      - the decode kernel against its plain PyTorch version at
             base_config width and the main path's shapes (B=20 Harvard
             sentences, N=180, T=210, seeded random weights): max|dY|,
             max|dA| <= 2e-5 and the same cursor trajectory. A flip whose
             two largest in-window probabilities differ by < 1e-6 is a tie:
             Y and A are then compared up to and including that step.
4. K2      - the Griffin-Lim kernels against their plain version at the
             production geometry (n_fft 2048, hop 275, win 1102, F=840,
             B=20): n_iter=1 and n_iter=3 waveforms within 1e-5 of the
             plain version run in float64 (the float32 plain version is
             itself further than that from it: the phase normalisation of
             near-zero bins amplifies rounding); n_iter=50 spectral
             convergence on a two-tone probe <= 1.10 x the plain version's
             + 0.01.
5. e2e     - Synthesizer(base_config(), random weights, pcm16=True) on the
             card: synthesize_ids_chunked over the 40 Harvard sentences in
             chunks of 20, with every launch counter set to 0 just before
             and read just after; int16 waveforms of shape (40, 230725);
             then the tiny config on the card against the CPU (Y 2e-5, Z
             1e-4) and the float64 plain vocoder (waveform 1e-4); and
             CUDA-event times of each stage of one chunk, whose output is
             held equal to synthesize_ids' on the same chunk.
6. the kernels line, the nvidia-smi line, and the ``ok`` line.

Kernel times are CUDA-event means over repeated calls on the same inputs.
``bound_ms`` is the larger of (bytes each input read once + each output
written once) / 3.35 TB/s and (float32 operations) / 67 TFLOP/s, the
H100 SXM's published peaks at 700 W. K2's operations count each 2048-point
transform as a real FFT (2.5 N log2 N): every frame is real and every
spectrum Hermitian. A summary also goes to
``chiprun_out/chip_smoke.json`` beside this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
B_MAIN, CHUNK = 20, 20


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (after one warm-up
    call)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float):
    tb, tf = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FP32 * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def harvard_ids(cfg, n):
    from dc_tts_tpu_torch import text
    sents = text.load_test_sentences(os.path.join(HERE,
                                                  "harvard_sentences.txt"))
    return text.encode_batch((sents * (-(-n // len(sents))))[:n], cfg)


# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    from dc_tts_tpu_torch.device import fp32_numerics
    fp32_numerics()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    line("device", name=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count(), nvidia_smi=repr(smi),
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi.splitlines()[0]


def phase_build():
    from dc_tts_tpu_torch.ops import _build
    secs = _build.timed_build()
    log = _build.library_path() + ".log"
    report = []
    if os.path.exists(log):
        with open(log) as f:
            report = [ln.strip() for ln in f
                      if "registers" in ln or "spill" in ln]
    line("build", seconds=f"{secs:.1f}", library=os.path.basename(
        _build.library_path()))
    for ln in report:
        print("    ptxas " + ln, flush=True)


def _first_flip(A_k, A_p):
    """(step, row, margin) of the first cursor flip, or None. margin: the
    gap between the two largest probabilities of the plain version's row
    at that step."""
    ck, cp = A_k.argmax(1), A_p.argmax(1)          # (B, T)
    diff = ck != cp
    if not bool(diff.any()):
        return None
    t = int(diff.any(0).nonzero()[0])
    b = int(diff[:, t].nonzero()[0])
    top = A_p[b, :, t].topk(2).values
    return t, b, float(top[0] - top[1])


def phase_k1(results):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models import Text2Mel
    from dc_tts_tpu_torch.ops import decode as K1

    cfg = base_config()
    dev = torch.device("cuda")
    model = Text2Mel(cfg)
    params = model.init(torch.Generator().manual_seed(1), dev)
    ids = torch.as_tensor(harvard_ids(cfg, B_MAIN), device=dev)
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
        packed = K1.pack_decode_params(cfg, params)
        T = cfg.max_T
        Y, A = K1.fused_decode(packed, Kt, V, T, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Yp, Ap = K1.fused_decode_plain(packed, Kt, V, T, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ms = cuda_ms(lambda: K1.fused_decode(packed, Kt, V, T, cfg), 3)
    flip = _first_flip(A, Ap)
    note = "cursor trajectories identical"
    upto = T
    if flip is not None:
        t, b, margin = flip
        print(f"    cursor flip at step {t}, row {b}: margin between the "
              f"two largest in-window probabilities {margin:.3e}",
              flush=True)
        if margin >= 1e-6:
            raise AssertionError(f"K1 cursor flip at step {t} row {b} with "
                                 f"margin {margin:.3e} >= 1e-6: a bug")
        upto = t + 1
        note = f"tie at step {t} row {b}: compared steps 0..{t} only"
    dY = float((Y[:, :upto] - Yp[:, :upto]).abs().max())
    dA = float((A[:, :, :upto] - Ap[:, :, :upto]).abs().max())
    ok = dY <= 2e-5 and dA <= 2e-5 and bool(torch.isfinite(Y).all())
    # operations: the layer matmuls per row per step plus the unmasked
    # attention keys (scores + context) the cursors of this run select
    enc, dec = K1._programs(cfg)
    mac_layers = sum(l.cin * l.cout if l.kind == "C" else 6 * l.cout ** 2
                     for l in enc + dec)
    prev = torch.cat([torch.zeros(B_MAIN, 1, dtype=torch.long, device=dev),
                      A.argmax(1)[:, :-1]], dim=1)
    keys = int(torch.clamp(cfg.max_N - prev, max=cfg.attention_win_size
                           ).sum())
    flops = 2.0 * (mac_layers * B_MAIN * T + keys * 2 * cfg.d)
    b_ms, b_by = bound(nbytes(Kt, V, *packed.values(), Y, A), flops)
    line("K1", ok=ok, B=B_MAIN, N=cfg.max_N, T=T, max_dY=f"{dY:.3e}",
         max_dA=f"{dA:.3e}", tol="2e-5", note=repr(note), ms=f"{ms:.3f}",
         plain_ms=f"{plain_ms:.1f}", bound_ms=f"{b_ms:.4f}",
         bound_by=b_by, gflop=f"{flops / 1e9:.2f}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"dY={dY} dA={dA}")
    results["K1"] = dict(max_abs_err=max(dY, dA), ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)


def phase_k2(results):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.dsp.stft import stft
    from dc_tts_tpu_torch.ops import gl2 as K2

    cfg = base_config()
    dev = torch.device("cuda")
    n_fft, hop, win = cfg.n_fft, cfg.hop_length, cfg.win_length
    F = cfg.max_T_full
    g = K2.gl2_geometry(n_fft, hop, win, F)
    consts = {k: torch.as_tensor(v, device=dev)
              for k, v in K2.gl2_consts(n_fft, hop, win, F).items()}
    gen = torch.Generator().manual_seed(2)
    mag = torch.rand(B_MAIN, F, cfg.n_freq, generator=gen).to(dev) + 0.05
    scr = K2.scramble_mag(mag, g)
    # one and three rounds against the plain version run in float64: the
    # phase normalisation of near-zero bins amplifies rounding, and the
    # float32 plain version (torch.fft) is itself ~3e-5 from the float64
    # one here, so the kernel is held to 1e-5 from the float64 result, and
    # both float32 versions' distances are printed; three rounds catch a
    # round dropped or state carried wrongly from one round to the next
    errs = {}
    for it in (1, 3):
        yk = K2.gl2_run(scr, consts, g, it)
        y64 = K2.gl2_run_plain(scr.double(), consts, g, it)
        yp = K2.gl2_run_plain(scr, consts, g, it)
        errs[it] = (float((yk.double() - y64).abs().max()),
                    float((yp.double() - y64).abs().max()),
                    float((yk - yp).abs().max()))
        del yk, y64, yp
    err1 = max(errs[1][0], errs[3][0])

    # two-tone probe, tiled to the main path's batch
    t = torch.arange(hop * (F - 1) + n_fft, dtype=torch.float64) / cfg.sr
    probe = (0.6 * torch.sin(2 * np.pi * 440 * t)
             + 0.4 * torch.sin(2 * np.pi * 660 * t)).float().to(dev)
    pmag = stft(probe, n_fft, hop, win).abs()[:F]
    pscr = K2.scramble_mag(pmag.expand(B_MAIN, F, cfg.n_freq), g)

    def sc(wav):
        m = stft(wav, n_fft, hop, win).abs()[:, :F]
        return float(torch.linalg.norm(m - pmag) / torch.linalg.norm(
            pmag.expand_as(m)))

    n_iter = cfg.n_iter
    w = K2.gl2_run(pscr, consts, g, n_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wp = K2.gl2_run_plain(pscr, consts, g, n_iter)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    s_k, s_p = sc(w), sc(wp)
    ms = cuda_ms(lambda: K2.gl2_run(pscr, consts, g, n_iter), 3)
    ok = (err1 <= 1e-5 and np.isfinite(s_k) and s_k <= 1.10 * s_p + 0.01
          and w.shape == (B_MAIN, g.L_sig))
    # operations: real FFTs of the n_fft-point frames, 2.5 N log2 N each
    # (every frame is real and every spectrum Hermitian), 2*n_iter + 1 per
    # frame (n_iter forward/inverse pairs and the final inverse)
    flops = (2 * n_iter + 1) * F * B_MAIN * 2.5 * n_fft * np.log2(n_fft)
    b_ms, b_by = bound(nbytes(pscr, w), flops)
    line("K2", ok=ok, B=B_MAIN, F=F, n_fft=n_fft, n_iter=n_iter,
         tol="1e-5",
         **{f"iter{it}_{k}": f"{e[i]:.3e}" for it, e in errs.items()
            for i, k in enumerate(("kernel_vs_plain_f64",
                                   "plain_f32_vs_f64",
                                   "kernel_vs_plain_f32"))},
         sc_kernel=f"{s_k:.5f}", sc_plain=f"{s_p:.5f}", ms=f"{ms:.3f}",
         plain_ms=f"{plain_ms:.1f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
         gflop=f"{flops / 1e9:.2f}")
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: "
                             f"err1={err1} sc={s_k} vs {s_p}")
    results["K2"] = dict(max_abs_err=err1, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)


def stage_ms(synth, ids):
    """CUDA-event milliseconds of each stage of ``synthesize_ids`` on one
    chunk, run stage by stage as the Synthesizer chains them, and the
    chunk's int16 waveforms."""
    from dc_tts_tpu_torch.dsp.features import deemphasis
    from dc_tts_tpu_torch.dsp.griffin_lim import denormalize_mag, griffin_lim
    from dc_tts_tpu_torch.ops import decode as K1

    cfg, p = synth.cfg, synth.t2m_params
    names = ("text_enc_ms", "decode_k1_ms", "ssrn_ms", "griffin_lim_k2_ms",
             "deemph_pcm16_ms")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.no_grad():
        ids = torch.as_tensor(ids, device=synth.device)
        torch.cuda.synchronize()
        ev[0].record()
        Kt, V = synth.text2mel.text_encode(p, ids)
        ev[1].record()
        Y, _ = K1.fused_decode(synth.packed, Kt.contiguous(),
                               V.contiguous(), cfg.max_T, cfg)
        ev[2].record()
        _, Z = synth.ssrn.apply(synth.ssrn_params, Y)
        ev[3].record()
        wav = griffin_lim(denormalize_mag(Z, cfg), cfg.n_fft, cfg.hop_length,
                          cfg.win_length, cfg.n_iter, method=cfg.stft_method)
        ev[4].record()
        wav = deemphasis(wav, cfg.preemphasis)
        wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0
                          ).to(torch.int16)
        ev[5].record()
        torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1])
            for i, n in enumerate(names)}, wav


def phase_e2e(results, smi):
    from dc_tts_tpu_torch import Synthesizer, base_config, test_config
    from dc_tts_tpu_torch.dsp.griffin_lim import spectrogram_to_wav
    from dc_tts_tpu_torch.models import SSRN, Text2Mel
    from dc_tts_tpu_torch.ops import decode as K1
    from dc_tts_tpu_torch.ops import gl2 as K2

    cfg = base_config()
    gen = torch.Generator().manual_seed(0)
    synth = Synthesizer(cfg, Text2Mel(cfg).init(gen), SSRN(cfg).init(gen),
                        pcm16=True)
    ids = harvard_ids(cfg, 40)
    synth.synthesize_ids_chunked(ids[:CHUNK], CHUNK)      # warm-up
    K1.fused_decode.launches = 0
    K2.gl2_run.launches = 0
    t0 = time.perf_counter()
    wavs = synth.synthesize_ids_chunked(ids, CHUNK)
    wall = time.perf_counter() - t0
    launches = {"K1": K1.fused_decode.launches, "K2": K2.gl2_run.launches}
    n_samples = cfg.hop_length * (cfg.max_T_full - 1)
    ok = (wavs.dtype == np.int16 and wavs.shape == (40, n_samples)
          and launches["K1"] > 0 and launches["K2"] > 0
          and int(np.abs(wavs).max()) > 0)
    audio_s = wavs.size / cfg.sr
    line("e2e", ok=ok, shape=wavs.shape, dtype=wavs.dtype,
         launches=json.dumps(launches).replace(" ", ""),
         wall_s=f"{wall:.3f}", audio_s=f"{audio_s:.1f}",
         audio_s_per_s=f"{audio_s / wall:.1f}", card=repr(smi))
    if not ok:
        raise AssertionError(f"end to end failed: {wavs.shape} {wavs.dtype} "
                             f"{launches}")
    stages, wav_st = stage_ms(synth, ids[:CHUNK])
    # the stage-by-stage copy of the chain is held to the Synthesizer's own
    wav_sy = synth.synthesize_ids(ids[:CHUNK])[0]
    d_st = int((wav_st.int() - wav_sy.int()).abs().max())
    dev_s = sum(stages.values()) / 1e3
    line("e2e-stages", ok=d_st == 0, chunk=CHUNK,
         **{k: f"{v:.3f}" for k, v in stages.items()},
         device_audio_s_per_s=f"{CHUNK * n_samples / cfg.sr / dev_s:.1f}",
         max_dpcm_vs_synthesize_ids=d_st)
    if d_st != 0:
        raise AssertionError(f"the stage-timed chain differs from "
                             f"synthesize_ids by {d_st} pcm steps")

    # a small input against the CPU reference (the plain versions): Y and Z
    # against the CPU run, the waveform against the float64 plain vocoder
    # on the card's own Z (see phase K2 for why float64)
    tc = test_config()
    gen = torch.Generator().manual_seed(3)
    p1, p2 = Text2Mel(tc).init(gen), SSRN(tc).init(gen)
    tids = harvard_ids(tc, 3)
    wav, Y, Z, A = (o.cpu() for o in
                    Synthesizer(tc, p1, p2).synthesize_ids(tids))
    cpu = Synthesizer(tc, p1, p2, device="cpu").synthesize_ids(tids)
    ref = spectrogram_to_wav(Z.double(), tc.replace(stft_method="fft"))
    dY = float((Y - cpu[1]).abs().max())
    dZ = float((Z - cpu[2]).abs().max())
    dW = float((wav.double() - ref).abs().max())
    same = bool(torch.equal(A.argmax(1), cpu[3].argmax(1)))
    ok = same and dY <= 2e-5 and dZ <= 1e-4 and dW <= 1e-4
    line("e2e-tiny", ok=ok, cursors_equal=same, max_dY=f"{dY:.3e}",
         max_dZ=f"{dZ:.3e}", max_dwav_vs_f64=f"{dW:.3e}",
         tol="Y 2e-5, Z 1e-4, wav 1e-4")
    if not ok:
        raise AssertionError("tiny synthesis on the card disagrees with the "
                             "CPU")
    results["launches"] = launches
    results["e2e"] = dict(wall_s=wall, audio_s=audio_s,
                          audio_s_per_s=audio_s / wall, stages_ms=stages)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    results = {}
    phase_k1(results)
    phase_k2(results)
    phase_e2e(results, smi)
    kernels = []
    for key, name, src, rep in (
            ("K1", "fused_decode", "dc_tts_tpu_torch/csrc/decode.cu",
             "dc_tts_tpu/ops/pallas_decode.py:274"),
            ("K2", "gl2_run", "dc_tts_tpu_torch/csrc/gl2.cu",
             "dc_tts_tpu/ops/pallas_gl2.py:407")):
        r = results[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": results["launches"][key],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "e2e": results["e2e"]},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
