"""Synthesis CLI: ``python -m dc_tts_tpu_torch.synthesize``.

Reads a Harvard-sentences style file, restores Text2Mel from logdir-1 and
SSRN from logdir-2 (or makes random weights), synthesizes every sentence
on one GPU and writes ``<out>/{i}.wav`` (with ``--plots``, an attention
alignment plot per sentence beside them). Runs on CUDA unless ``--device
cpu`` is given. The JAX CLI's ``--mesh``, ``--pipeline`` and
``--time-shard`` are not ported.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import text as text_mod
from .config import base_config, test_config
from .device import resolve_device
from .dsp.audio import save_wav
from .dsp.features import trim_silence
from .pipeline import Synthesizer, restore_synthesis_params
from .utils.plotting import plot_alignment

_NOT_PORTED = ("mesh", "pipeline", "time_shard")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batch TTS synthesis (PyTorch)")
    ap.add_argument("--sentences", default=None,
                    help="Harvard-style sentence file (default cfg.test_data)")
    ap.add_argument("--logdir1", default=None, help="Text2Mel checkpoint dir")
    ap.add_argument("--logdir2", default=None, help="SSRN checkpoint dir")
    ap.add_argument("--out", default=None, help="output dir (cfg.sampledir)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "fused", "incremental", "reference"],
                    help="decode path (see Text2Mel.decode); auto = the "
                         "fused decode kernel")
    ap.add_argument("--random-weights", action="store_true",
                    help="skip checkpoint restore (smoke tests)")
    ap.add_argument("--tiny", action="store_true",
                    help="use the tiny test config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; no CPU fallback)")
    ap.add_argument("--decode-precision", default="highest",
                    choices=["highest", "hybrid", "high3"],
                    help="fused decode kernel's layer products: highest "
                         "(default, float32), hybrid (AudioEnc float32, "
                         "AudioDec the 3-pass bf16 split) or high3 (the "
                         "split everywhere). The reduced ones are for "
                         "trained checkpoints: at random init they flip "
                         "attention cursors")
    ap.add_argument("--ssrn-precision", default="high",
                    choices=["high", "highest", "bf16"],
                    help="SSRN conv precision for synthesis: high (3-pass "
                         "bf16 hi/lo products with float32 sums, default), "
                         "highest (strict parity, true float32), bf16 "
                         "(one pass of bf16 operands, float32 sums)")
    ap.add_argument("--plots", action="store_true",
                    help="save each sentence's attention alignment plot")
    ap.add_argument("--mesh", action="store_true", help="not ported yet")
    ap.add_argument("--pipeline", action="store_true", help="not ported yet")
    ap.add_argument("--time-shard", type=int, default=0, metavar="N",
                    help="not ported yet")
    args = ap.parse_args(argv)
    if args.decode_precision != "highest" and args.mode in (
            "incremental", "reference"):
        ap.error("--decode-precision only applies to the fused decode "
                 "kernel; --mode incremental/reference always run at "
                 "float32 (the flag would be silently ignored)")
    for name in _NOT_PORTED:
        if getattr(args, name):
            ap.error(f"--{name.replace('_', '-')} is not ported to the "
                     "PyTorch package yet")
    device = resolve_device(args.device)

    cfg = test_config() if args.tiny else base_config()
    sent_path = args.sentences or cfg.test_data
    out_dir = args.out or cfg.sampledir
    sents = text_mod.load_test_sentences(sent_path)
    print(f"{len(sents)} sentences from {sent_path}")

    if args.random_weights:
        from .models.ssrn import SSRN
        from .models.text2mel import Text2Mel
        gen = torch.Generator().manual_seed(0)
        t2m_params = Text2Mel(cfg).init(gen)
        ssrn_params = SSRN(cfg).init(gen)
    else:
        t2m_params, ssrn_params = restore_synthesis_params(
            cfg, args.logdir1 or cfg.logdir + "-1",
            args.logdir2 or cfg.logdir + "-2")
    synth = Synthesizer(cfg, t2m_params, ssrn_params, device=device,
                        decode_mode=args.mode,
                        ssrn_precision=args.ssrn_precision,
                        decode_prec=args.decode_precision)

    t0 = time.time()
    if args.plots:
        wav_arr, _, _, align = synth.synthesize_ids(
            text_mod.encode_batch(sents, cfg))
        wav_arr = wav_arr.cpu().numpy()
        if wav_arr.dtype == np.int16:
            wav_arr = wav_arr.astype(np.float32) / 32767.0
        wavs = [trim_silence(w) for w in wav_arr]
        for i, a in enumerate(align.cpu().numpy()):
            plot_alignment(a, f"utt{i + 1}", out_dir)
    else:
        wavs = synth.synthesize(sents)
    dt = time.time() - t0
    audio_s = sum(len(w) for w in wavs) / cfg.sr
    print(f"synthesized {audio_s:.1f}s of audio in {dt:.1f}s "
          f"({audio_s / dt:.2f} audio-s/s) on {device}")

    os.makedirs(out_dir, exist_ok=True)
    for i, wav in enumerate(wavs):
        peak = np.abs(wav).max() if wav.size else 0.0
        if peak > 1.0:  # keep untrained checkpoints from clipping
            wav = wav / peak
        save_wav(os.path.join(out_dir, f"{i + 1}.wav"), wav, cfg.sr)
    print(f"wrote {len(wavs)} wavs to {out_dir}")


if __name__ == "__main__":
    main()
