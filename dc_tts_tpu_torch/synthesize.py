"""Synthesis CLI: ``python -m dc_tts_tpu_torch.synthesize``.

Reads a Harvard-sentences style file, restores Text2Mel from logdir-1 and
SSRN from logdir-2 (or makes random weights), synthesizes every sentence
on one GPU and writes ``<out>/{i}.wav`` (with ``--plots``, an attention
alignment plot per sentence beside them). Runs on CUDA unless ``--device
cpu`` is given.

The parallel modes run one rank a device under ``torchrun --nproc-per-node
N`` (NCCL on cards, gloo with ``--device cpu``), and without ``torchrun`` as
one rank: ``--mesh`` splits the sentences over the ranks, ``--pipeline``
decodes on half of them and vocodes on the other half, microbatch by
microbatch (``--microbatch``), ``--time-shard N`` shards SSRN and
Griffin-Lim over time on N ranks. Rank 0 writes the wavs.
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
from .parallel import distributed
from .parallel.mesh import make_mesh
from .pipeline import (PipelinedSynthesizer, Synthesizer,
                       restore_synthesis_params, synthesize_time_sharded)
from .utils.plotting import plot_alignment


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
    ap.add_argument("--mesh", action="store_true",
                    help="split the sentences over all ranks (data "
                         "parallel)")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipeline-parallel synthesis over two halves of "
                         "the ranks: Text2Mel's decode on one, SSRN and "
                         "Griffin-Lim on the other, microbatches streamed "
                         "through. Needs >= 2 ranks")
    ap.add_argument("--microbatch", type=int, default=8,
                    help="pipeline microbatch size (--pipeline only); the "
                         "sentence batch is padded up to a multiple")
    ap.add_argument("--time-shard", type=int, default=0, metavar="N",
                    help="sequence-parallel vocoding: shard SSRN and the "
                         "Griffin-Lim frame axis over N ranks (halo "
                         "exchanges each conv and round); 0 = off; the "
                         "frame grid must divide by N")
    args = ap.parse_args(argv)
    if args.decode_precision != "highest" and args.mode in (
            "incremental", "reference"):
        ap.error("--decode-precision only applies to the fused decode "
                 "kernel; --mode incremental/reference always run at "
                 "float32 (the flag would be silently ignored)")
    if args.pipeline and (args.mesh or args.mode != "auto" or args.plots
                          or args.decode_precision != "highest"):
        ap.error("--pipeline uses its own two-stage layout and fixed "
                 "decode path and returns waveforms only; it cannot be "
                 "combined with --mesh, --mode, --decode-precision, or "
                 "--plots")
    if args.time_shard and (args.pipeline or args.mesh or args.plots
                            or args.mode != "auto"
                            or args.ssrn_precision != "high"
                            or args.decode_precision != "highest"):
        ap.error("--time-shard owns every rank (it shards the TIME axis, "
                 "not utterances), always decodes fused at highest, runs "
                 "the time-sharded SSRN at full float32, and returns "
                 "waveforms only; it cannot be combined with --pipeline, "
                 "--mesh, --plots, --mode, --decode-precision, or "
                 "--ssrn-precision")
    device = resolve_device(args.device)
    distributed.initialize(device=device)
    rank0 = distributed.world()[0] == 0

    cfg = test_config() if args.tiny else base_config()
    sent_path = args.sentences or cfg.test_data
    out_dir = args.out or cfg.sampledir
    sents = text_mod.load_test_sentences(sent_path)
    if rank0:
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
    if args.pipeline:
        synth = PipelinedSynthesizer(cfg, t2m_params, ssrn_params,
                                     microbatch=args.microbatch,
                                     ssrn_precision=args.ssrn_precision,
                                     device=device)
    elif not args.time_shard:
        synth = Synthesizer(cfg, t2m_params, ssrn_params, device=device,
                            mesh=make_mesh() if args.mesh else None,
                            decode_mode=args.mode,
                            ssrn_precision=args.ssrn_precision,
                            decode_prec=args.decode_precision)

    t0 = time.time()
    if args.pipeline or args.time_shard:
        ids = text_mod.encode_batch(sents, cfg)
        if args.pipeline:
            wav_arr = synth.synthesize_ids(ids)
        else:
            out = synthesize_time_sharded(cfg, t2m_params, ssrn_params, ids,
                                          n_shards=args.time_shard,
                                          device=device)
            if out is None:
                return      # a rank the --time-shard grid leaves out
            wav_arr = out[0].cpu().numpy()
        wavs = [trim_silence(w) for w in wav_arr]
    elif args.plots:
        wav_arr, _, _, align = synth.synthesize_ids(
            text_mod.encode_batch(sents, cfg))
        wav_arr = wav_arr.cpu().numpy()
        if wav_arr.dtype == np.int16:
            wav_arr = wav_arr.astype(np.float32) / 32767.0
        wavs = [trim_silence(w) for w in wav_arr]
        for i, a in enumerate(align.cpu().numpy() if rank0 else ()):
            plot_alignment(a, f"utt{i + 1}", out_dir)
    else:
        wavs = synth.synthesize(sents)
    dt = time.time() - t0
    if not rank0:
        return
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
