"""Offline feature extraction CLI: ``python -m dc_tts_tpu_torch.prepro``.

Walks the corpus and saves ``mels/<name>.npy`` (T/r, n_mels) and
``mags/<name>.npy`` (T, n_freq), the features computed on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from .config import base_config, test_config
from .data.dataset import prepro_corpus
from .device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description="Precompute mel/mag features")
    ap.add_argument("--data", default=None, help="corpus dir")
    ap.add_argument("--out", default=".", help="output dir for mels/ mags/")
    ap.add_argument("--tiny", action="store_true",
                    help="use the tiny test config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = test_config() if args.tiny else base_config()
    n = prepro_corpus(cfg, args.out, args.data or cfg.data, device=device)
    print(f"preprocessed {n} utterances on {device}")


if __name__ == "__main__":
    main()
