"""Text frontend: vocabulary, normalization, id encoding (numpy only).

The port's own copy of ``dc_tts_tpu/text.py``; the two must agree id for id
(tests/test_torch_config_text.py).

Behavioral contract from the reference's text pipeline
(the original DC-TTS ``data_load.py:19-31`` and ``:79-86``):

- vocab "PE abcdefghijklmnopqrstuvwxyz'.?": index 0 is PAD ("P"),
  index 1 is EOS ("E").
- normalization: NFD-decompose and strip combining marks, lowercase,
  replace any out-of-vocab char with a space, collapse runs of spaces.
- every encoded utterance gets an explicit "E" EOS appended.
- synthesis batches are zero-padded (PAD=0) to a fixed max_N.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .config import Config


def load_vocab(cfg: Config) -> Tuple[dict, dict]:
    """char->idx and idx->char maps (reference data_load.py:19-22)."""
    char2idx = {ch: i for i, ch in enumerate(cfg.vocab)}
    idx2char = {i: ch for i, ch in enumerate(cfg.vocab)}
    return char2idx, idx2char


def text_normalize(text: str, cfg: Config) -> str:
    """Strip accents, lowercase, drop out-of-vocab chars, collapse spaces.

    Mirrors reference data_load.py:24-31 exactly, including the regex
    character-class built from the raw vocab string.
    """
    text = "".join(
        ch for ch in unicodedata.normalize("NFD", text)
        if unicodedata.category(ch) != "Mn"
    )
    text = text.lower()
    text = re.sub("[^{}]".format(re.escape(cfg.vocab)), " ", text)
    text = re.sub("[ ]+", " ", text)
    return text


def encode_text(text: str, cfg: Config, append_eos: bool = True) -> np.ndarray:
    """Normalized text -> int32 id array (with EOS)."""
    char2idx, _ = load_vocab(cfg)
    s = text_normalize(text, cfg)
    if append_eos:
        s = s + "E"
    return np.array([char2idx[ch] for ch in s], dtype=np.int32)


def encode_batch(sents: Sequence[str], cfg: Config,
                 max_len: int | None = None) -> np.ndarray:
    """Encode + zero-pad a batch of raw sentences to (B, max_N) int32.

    Mirrors the synthesize-mode path (reference data_load.py:81-86):
    normalize, strip, append EOS, left-aligned zero padding.
    Sentences longer than max_len are truncated (the reference would crash;
    we clamp and keep the final char as EOS).
    """
    max_len = max_len or cfg.max_N
    char2idx, _ = load_vocab(cfg)
    out = np.zeros((len(sents), max_len), dtype=np.int32)
    for i, raw in enumerate(sents):
        s = text_normalize(raw, cfg).strip() + "E"
        ids = [char2idx[ch] for ch in s]
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [char2idx["E"]]
        out[i, : len(ids)] = ids
    return out


def load_test_sentences(path: str) -> List[str]:
    """Parse a Harvard-sentences style file: skip the header line, strip the
    leading "N. " numbering (reference data_load.py:81-82)."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()[1:]
    return [line.split(" ", 1)[-1].strip() for line in lines if line.strip()]


def decode_ids(ids: Iterable[int], cfg: Config) -> str:
    _, idx2char = load_vocab(cfg)
    return "".join(idx2char[int(i)] for i in ids)
