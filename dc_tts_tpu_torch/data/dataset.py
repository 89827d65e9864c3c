"""Corpus parsing, offline preprocessing and the training input pipeline,
the port of ``dc_tts_tpu/data/dataset.py`` (numpy; the batches it yields
match the JAX package's for the same seed, bit for bit).

* LJSpeech transcripts: ``fname|rawtext|normalized_text`` lines, wavs at
  ``<data>/wavs/<fname>.wav``.
* Generic 5-field transcripts: ``fname|_|text|is_inside_quotes|duration``,
  clips over 10 s skipped.
* EOS "E" appended to every utterance.
* Offline prepro saves ``mels/<name>.npy`` (T/r, n_mels) and
  ``mags/<name>.npy`` (T, n_freq); the features are computed on the card.

Every batch is padded to a static shape, the full (max_N, max_T) grid or
one of a few length buckets, with each example's lengths beside it (the
losses mask by them), and a pool of threads assembles batches ahead of the
trainer; they are handed out in the shuffle's order, whichever thread
finishes first, so every data-parallel rank with the same seed sees the
same global batches.
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .. import text as text_mod
from ..config import Config
from ..dsp.features import reduce_mel


@dataclass
class Example:
    fname: str
    fpath: str
    text_ids: np.ndarray  # (n,) int32 incl EOS


def parse_transcript(cfg: Config, data_dir: Optional[str] = None
                     ) -> List[Example]:
    """Parse transcript.csv (or metadata.csv) in either format."""
    data_dir = data_dir or cfg.data
    path = os.path.join(data_dir, "transcript.csv")
    # LJSpeech ships metadata.csv; accept either name.
    if not os.path.exists(path):
        alt = os.path.join(data_dir, "metadata.csv")
        if os.path.exists(alt):
            path = alt
    examples = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("|")
            if len(fields) >= 5:  # nick/kate style with duration filter
                fname, _, text, _, duration = fields[:5]
                if float(duration) > 10.0:
                    continue
                fpath = os.path.join(data_dir, fname)
            else:  # LJ style
                fname, text = fields[0], fields[-1]
                fpath = os.path.join(data_dir, "wavs", fname + ".wav")
            ids = text_mod.encode_text(text, cfg)
            examples.append(Example(os.path.basename(fpath), fpath, ids))
    return examples


# ---------------------------------------------------------------------------
# offline preprocessing


def prepro_corpus(cfg: Config, out_dir: str = ".",
                  data_dir: Optional[str] = None,
                  examples: Optional[Sequence[Example]] = None,
                  progress: bool = True, device="cpu") -> int:
    """Extract and save mels/<name>.npy + mags/<name>.npy for the corpus,
    the features computed on ``device`` by ``dsp.features``."""
    import torch

    from ..dsp.audio import load_wav
    from ..dsp.features import wav_to_spectrograms

    examples = examples if examples is not None else \
        parse_transcript(cfg, data_dir)
    mel_dir = os.path.join(out_dir, "mels")
    mag_dir = os.path.join(out_dir, "mags")
    os.makedirs(mel_dir, exist_ok=True)
    os.makedirs(mag_dir, exist_ok=True)
    n = 0
    for ex in examples:
        y = load_wav(ex.fpath, cfg.sr)
        mel, mag = wav_to_spectrograms(torch.as_tensor(y, device=device),
                                       cfg)
        mel, mag = reduce_mel(mel.cpu().numpy(), mag.cpu().numpy(), cfg.r)
        base = ex.fname.replace(".wav", ".npy")
        np.save(os.path.join(mel_dir, base), mel.astype(np.float32))
        np.save(os.path.join(mag_dir, base), mag.astype(np.float32))
        n += 1
        if progress and n % 100 == 0:
            print(f"prepro: {n}/{len(examples)}")
    return n


# ---------------------------------------------------------------------------
# length buckets

def _wav_header(path: str) -> tuple:
    """(sample_rate, n_samples) by parsing RIFF chunks; no sample data is
    read (the stdlib ``wave`` module rejects the IEEE-float wavs scipy
    writes, so the two needed chunks are parsed directly)."""
    import struct
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        sr = channels = bits = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                tag = struct.unpack("<H", fmt[0:2])[0]
                if tag == 0xFFFE and len(fmt) >= 26:
                    # WAVE_FORMAT_EXTENSIBLE: the real format code is the
                    # first 2 bytes of the SubFormat GUID (fmt offset 24)
                    tag = struct.unpack("<H", fmt[24:26])[0]
                if tag not in (1, 3):  # PCM, IEEE float
                    raise ValueError(
                        f"unsupported wav format tag 0x{tag:04x} in {path} "
                        f"(compressed wavs would yield a bogus sample "
                        f"count); need PCM (1) or IEEE float (3), plain "
                        f"or EXTENSIBLE-wrapped")
                channels = struct.unpack("<H", fmt[2:4])[0]
                sr = struct.unpack("<I", fmt[4:8])[0]
                bits = struct.unpack("<H", fmt[14:16])[0]
            elif cid == b"data":
                if sr is None:
                    raise ValueError(f"fmt chunk missing in {path}")
                return sr, size // max(1, channels * (bits // 8))
            else:
                f.seek(size + (size & 1), 1)
    raise ValueError(f"no data chunk in {path}")


def wav_mel_len(path: str, cfg: Config) -> int:
    """Estimated reduced-mel frame count from the wav header only (the
    on-the-fly mode has no feature files to measure). An upper bound:
    trimming silence at load only shortens the clip, so bucket assignment
    by this length never overflows a bucket's grid."""
    sr, n = _wav_header(path)
    if sr != cfg.sr:
        n = -(-n * cfg.sr // sr)
    frames = 1 + n // cfg.hop_length
    return -(-frames // cfg.r)


def npy_shape(path: str) -> tuple:
    """Shape of a .npy file from its header only (no data read), through
    numpy's public header readers."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        major, _ = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if major == 1
                else fmt.read_array_header_2_0)
        shape, _, _ = read(f)
    return shape


def _example_mel_len(cfg: Config, ex: Example, feature_dir: str,
                     on_the_fly: bool) -> int:
    """Reduced-mel length for bucketing: npy header (prepro mode) or wav
    header estimate (on-the-fly mode)."""
    if on_the_fly:
        return wav_mel_len(ex.fpath, cfg)
    base = ex.fname.replace(".wav", ".npy")
    return npy_shape(os.path.join(feature_dir, "mels", base))[0]


def compute_bucket_shapes(cfg: Config, examples: Sequence[Example],
                          feature_dir: str = ".", n_buckets: int = 3,
                          on_the_fly: bool = False) -> List[tuple]:
    """Static (N_b, T_b) bucket shapes from the corpus length distribution:
    the corpus split into ``n_buckets`` equal groups by mel length, each
    bucket sized to cover its group (rounded up to multiples of 8). The
    last bucket is always the full (max_N, max_T) grid."""
    lens = []
    for ex in examples:
        t = _example_mel_len(cfg, ex, feature_dir, on_the_fly)
        lens.append((min(len(ex.text_ids), cfg.max_N), min(t, cfg.max_T)))
    lens.sort(key=lambda p: p[1])
    shapes = []
    group = max(1, len(lens) // n_buckets)
    for b in range(n_buckets - 1):
        part = lens[b * group: (b + 1) * group]
        if not part:
            continue
        n_b = min(cfg.max_N, -(-max(p[0] for p in part) // 8) * 8)
        t_b = min(cfg.max_T, -(-max(p[1] for p in part) // 8) * 8)
        shapes.append((n_b, t_b))
    shapes.append((cfg.max_N, cfg.max_T))
    # drop degenerate duplicates (tiny corpora)
    out = []
    for s in shapes:
        if not out or (s[0] > out[-1][0] or s[1] > out[-1][1]):
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# training loader


def load_dataset_index(cfg: Config, feature_dir: str = ".",
                       data_dir: Optional[str] = None,
                       on_the_fly: bool = False) -> List[Example]:
    """Examples whose features exist and fit the static grid: prepro mode
    checks for the precomputed mels/<name>.npy, on-the-fly mode for the
    source wav."""
    examples = parse_transcript(cfg, data_dir)
    out = []
    for ex in examples:
        if on_the_fly:
            if not os.path.exists(ex.fpath):
                continue
        else:
            base = ex.fname.replace(".wav", ".npy")
            if not os.path.exists(os.path.join(feature_dir, "mels", base)):
                continue
        if len(ex.text_ids) > cfg.max_N:
            continue
        out.append(ex)
    return out


class TrainLoader:
    """Threaded, shuffled, statically-shaped batch loader.

    Produces numpy dicts with keys texts (B, max_N) i32, mels (B, max_T,
    n_mels) f32, mags (B, max_T*r, n_freq) f32, text_lens (B,), mel_lens
    (B,). ``num_threads`` workers read .npy files (or compute features, on
    the fly) and a bounded queue holds assembled batches. Raises when no
    bucket holds a full batch (the JAX package's loader waits forever
    then).
    """

    def __init__(self, cfg: Config, examples: Sequence[Example],
                 feature_dir: str = ".", *, batch_size: Optional[int] = None,
                 num_threads: int = 8, queue_batches: int = 4, seed: int = 0,
                 drop_overlong: bool = True, on_the_fly: bool = False,
                 buckets: Optional[Sequence[tuple]] = None):
        self.cfg = cfg
        self.feature_dir = feature_dir
        # on_the_fly: workers decode wavs and compute spectrograms (numpy)
        # instead of reading .npy features
        self.on_the_fly = on_the_fly
        self.batch_size = batch_size or cfg.B
        self.rng = np.random.default_rng(seed)
        self.examples = list(examples)
        if drop_overlong:
            self.examples = [e for e in self.examples
                             if len(e.text_ids) <= cfg.max_N]
        if not self.examples:
            raise ValueError("no usable examples")
        # length buckets: each example is assigned the smallest (N_b, T_b)
        # shape that fits both its text and its mel; batches never mix
        # buckets
        self.buckets: Optional[List[tuple]] = (
            [tuple(b) for b in buckets] if buckets else None)
        if self.buckets:
            assert self.buckets[-1] == (cfg.max_N, cfg.max_T), \
                "last bucket must be the full grid"
            self._bucket_examples: List[List[Example]] = \
                [[] for _ in self.buckets]
            for ex in self.examples:
                # on-the-fly: wav-header length estimate (an upper bound —
                # trim only shortens, so the example always fits its bucket)
                t = _example_mel_len(cfg, ex, feature_dir, on_the_fly)
                n_len = min(len(ex.text_ids), cfg.max_N)
                t_len = min(t, cfg.max_T)
                for bi, (n_b, t_b) in enumerate(self.buckets):
                    if n_len <= n_b and t_len <= t_b:
                        self._bucket_examples[bi].append(ex)
                        break
            self.num_batches = sum(len(g) // self.batch_size
                                   for g in self._bucket_examples)
        else:
            self.num_batches = len(self.examples) // self.batch_size
        if self.num_batches == 0:
            raise ValueError(
                f"no full batch of {self.batch_size}: {len(self.examples)} "
                f"examples" + (f" in buckets {self.buckets}" if self.buckets
                               else "") + "; use fewer buckets or a smaller "
                "batch")
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_batches)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # bounded: an unbounded work queue would let the feeder race ahead
        # of the workers by whole epochs of (shape, examples) items
        self._work: "queue.Queue" = queue.Queue(maxsize=2 * num_threads + 4)
        self._num_threads = num_threads

    # -- example assembly ------------------------------------------------
    def _load_example(self, ex: Example):
        cfg = self.cfg
        if self.on_the_fly:
            from ..dsp.audio import load_wav
            from ..dsp.features_np import wav_to_spectrograms_np
            y = load_wav(ex.fpath, cfg.sr)
            mel, mag = wav_to_spectrograms_np(y, cfg)
            mel, mag = reduce_mel(mel, mag, cfg.r)
        else:
            base = ex.fname.replace(".wav", ".npy")
            mel = np.load(os.path.join(self.feature_dir, "mels", base))
            mag = np.load(os.path.join(self.feature_dir, "mags", base))
        t = min(mel.shape[0], cfg.max_T)
        return ex.text_ids, mel[:t], mag[: t * cfg.r], t

    def _assemble(self, batch_examples, shape: Optional[tuple] = None):
        cfg = self.cfg
        max_n, max_t = shape if shape is not None else (cfg.max_N, cfg.max_T)
        B = len(batch_examples)
        texts = np.zeros((B, max_n), np.int32)
        mels = np.zeros((B, max_t, cfg.n_mels), np.float32)
        mags = np.zeros((B, max_t * cfg.r, cfg.n_freq), np.float32)
        text_lens = np.zeros((B,), np.int32)
        mel_lens = np.zeros((B,), np.int32)
        for i, ex in enumerate(batch_examples):
            ids, mel, mag, t = self._load_example(ex)
            t = min(t, max_t)
            texts[i, : len(ids)] = ids[:max_n]
            mels[i, :t] = mel[:t]
            mags[i, : t * cfg.r] = mag[: t * cfg.r]
            text_lens[i] = min(len(ids), max_n)
            mel_lens[i] = t
        return {"texts": texts, "mels": mels, "mags": mags,
                "text_lens": text_lens, "mel_lens": mel_lens}

    # -- iteration -------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        """Infinite epoch-shuffled stream, in the shuffle's order. A worker
        crash (unreadable or mismatched features) is re-raised here instead
        of leaving the consumer waiting on an empty queue."""
        self.start()
        done, want = {}, 0    # batches that finished ahead of their turn
        try:
            while True:
                if want in done:
                    yield done.pop(want)
                    want += 1
                    continue
                try:
                    seq, batch = self._queue.get(timeout=1.0)
                    done[seq] = batch
                except queue.Empty:
                    if self._error is not None:
                        raise RuntimeError(
                            "data loader worker failed") from self._error
                    if self._stop.is_set():
                        return
        finally:
            self.stop()

    def batches(self, n: int) -> Iterator[dict]:
        it = iter(self)
        for _ in range(n):
            yield next(it)

    # -- threading -------------------------------------------------------
    def start(self):
        if self._threads:
            return
        self._stop.clear()
        feeder = threading.Thread(target=self._feed, daemon=True)
        feeder.start()
        self._threads.append(feeder)
        for _ in range(self._num_threads):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=0.2)
        self._threads = []
        for q in (self._queue, self._work):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def _epoch_batches(self):
        """One epoch's (shape, examples) work items, shuffled: without
        buckets one shuffled pass at the full grid; with buckets a shuffle
        within each bucket, then a shuffle of the interleaving of the
        buckets' batches."""
        if not self.buckets:
            order = self.rng.permutation(len(self.examples))
            return [(None, [self.examples[j] for j in
                            order[i * self.batch_size:
                                  (i + 1) * self.batch_size]])
                    for i in range(self.num_batches)]
        items = []
        for shape, group in zip(self.buckets, self._bucket_examples):
            order = self.rng.permutation(len(group))
            for i in range(len(group) // self.batch_size):
                idx = order[i * self.batch_size: (i + 1) * self.batch_size]
                items.append((shape, [group[j] for j in idx]))
        self.rng.shuffle(items)
        return items

    def _feed(self):
        seq = 0
        while not self._stop.is_set():
            for item in self._epoch_batches():
                if self._stop.is_set():
                    return
                while not self._stop.is_set():
                    try:
                        self._work.put((seq, item), timeout=0.2)
                        seq += 1
                        break
                    except queue.Full:
                        continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                seq, (shape, batch_examples) = self._work.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                batch = self._assemble(batch_examples, shape)
            except Exception as e:  # surface worker crashes to the consumer
                self._error = e
                self._stop.set()
                return
            while not self._stop.is_set():
                try:
                    self._queue.put((seq, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
