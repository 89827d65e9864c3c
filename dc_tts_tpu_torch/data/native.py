"""ctypes bindings to the native data-IO runtime (``native/dataio.cpp``),
the port of ``dc_tts_tpu/data/native.py``.

The C++ library reads wavs and ``.npy`` features and assembles padded
batches on its own threads, off the Python interpreter lock. At first use
it is compiled from the repository's ``native/dataio.cpp`` with the
system's C++ compiler (``$CXX``, else ``c++``; the flags of
``native/Makefile``) into ``dc_tts_tpu_torch/_build/``, under a name that
carries a hash of the source and flags, as ``ops/_build.py`` builds the
kernels. ``available()`` says whether it builds and loads here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Iterator, Optional, Sequence

import numpy as np

from ..config import Config
from .dataset import Example

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "dataio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_i32, _i64, _f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_P = ctypes.c_void_p
_SIGNATURES = {  # name: (restype, argtypes)
    "dcio_wav_read": (_P, [ctypes.c_char_p]),
    "dcio_wav_data": (ctypes.POINTER(_f32), [_P]),
    "dcio_wav_len": (_i64, [_P]),
    "dcio_wav_sr": (_i32, [_P]),
    "dcio_wav_free": (None, [_P]),
    "dcio_loader_create": (_P, [_i32, ctypes.POINTER(_i32),
                                ctypes.POINTER(_i64), ctypes.c_char_p,
                                ctypes.c_char_p] + [_i32] * 8
                           + [ctypes.c_uint64]),
    "dcio_loader_next": (_i32, [_P, ctypes.POINTER(_i32),
                                ctypes.POINTER(_f32), ctypes.POINTER(_f32),
                                ctypes.POINTER(_i32), ctypes.POINTER(_i32)]),
    "dcio_loader_destroy": (None, [_P]),
}


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdcio_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if the one for the source's hash is missing;
    returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler ({cxx}) to build {SOURCE}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([cxx, *_FLAGS, "-o", lib, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    lib = ctypes.CDLL(build())
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
        return True
    except (RuntimeError, OSError):
        return False


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a wav with the native reader -> (float32 mono, sample
    rate)."""
    lib = load()
    h = lib.dcio_wav_read(path.encode())
    if not h:
        raise IOError(f"native wav decode failed: {path}")
    try:
        n = lib.dcio_wav_len(h)
        buf = np.ctypeslib.as_array(lib.dcio_wav_data(h), shape=(n,))
        return buf.copy(), int(lib.dcio_wav_sr(h))
    finally:
        lib.dcio_wav_free(h)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeTrainLoader:
    """The C++ prefetcher behind ``dataset.TrainLoader``'s batch schema
    (texts, mels, mags, text_lens, mel_lens; numpy, the full grid). It
    reads prepro's ``.npy`` features on ``num_threads`` threads, each batch
    ``batch_size`` examples of its own epoch shuffle (a ``std::mt19937``
    seeded with ``seed``, not ``TrainLoader``'s order)."""

    def __init__(self, cfg: Config, examples: Sequence[Example],
                 feature_dir: str = ".", *, batch_size: Optional[int] = None,
                 num_threads: int = 8, queue_batches: int = 4,
                 seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size or cfg.B
        examples = [e for e in examples if len(e.text_ids) <= cfg.max_N]
        if not examples:
            raise ValueError("no usable examples")
        self.num_batches = len(examples) // self.batch_size
        flat, offsets = [], [0]
        mel_paths, mag_paths = [], []
        for e in examples:
            flat.extend(int(i) for i in e.text_ids)
            offsets.append(len(flat))
            base = e.fname.replace(".wav", ".npy")
            mel_paths.append(os.path.join(feature_dir, "mels", base))
            mag_paths.append(os.path.join(feature_dir, "mags", base))
        texts = np.asarray(flat, np.int32)
        offs = np.asarray(offsets, np.int64)
        self._lib = load()
        self._handle = self._lib.dcio_loader_create(
            len(examples), _ptr(texts, _i32), _ptr(offs, _i64),
            "\n".join(mel_paths).encode(), "\n".join(mag_paths).encode(),
            self.batch_size, cfg.max_N, cfg.max_T, cfg.n_mels, cfg.n_freq,
            cfg.r, num_threads, queue_batches, seed)
        if not self._handle:
            raise RuntimeError("dcio_loader_create failed")

    def __iter__(self) -> Iterator[dict]:
        cfg, B = self.cfg, self.batch_size
        while self._handle:
            b = {"texts": np.empty((B, cfg.max_N), np.int32),
                 "mels": np.empty((B, cfg.max_T, cfg.n_mels), np.float32),
                 "mags": np.empty((B, cfg.max_T * cfg.r, cfg.n_freq),
                                  np.float32),
                 "text_lens": np.empty((B,), np.int32),
                 "mel_lens": np.empty((B,), np.int32)}
            rc = self._lib.dcio_loader_next(
                self._handle, _ptr(b["texts"], _i32), _ptr(b["mels"], _f32),
                _ptr(b["mags"], _f32), _ptr(b["text_lens"], _i32),
                _ptr(b["mel_lens"], _i32))
            if rc != 0:
                return
            yield b

    def batches(self, n: int) -> Iterator[dict]:
        it = iter(self)
        for _ in range(n):
            yield next(it)

    def stop(self):
        if getattr(self, "_handle", None):
            self._lib.dcio_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __del__(self):
        self.stop()
