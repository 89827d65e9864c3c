"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use every source is compiled by ``nvcc`` for ``sm_90a`` (one
compiler process per source, all started together), the objects are linked
into one shared library with a plain C interface under ``_build/``, and the
library is loaded with ``ctypes``. The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. No PyTorch header is included: a source that includes them
takes minutes to compile instead of seconds.

Every C entry takes device pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launches; ``check`` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
Fl = ctypes.c_float
U = ctypes.c_uint

# argument types of each C entry, in order (see the sources)
_SIGNATURES = {
    "dctts_decode": [P] * 10 + [I] * 8 + [Fl] + [I] * 18 + [U, P, P],
    "dctts_decode_coresident": [I, I, ctypes.POINTER(I), ctypes.POINTER(I)],
    "dctts_decode_barriers": [P, I, I, P],
    "dctts_decode_exchanges": [P, I, I, I, P],
    "dctts_gl2": [P] * 8 + [ctypes.POINTER(I)] + [I] * 12
                 + [ctypes.POINTER(I), P],
    "dctts_gl_k3a": [P] * 9 + [I] * 12 + [P],
    "dctts_gl_k3b": [P] * 8 + [I] * 12 + [P],
    "dctts_hc_fwd": [P] * 10 + [I] * 7 + [Fl, I, P],
    "dctts_hc_bwd": [P] * 17 + [I] * 7 + [Fl, I, I, I, P],
    "dctts_ct_full": [P] * 5 + [I] * 2 + [P],
    "dctts_ct_fact": [P] * 8 + [I] * 5 + [P],
    "dctts_ssrn_prologue": [P] * 3 + [I] * 9 + [P],
    "dctts_ssrn_epilogue": [I] + [P] * 10 + [I] * 4 + [Fl, P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    # the CUDA toolkit's default install prefix
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libdctts_{_digest()}.so")


def build() -> str:
    """Compile the sources if the library for their hash is missing;
    returns the library's path. The compiler's register/shared-memory report
    goes to ``<library>.log``."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cus]
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", src, "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [src for src, p in zip(cus, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(logs))
        lib_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        with open(out + ".log", "w") as f:
            f.write("\n".join(logs))
        os.replace(lib_tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ptxas_report(log: str | None = None) -> dict:
    """{entry function (mangled name): {"registers", "spill_stores",
    "spill_loads", "smem" (static bytes)}} from ptxas's ``-v`` report: the
    text ``log``, or the build log of the library (``build``)."""
    if log is None:
        with open(library_path() + ".log") as f:
            log = f.read()
    out, entry, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_stores": 0,
                          "spill_loads": 0, "smem": 0}
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and props in out:
            out[props]["spill_stores"] = int(m.group(1))
            out[props]["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[entry]["smem"] = int(m.group(1)) if m else 0
    return out


def timed_build() -> float:
    """Seconds to build (or find) and load the library."""
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
