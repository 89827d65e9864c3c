"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a traced window. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number beside its limit); the last lines of
standard error repeat the checks. A machine without the CUDA devices the
cell asks for, or a process that holds JAX or the JAX package, ends with a
non-zero code and no result. ``--rehearse`` runs the cell's control flow
and its comparison on the CPU at the configuration's rehearsal sizes and
reports no number under any metric.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the program inside the checkout, at fixed
# paths: only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
# one process with few threads: one OpenMP / BLAS thread, the process on
# two fixed cores (a host-paced request's p95 spread 14-17 % from run to
# run with the defaults, 1.5 % so; PERF.md)
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
_cpus = sorted(os.sched_getaffinity(0))
if len(_cpus) >= 4:
    os.sched_setaffinity(0, _cpus[2:4])
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    from benchmark.harness.runner import Refused, run_cell, stderr
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), rehearse=args.rehearse,
                                  t_start=T_START)
    except Refused as e:
        stderr(f"refused: {e}")
        return 2
    stderr(*checks)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
