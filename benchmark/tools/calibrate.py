"""The readings that a cell's limits are set from, in one process on the
card (the benchmark's own runs never run this):

    python3 benchmark/tools/calibrate.py --workload <name> --seeds 12 \
        --first <seed> --control 3 [--out file.json]

* the program: ``--seeds`` seeds from ``--first``, each set up and run
  for the units its sample needs (two passes, forty requests, or the
  checked steps), then judged as a run is: the lower readings;
* the control (``--control`` of those seeds): the reference in the
  program's place in the nearest precision below the configuration's,
  TF32 for float32 (``Cell.control``), judged by the same numbers: the
  upper readings;
* the driver's faults on the card (``Cell.faults``; training: half of
  each checked batch left out and the mean taken over the rest, in the
  reference put in the program's place; a state left unchanged reads 1
  by measure);
* a witness (``--witness`` seeds): the reference in float32 with TF32
  off in the program's place, judged as the program is: what float32
  arithmetic itself reads.

Prints a JSON line per reading and a summary (each number's largest
program reading, smallest control and fault readings)."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--witness", type=int, default=None,
                    help="seeds with the float32 witness (default "
                         "--control)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import check
    from benchmark.harness.registry import Registry
    from benchmark.harness.runner import prepare

    reg = Registry()
    out = {"workload": args.workload, "program": [], "control": [],
           "half_batch": [], "float32": []}
    witness = args.control if args.witness is None else args.witness
    for i in range(args.seeds):
        seed = args.first + i
        t0 = time.perf_counter()
        _, cell = prepare(args.workload, seed, reg, args.rehearse)
        cell.run_window(0.0, cell.sample_units())
        nums = cell.judge()
        rec = {"seed": seed, "numbers": nums,
               "seconds": time.perf_counter() - t0}
        if hasattr(cell, "ref"):
            gaps = check.leaf_gaps(cell.run, cell.ref)
            rec["worst"] = {k: sorted(v.items(), key=lambda x: -x[1])[:3]
                            for k, v in gaps.items()}
            rec["losses"] = [cell.run["losses"], cell.ref["losses"]]
        print(json.dumps({"program": rec}), flush=True)
        out["program"].append(rec)
        readings = []
        if i < args.control:
            readings.append(("control", cell.control()))
            readings += list(cell.faults().items())
        if i < witness:
            readings.append(("float32", cell.control(tf32_on=False)))
        for kind, numbers in readings:
            print(json.dumps({kind: {"seed": seed, "numbers": numbers}}),
                  flush=True)
            out.setdefault(kind, []).append({"seed": seed,
                                             "numbers": numbers})
        del cell
        check.release(torch.device("cpu") if args.rehearse
                      else torch.device("cuda", 0))
    names = list(out["program"][0]["numbers"])
    summary = {n: {"lower": max(r["numbers"][n] for r in out["program"]),
                   "control": min((r["numbers"][n] for r in out["control"]),
                                  default=None),
                   "half_batch": min((r["numbers"][n]
                                      for r in out["half_batch"]),
                                     default=None)} for n in names}
    out["summary"] = summary
    out["device"] = (torch.cuda.get_device_name(0)
                     if torch.cuda.is_available() else "cpu")
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
