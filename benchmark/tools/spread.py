"""The spread of a cell's end-to-end metrics over two sets of runs, and the
bound it suggests:

    python3 benchmark/tools/spread.py results.jsonl

Each line of the input is ``{"cell", "set", "seed", "result"}`` (the run's
result line). For each cell and metric: each set's median and its spread,
the distance between the first and third quartiles (Python's
``statistics.quantiles(values, n=4)``) over the median; the wider of the
two sets' spreads, five times it (never under 1 %), and the second set's
median against the first's."""
from __future__ import annotations

import collections
import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(path: str) -> int:
    runs = collections.defaultdict(lambda: collections.defaultdict(list))
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            for m, v in r["result"]["metrics"].items():
                runs[(r["cell"], m)][r["set"]].append(v["value"])
    for (cell, m), sets in sorted(runs.items()):
        if len(sets) < 2 or min(len(v) for v in sets.values()) < 2:
            print(cell, m, dict(sets))
            continue
        a, b = (sets[k] for k in sorted(sets))
        sa, sb = spread(a), spread(b)
        drift = statistics.median(b) / statistics.median(a) - 1
        print(f"{cell:20s} {m:20s} median {statistics.median(a):.6g} / "
              f"{statistics.median(b):.6g} spread {sa:.4%} / {sb:.4%} "
              f"-> bound {max(0.01, 5 * max(sa, sb)):.4%}; second set "
              f"{drift:+.4%}; all {sorted(a + b)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
