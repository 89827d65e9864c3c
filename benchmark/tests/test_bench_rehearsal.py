"""Every cell's control flow and comparison on the CPU at the
configurations' rehearsal sizes: correct, and no number under any
metric."""
import json
import os

import pytest

from benchmark.harness.registry import Registry
from benchmark.harness.runner import run_cell

with open(os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal(workload, trace):
    reg = Registry()
    result, lines = run_cell(workload, 2 ** 31 + 17, 0.2, bool(trace),
                             rehearse=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in
                                      reg.metrics(workload, bool(trace))}
    assert all(m["value"] is None for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(reg.checks(workload)["numbers"])
    assert len(lines) == len(result["checks"]) + 1   # the window's line
