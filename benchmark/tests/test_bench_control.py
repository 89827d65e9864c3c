"""The control comes out not correct: the reference put in the program's
place in the nearest precision below the configuration's (float32 with
TF32 on, where the configuration states float32), at the cell's own
widths, judged by the cell's numbers and limits. Needs the card (TF32
exists only there): ``python -m pytest -m cuda
benchmark/tests/test_bench_control.py``."""
import json
import os

import pytest
import torch

from benchmark.harness import check
from benchmark.harness.registry import Registry
from benchmark.harness.runner import prepare

with open(os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 runs only on a CUDA device")
    reg = Registry()
    limits = reg.checks(workload)["numbers"]
    _, cell = prepare(workload, 2 ** 31 + 977, reg, False)
    cell.run_window(0.0, cell.sample_units())
    sound = check.verdict(cell.judge(), limits)
    assert sound[0], sound[2]
    correct, _, checks = check.verdict(cell.control(), limits)
    assert not correct, checks
