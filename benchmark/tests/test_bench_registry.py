"""Discovery by name, the guard against the JAX package, and the refusals
of a run that cannot be made."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness.guard import forbidden_modules
from benchmark.harness.registry import Registry
from benchmark.harness.runner import Refused, run_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


@pytest.mark.parametrize("modules,found", [
    (["dc_tts_tpu_torch", "dc_tts_tpu_torch.ops.decode", "numpy"], []),
    (["dc_tts_tpu.models.text2mel"], ["dc_tts_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_like", "flaxen", "dc_tts_tpu_torchx"], []),
])
def test_guard_compares_whole_top_level_names(modules, found):
    assert forbidden_modules(modules) == found


def test_a_run_holding_jax_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(Refused, match="jax"):
        run_cell("synth.lj.single", 5, 0.1, False, rehearse=True)


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(REPO, "--workload", "synth.lj.bulk72", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode == 2 and r.stdout == ""
    assert "refused" in r.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "--workload", "synth.lj.bulk72", "--seed", "1",
             "--seconds", "1", "--trace", "0", "--rehearse")
    assert r.returncode != 0 and r.stdout == ""


def _new_registry(tmp_path):
    """A copy of the benchmark's data with one cell and one per-layer
    metric more, added as files and entries only."""
    root = tmp_path / "repo"
    bench = root / "benchmark"
    for d in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "synth.lj.bulk8",
                              "config": "dctts_lj.synth", "traffic": "bulk8",
                              "chips": 1, "why": "chunks of 8"})
    for m in spec["end_to_end"]:
        if m["name"] == "synth_audio_s_per_s":
            m["workloads"].append("synth.lj.bulk8")
    spec["per_layer"].append({"name": "bulk8.calls", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "Entry", "moves": "synth_audio_s_per_s",
                              "workloads": ["synth.lj.bulk8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with open(os.path.join(BENCH, "traffic", "bulk72.json")) as f:
        traffic = json.load(f)
    traffic.update(rows=16, chunk=8,
                   rehearsal={"rows": 8, "chunk": 2, "sample": 3,
                              "sample_passes": 1, "trace_units": 1})
    (bench / "traffic" / "bulk8.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "checks" / "synth.lj.bulk72.json",
                bench / "checks" / "synth.lj.bulk8.json")
    (bench / "metrics" / "bulk8.calls.py").write_text(
        "def read(r):\n    return float(r.calls())\n")
    return Registry(str(root), str(bench))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_by_files_is_found_and_runs(tmp_path, trace):
    reg = _new_registry(tmp_path)
    assert reg.traffic("bulk8")["chunk"] == 8
    result, _ = run_cell("synth.lj.bulk8", 11, 0.1, bool(trace), reg=reg,
                         rehearse=True)
    want = {"synth_audio_s_per_s", "setup_s"} if not trace else \
        {"bulk8.calls"}
    assert set(result["metrics"]) == want
    assert result["correct"] and result["device"]["platform"] == "cpu"
    assert all(m["value"] is None for m in result["metrics"].values())


def test_a_metric_added_by_a_file_is_read(tmp_path):
    reg = _new_registry(tmp_path)
    fake = types.SimpleNamespace(calls=lambda: 30)
    assert reg.reader("bulk8.calls")(fake) == 30.0
    assert [m["name"] for m in reg.metrics("synth.lj.bulk8", True)] == \
        ["bulk8.calls"]


@pytest.mark.parametrize("traffic", sorted(
    f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic"))))
def test_each_traffic_names_a_driver_found_by_name(traffic):
    reg = Registry()
    cell = reg.driver(reg.traffic(traffic)["driver"])
    for method in ("run_window", "instrument", "attempted", "sample_units",
                   "judge", "control", "faults", "free"):
        assert callable(getattr(cell, method)), method
