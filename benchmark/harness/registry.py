"""Finds everything that belongs to one cell by the names in
``BENCHMARK.json``: a configuration's file (the entry's ``file``), a traffic
mix in ``traffic/<traffic>.json``, a cell's limits in
``checks/<workload>.json``, a per-layer metric's reader in
``metrics/<metric>.py`` and the driver that a traffic mix names (its
``driver``) in ``drivers/<driver>.py``. Adding a cell or a metric adds
files and entries; no code here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Registry:
    def __init__(self, repo: str | None = None, bench_dir: str = BENCH_DIR):
        self.repo = repo or os.path.dirname(bench_dir)
        self.dir = bench_dir
        with open(os.path.join(self.repo, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.repo, self._entry("configs", name)
                               ["file"])) as f:
            return json.load(f)

    def _data(self, folder: str, name: str) -> dict:
        with open(os.path.join(self.dir, folder, name + ".json")) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._data("traffic", name)

    def checks(self, workload: str) -> dict:
        return self._data("checks", workload)

    def metrics(self, workload: str, trace: bool) -> list:
        """The cell's end-to-end (trace off) or per-layer (trace on)
        metric entries."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The ``read(readings)`` function of a per-layer metric."""
        path = os.path.join(self.dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    @staticmethod
    def driver(name: str):
        """The ``Cell`` class of ``drivers/<name>.py``: built from (sizes,
        program options, traffic, seed, device), it runs the window
        (``run_window``) and judges it (``judge``)."""
        package = __package__.rsplit(".", 1)[0]
        return importlib.import_module(f"{package}.drivers.{name}").Cell
