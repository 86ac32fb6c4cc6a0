"""Finds everything a cell needs by the names in ``BENCHMARK.json``, so that
a new cell or metric is a new file and a new entry, never an edit:

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``port_bench/traffic/<traffic>.json``;
- a cell's limits for ``correct``: ``port_bench/limits/<workload>.json``;
- a per-layer metric: ``port_bench/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the value or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os

__all__ = ["Catalog"]


class Catalog:
    def __init__(self, root: str):
        """``root``: the checkout, holding ``BENCHMARK.json`` and ``port_bench/``."""
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.bench_dir = os.path.join(root, "port_bench")

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.root, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for wl in self.spec["workloads"]:
            if wl["name"] == name:
                return wl
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for cfg in self.spec["configs"]:
            if cfg["name"] == name:
                return self._json(cfg["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("port_bench", "traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("port_bench", "limits", f"{workload}.json")

    def metrics(self, kind: str, workload: str) -> list:
        """The ``kind`` ("end_to_end" or "per_layer") metric entries that
        ``workload`` reports."""
        return [m for m in self.spec[kind] if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        """The ``read`` function of ``port_bench/metrics/<metric>.py``."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "port_bench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
