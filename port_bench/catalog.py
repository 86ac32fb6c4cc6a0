"""Finds everything a cell needs by the names in ``BENCHMARK.json`` and in
the files they name, so that a new cell, metric or configuration is new
files and new entries, never an edit:

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``port_bench/traffic/<traffic>.json``;
- a cell's limits for ``correct``: ``port_bench/limits/<workload>.json``;
- a per-layer metric: ``port_bench/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the value or None where it finds nothing to read.

A configuration file names the rest of its reference, each a file found
by that name:

| Key | File under ``port_bench/reference/`` | What it brings |
|---|---|---|
| ``family`` | ``<family>.py`` | the plain model |
| ``pipeline`` (or ``topdown_full_frame``) | ``pipelines/<pipeline>.py`` | the block, the judge |
| ``detector``: ``{"family", "registry_name", ...}`` | its ``<family>.py`` | a second model |

A family module exports:

- ``MODEL(cfg)``: the reference class, float32, with the checkpoint's
  state-dict names (MMPose's, MMDet's); a detector's is built from
  ``cfg["detector"]``;
- ``HEAD_KEY``: the state-dict key of the final layer's kernel, which
  `weights.calibrate_head` scales (a pose model's);
- optionally ``weight_kind(key, module, param)``: the distribution
  (`weights`) of a parameter or buffer, asked before the shared rules for
  every name, or None to leave it to them;
- optionally ``calibrate(model, state, frames_u8, cfg)``: changes the drawn
  ``state`` in place, given ``model``, the f32 reference holding it on the
  CPU, and the cell's first frames (N, H, W, 3) uint8 RGB, which the module
  turns into its model's input itself (a detector: its published test
  pipeline, exported for its pipeline's ``run_block`` too).  The harness
  calls it for the detector, then for the pose model, then scales the pose
  head, and only then writes the checkpoints.

A pipeline module exports:

- ``calibration_crops(models, frames_u8, cfg)``: the crops of the first
  frames that set the head's scale;
- ``run_block(models, frames_u8, cfg, rig, rounding)``: one host block
  through the reference;
- ``judge(outputs, n_blocks, refs, rig, cfg, device, models=)``:
  ``{"numbers": {name: value}, "per_block": {name: (n_blocks,)}}`` over
  ``NAMES``, of which ``MEANS`` are means over the run (the rest the worst
  block's); ``models`` are the exact reference models (f32, TF32 off, built
  once the program's state is freed), through which a judge can replay
  what the program made on the way, such as its detector's boxes;
- ``program_kwargs(cfg, checkpoints)``: further keywords of
  ``cli.estimate.build_estimate_pipeline``, the estimate CLI's own (such
  as ``detector_model`` and ``detector_checkpoint``);
- ``flops_per_crop(meta_models, cfg, traffic)``: the operations a crop
  costs, a detector's spread over the crops of its frame.

``models`` and ``meta_models`` are ``{"pose": ..., "detector": ...}`` (the
detector where the configuration names one), ``checkpoints`` the same
roles' ``.pth`` paths.  A family or pipeline module is executed from its
file as a module of the package ``port_bench.reference`` (or of its
``pipelines``), so that it imports the shared reference (``lowp``,
``topdown``, ``triangulate``, ``port_bench.judge``) by absolute names, or,
from ``reference/``, by relative ones.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

__all__ = ["Catalog", "find_family", "find_pipeline", "DEFAULT_PIPELINE"]

_MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
# The pipeline of a configuration that names none.
DEFAULT_PIPELINE = "topdown_full_frame"


def _load(root: str, where: tuple, name: str):
    """``<root>/port_bench/<where...>/<name>.py``, executed as the module
    ``port_bench.<where...>.<name>``."""
    if not _MODULE_NAME.match(name):
        raise ValueError(f"{name!r} is not a module name")
    path = os.path.join(root, "port_bench", *where, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {'/'.join(where)} module {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(".".join(("port_bench",) + where + (name,)),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_family(root: str, name: str):
    """The model family module ``port_bench/reference/<name>.py`` under ``root``."""
    return _load(root, ("reference",), name)


def find_pipeline(root: str, name: str):
    """The pipeline module ``port_bench/reference/pipelines/<name>.py`` under ``root``."""
    return _load(root, ("reference", "pipelines"), name)


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

    def family(self, name: str):
        """The model family module ``port_bench/reference/<name>.py``."""
        return find_family(self.root, name)

    def pipeline(self, cfg: dict):
        """The pipeline module that configuration ``cfg`` names
        (`DEFAULT_PIPELINE` where it names none)."""
        return find_pipeline(self.root, cfg.get("pipeline", DEFAULT_PIPELINE))

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
