"""The harness: BENCHMARK.json and the files it names keep to the
contract's names and characters, cells and metrics are found by name, no
JAX (and nothing of the program in the reference) is loaded, a run on the
CPU at test size is judged correct, and the same run with its timed path
broken is judged not correct."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench.catalog import Catalog
from port_bench.harness import FORBIDDEN, run_cell

from conftest import DATA, ROOT, tiny_root

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)

# The contract's characters: names, units, and paths under the benchmark's folder.
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
_PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_benchmark_json_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert all(_PATH_RE.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME_RE.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert all(NAME_RE.match(k) for k in c["reduced"])


def test_every_file_the_harness_finds_exists_and_is_well_named():
    cat = Catalog(ROOT)
    for wl in SPEC["workloads"]:
        assert cat.config(wl["config"])["name"] == wl["config"]
        assert cat.traffic(wl["traffic"])["block_size"] > 0
        assert cat.limits(wl["name"])
        for m in cat.metrics("per_layer", wl["name"]):
            assert callable(cat.reader(m["name"]))
    for dirpath, _, files in os.walk(os.path.join(ROOT, "port_bench")):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            if "__pycache__" not in rel:
                assert _PATH_RE.match(rel), rel


def test_new_cells_and_metrics_are_found_by_name(tmp_path):
    tiny_root(tmp_path)
    spec = json.load(open(os.path.join(DATA, "BENCHMARK.json")))
    spec["configs"].append(dict(spec["configs"][0], name="tiny_hrnet_b",
                                file="port_bench/configs/tiny_hrnet_b.json"))
    spec["workloads"].append({"name": "tiny_new_cell", "config": "tiny_hrnet_b",
                              "traffic": "tiny_b", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "x", "moves": "frames_per_s",
                              "workloads": ["tiny_new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg = json.load(open(tmp_path / "port_bench/configs/tiny_hrnet.json"))
    (tmp_path / "port_bench/configs/tiny_hrnet_b.json").write_text(
        json.dumps(dict(cfg, name="tiny_hrnet_b")))
    shutil.copy(tmp_path / "port_bench/traffic/tiny.json",
                tmp_path / "port_bench/traffic/tiny_b.json")
    shutil.copy(tmp_path / "port_bench/limits/tiny_hrnet_cell.json",
                tmp_path / "port_bench/limits/tiny_new_cell.json")
    (tmp_path / "port_bench/metrics/new.metric.py").write_text("def read(ctx):\n    return 1.5\n")
    cat = Catalog(str(tmp_path))
    assert cat.config("tiny_hrnet_b")["name"] == "tiny_hrnet_b"
    assert cat.traffic(cat.workload("tiny_new_cell")["traffic"])["block_size"] == 4
    assert "new.metric" in [m["name"] for m in cat.metrics("per_layer", "tiny_new_cell")]
    assert "new.metric" not in [m["name"] for m in cat.metrics("per_layer", "tiny_hrnet_cell")]
    assert cat.reader("new.metric")({}) == 1.5


def _loaded_top_names(modules: list) -> set:
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_path_load_no_jax():
    names = _loaded_top_names([
        "port_bench.harness", "port_bench.calibrate", "port_bench.run",
        "multi_camera_3d_pose_estimation_tpu_torch.cli.estimate",
        "multi_camera_3d_pose_estimation_tpu_torch.io.frames"])
    assert "multi_camera_3d_pose_estimation_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _loaded_top_names(["port_bench.reference", "port_bench.reference.hrnet",
                               "port_bench.reference.swin",
                               "port_bench.reference.pipelines.topdown_full_frame",
                               "port_bench.reference.triangulate", "port_bench.judge",
                               "port_bench.bounds", "port_bench.weights"])
    assert not names & (set(FORBIDDEN) | {"multi_camera_3d_pose_estimation_tpu_torch"})


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", str(2 ** 33), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("workload", ["tiny_hrnet_cell", "tiny_swin_cell"])
def test_cpu_run_is_correct(tiny_catalog, workload, one_thread):
    result = run_cell(tiny_catalog, workload, 2 ** 31 + 7, 4.0, trace=False, device="cpu",
                      log=lambda msg: None)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"frames_per_s", "block_latency_p95_ms", "setup_s"}


class _Broken:
    """The pipeline with its outputs broken in one of the ways a faulty
    timed path could break them."""

    def __init__(self, pipeline, fault):
        self.pipeline, self.fault, self.calls = pipeline, fault, 0

    def run(self, frames, bboxes=None):
        self.calls += 1
        if self.fault == "half_left_out":
            # Only the first half of the frames run; the rest repeat them.
            half = frames.shape[0] // 2
            out = self.pipeline.run(frames[:half], bboxes)
            return {k: torch.cat([v, v[:frames.shape[0] - half]]) for k, v in out.items()}
        out = {k: v.clone() for k, v in self.pipeline.run(frames, bboxes).items()}
        if self.fault == "answer_altered" and self.calls == 3:
            k2 = out["kpts_2d"]
            finite = torch.isfinite(k2[:, :, 0, :])
            t, j, c = [int(i[0]) for i in torch.nonzero(finite, as_tuple=True)]
            k2[t, j, 0, c] += 1.0  # one keypoint's x moved by a pixel
        return out

    def __getattr__(self, name):
        return getattr(self.pipeline, name)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_broken_timed_path_is_not_correct(tiny_catalog, fault, one_thread):
    result = run_cell(tiny_catalog, "tiny_hrnet_cell", 11, 3.0, trace=False, device="cpu",
                      tamper=lambda p: _Broken(p, fault), log=lambda msg: None)
    assert result["correct"] is False
    assert result["failed"] >= 1


class _Trace:
    def __init__(self, launches, seconds, blocks=4):
        self.blocks, self._k = blocks, (launches, seconds)

    def kernel_time(self, patterns):
        return self._k


@pytest.mark.parametrize("metric", ["stage1_roofline", "swin_gemm_roofline",
                                    "window_attention_roofline"])
def test_roofline_reads_none_without_its_kernels(metric):
    from port_bench import bounds

    cat = Catalog(ROOT)
    cfg = cat.config("hrnet_w32_coco_256x192" if metric.startswith("stage1")
                     else "swin_b_coco_256x192")
    read = cat.reader(metric)
    ctx = {"cfg": cfg, "crops_per_block": 512, "bounds": bounds}
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, trace=_Trace(0, 0.0))) is None
    value = read(dict(ctx, trace=_Trace(16, 1.0)))
    assert value is not None and 0 < value < 100
