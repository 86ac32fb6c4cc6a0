"""One run of one cell: set-up, the timed window, the traced stretch (with
``--trace 1``), then the reference and the verdict.

The window drives the estimate step as a user runs it, minus video
decode: a pipeline from ``cli.estimate.build_estimate_pipeline`` (the
project directory and an MMPose-format checkpoint written here from the
seed), fed by ``io.stage_blocks`` from the traffic's host blocks and
drained by ``cli.estimate.run_pipeline_on_blocks`` with the traffic's
``inflight``, closed loop: a block is handed over as soon as the staging
ring takes it.  The generator stamps each block as it hands it over; the
``on_block`` hook (the live preview's) stamps it as its three artifacts
reach host memory.  The window opens at the first hand-off and closes
``seconds`` later; no block is handed over after it, and the blocks in
flight are drained and judged but not counted.
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import tempfile
import time

import torch

from . import bounds
from .catalog import Catalog
from .devtrace import SPAN, DeviceTrace
from .judge import MEANS, NAMES, judge
from .reference import EXACT, HEAD_KEY, build_model, no_tf32
from .reference.pipeline import crops_of, run_block
from .rig import make_rig, write_project
from .traffic import cycle_blocks, make_blocks
from .weights import calibrate_head, draw_state_dict

__all__ = ["FORBIDDEN", "forbidden_modules", "Cell", "run_cell"]

# Top-level module names the benchmark's process may not hold: JAX and the
# JAX package (compared whole: the port's name only begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_camera_3d_pose_estimation_tpu")
# The traced run profiles two stretches of the window, one after the
# other, each ending with a synchronize so that every launch it holds has
# run: "device" records only the card's activity (little cost to the host:
# busy and idle time, device operations), "host" the host's operations too
# (the block spans: launches per block, the kernels' rooflines, idle gaps
# by host event), which slows the host several-fold where it is the
# bottleneck.  They close the window, leaving TRACE_GAP after each for the
# profiler to stop (reading tens of thousands of events, while the
# pipeline waits), and the model's share of the peak is read over the
# stretch before them, from FILL_SECONDS on (the pipeline has filled).
TRACE_SECONDS = 4.0
TRACE_GAP = 8.0
FILL_SECONDS = 2.0
STRETCHES = ("device", "host")
_BIG = 1e300  # stands for +inf in the JSON line
# Frames of the first block whose crops set the heatmaps' scale.
CALIBRATION_FRAMES = 8


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Spanned:
    """The pipeline with a ``port_bench.block`` span around each ``run``:
    the traced run's mark of the calls into the block pipeline."""

    def __init__(self, pipeline):
        self._pipeline = pipeline

    def run(self, frames, bboxes=None):
        with torch.profiler.record_function(SPAN):
            return self._pipeline.run(frames, bboxes)

    def __getattr__(self, name):
        return getattr(self._pipeline, name)


class _Tracer:
    """Runs the `STRETCHES` from the drain's ``on_block`` hook; each is
    (profiler, start, stop) on the host clock.  ``first_call`` is when the
    first profiler was asked for: starting one stalls the loop (CUPTI's
    set-up took ~5.7 s on an H100), so the untraced part ends there."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.done = {}
        self.prof = None
        self.first_call = None

    def tick(self, now: float, t0: float, close: float) -> None:
        if self.prof is not None:
            if now >= self.start + TRACE_SECONDS or now >= close - 0.5:
                self.finish()
            return
        left = len(STRETCHES) - len(self.done)
        if left and now >= max(t0 + FILL_SECONDS, close - left * (TRACE_SECONDS + TRACE_GAP)) \
                and now < close - 1.0:
            self.name = STRETCHES[len(self.done)]
            if self.first_call is None:
                self.first_call = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CUDA] if self.cuda else []
            if self.name == "host" or not self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CPU)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.start = time.perf_counter()

    def finish(self) -> None:
        if self.prof is not None:
            if self.cuda:
                torch.cuda.synchronize()
            stop = time.perf_counter()
            self.prof.stop()
            self.done[self.name] = (self.prof, self.start, stop)
            self.prof = None

def _percentile(values: list, q: int) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Cell:
    """A cell's inputs for one seed: its configuration, traffic, limits and
    rig, the seeded weights (a state dict in MMPose's format) and the host
    blocks; made by the benchmark, handed the same to the program and to
    the reference."""

    def __init__(self, cat: Catalog, workload: str, seed: int, device):
        wl = cat.workload(workload)
        self.workload, self.seed, self.device = workload, seed, device
        self.cfg, self.traffic = cat.config(wl["config"]), cat.traffic(wl["traffic"])
        self.limits = cat.limits(workload)
        self.T, self.C = self.traffic["block_size"], self.traffic["rig"]["cameras"]
        self.rig = make_rig(self.traffic["rig"], self.traffic["width"], self.traffic["height"])
        self.meta = build_model(self.cfg, "meta")
        self.host = make_blocks(self.traffic, seed, device)
        self.state = draw_state_dict(self.meta, seed, device)
        model = build_model(self.cfg, device)
        model.load_state_dict(self.state, strict=True)
        frames = torch.from_numpy(self.host[0][:CALIBRATION_FRAMES]).to(device)
        with no_tf32():
            self.head_scale = calibrate_head(model, crops_of(frames, self.cfg), self.state,
                                             self.cfg["head_peak"], HEAD_KEY)
        del model

    def pipeline(self):
        """The program's pipeline, as ``cli.estimate`` builds it: a project
        directory and a checkpoint file written under ``TMPDIR``, removed
        once read."""
        from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import \
            build_estimate_pipeline

        with tempfile.TemporaryDirectory(prefix="port_bench_") as project:
            write_project(project, self.rig)
            ckpt = os.path.join(project, "weights.pth")
            torch.save({"state_dict": self.state}, ckpt)
            return build_estimate_pipeline(
                project, pose_estimation_model=self.cfg["registry_name"], checkpoint=ckpt,
                conf_threshold=self.cfg["conf_threshold"], num_joints=self.cfg["num_joints"],
                estimator_kwargs=self.cfg["estimator_kwargs"], device=self.device)

    def rig_tensors(self) -> dict:
        return {k: torch.as_tensor(self.rig[k], dtype=torch.float64, device=self.device)
                for k in ("K", "R", "T", "dist")}

    def references(self, rounding=EXACT) -> list:
        """`reference.pipeline.run_block` of each host block, float32 with
        TF32 off (``rounding``: EXACT, or CONTROL for the control)."""
        model = build_model(self.cfg, self.device, rounding)
        model.load_state_dict(self.state, strict=True)
        rig = self.rig_tensors()
        with no_tf32():
            return [run_block(model, torch.from_numpy(b).to(self.device), self.cfg, rig,
                              rounding) for b in self.host]

    def judge(self, outputs: tuple, n_blocks: int, refs: list) -> dict:
        with no_tf32():
            return judge(outputs, n_blocks, refs, self.rig_tensors(), self.cfg, self.device)


def run_cell(cat: Catalog, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", tamper=None, t_start: float | None = None, log=None) -> dict:
    """Run ``workload`` once; returns the result line's dict (with
    ``checks`` last).  ``tamper(pipeline)``, for the harness's own tests,
    stands in for the pipeline in the window."""
    from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import run_pipeline_on_blocks
    from multi_camera_3d_pose_estimation_tpu_torch.io.frames import stage_blocks

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cat, workload, seed, device)
    cfg, traffic, limits, T, C = cell.cfg, cell.traffic, cell.limits, cell.T, cell.C

    # Set-up: the seeded weights and host blocks (above), the pipeline from
    # a project directory and checkpoint file, and a warm-up through the
    # same loop as the window.
    pipeline = cell.pipeline()
    run_pipeline_on_blocks(pipeline, stage_blocks(cycle_blocks(cell.host, traffic["warmup_blocks"]),
                                                  device),
                           progress=False, inflight=traffic["inflight"])
    _sync(device)

    timed = pipeline if tamper is None else tamper(pipeline)
    if trace:
        timed = _Spanned(timed)
    handoff, done = [], []
    clock = {"t0": None, "close": None}
    tracer = _Tracer(device) if trace else None

    def on_handoff(i: int) -> bool:
        now = time.perf_counter()
        if clock["t0"] is None:
            clock["t0"], clock["close"] = now, now + seconds
        elif now >= clock["close"]:
            return False
        handoff.append(now)
        return True

    def on_block(frames, kpts_2d, offset) -> None:
        now = time.perf_counter()
        done.append(now)
        if tracer is not None:
            tracer.tick(now, clock["t0"], clock["close"])

    copy_events = [] if trace else None
    outputs = run_pipeline_on_blocks(
        timed, stage_blocks(cycle_blocks(cell.host, on_handoff=on_handoff), device,
                            copy_events=copy_events),
        progress=False, inflight=traffic["inflight"], on_block=on_block)
    if tracer is not None:
        tracer.finish()
    _sync(device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"port_bench: the process holds {found} after the window")

    t0, close = clock["t0"], clock["close"]
    in_window = [b for b, t in enumerate(done) if t <= close]
    lat_ms = [(done[b] - handoff[b]) * 1e3 for b in in_window]
    frames_done = len(in_window) * T
    cuda = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    log(f"port_bench: {workload} seed {seed}: set-up {t0 - t_start:.3f} s, {len(handoff)} blocks "
        f"handed over, {len(in_window)} of {T} frames x {C} cameras finished in the "
        f"{seconds} s window")
    if lat_ms:
        log(f"port_bench: block latency median {statistics.median(lat_ms):.3f} ms over "
            f"{len(lat_ms)} blocks")

    metrics, breakdown = {}, None
    if not trace:
        values = {"frames_per_s": frames_done / seconds,
                  "block_latency_p95_ms": _percentile(lat_ms, 95) if len(lat_ms) >= 2 else None,
                  "setup_s": t0 - t_start}
        for m in cat.metrics("end_to_end", workload):
            value = values.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        traces = {name: DeviceTrace(prof, stop - start)
                  for name, (prof, start, stop) in tracer.done.items()}
        on_device, on_host = traces.get("device"), traces.get("host")
        if on_device is not None:
            dev_info["busy_s"] = min(on_device.busy_s, on_device.window_s)
            dev_info["window_s"] = on_device.window_s
            breakdown = {"device_ops": on_device.top_ops(),
                         "idle_gaps": on_host.idle_gaps() if on_host else []}
        for name, tr in traces.items():
            log(f"port_bench: {name} stretch {tr.window_s:.3f} s, {tr.blocks} complete blocks, "
                f"{len(tr.device)} device events ({tr.tied} tied to a launch), busy "
                f"{tr.busy_s:.3f} s")
        # The model's share of the peak: the frames finished between the
        # pipeline's fill and the first traced stretch, over that time.
        first = tracer.first_call or close
        untraced = [b for b in in_window if t0 + FILL_SECONDS < done[b] <= first]
        untraced_s = first - t0 - FILL_SECONDS
        log(f"port_bench: untraced {len(untraced)} blocks in {untraced_s:.3f} s "
            f"({len(untraced) * T / max(untraced_s, 1e-9):.3f} frames/s) before the stretches")
        h2d = [s.elapsed_time(e) for s, e in (copy_events or [])[:len(in_window)]] if cuda \
            else []
        ctx = {"trace": on_host, "device_trace": on_device, "cfg": cfg, "traffic": traffic,
               "crops_per_block": T * C, "untraced_s": untraced_s,
               "untraced_frames": len(untraced) * T, "h2d_ms": h2d, "bounds": bounds,
               "flops_per_crop": bounds.model_flops_per_crop(
                   lambda: cell.meta(torch.empty((1, 3, cfg["input_size"][1],
                                                  cfg["input_size"][0]), device="meta")))}
        for m in cat.metrics("per_layer", workload):
            value = cat.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tracer.done.clear()
        traces = on_device = on_host = None

    # The program's state goes; then the reference, on the same inputs.
    del timed, pipeline
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict = cell.judge(outputs, len(done), cell.references())
    numbers = verdict["numbers"]
    compared = [n for n in NAMES if n in limits]
    # A block fails where its worst joint is over a limit, or where its
    # mean is over the limit of a mean that fails the run.
    flagged = [n for n in compared
               if n not in MEANS or numbers[n] > limits[n]["limit"]]
    over = sum(bool(any(verdict["per_block"][n][b] > limits[n]["limit"] for n in flagged))
               for b in range(len(done)))
    missing = len(handoff) - len(done)
    correct = (bool(in_window) and bool(compared) and missing == 0
               and all(numbers[n] <= limits[n]["limit"] for n in compared))
    log(f"port_bench: reference and judge {time.perf_counter() - t_ref:.3f} s over "
        f"{len(done)} blocks")
    checks = {n: {"value": min(numbers[n], _BIG), "limit": limits[n]["limit"]} for n in compared}
    for n in NAMES:
        if n not in compared:
            log(f"port_bench: not compared {n} {numbers[n]!r}")
    for n in compared:
        log(f"check {n} {checks[n]['value']!r} limit {checks[n]['limit']!r}")
    result = {"correct": correct, "attempted": len(handoff), "failed": over + missing,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
