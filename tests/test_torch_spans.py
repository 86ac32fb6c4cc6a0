"""The port's spans (`utils.profiling.span`) and the benchmark's readers of
them.

- With no profiler running, `span` is one shared object that records
  nothing and costs well under a microsecond a call.
- Under ``torch.profiler.profile``, a CPU block through
  `cli.estimate.run_pipeline_on_blocks` records, per block,
  ``dispatch`` ⊃ ``run`` ⊃ {``crop``, ``model``, ``decode``,
  ``triangulate``}, then ``drain_wait`` and ``drain_copy``, with their
  block ids and parents; each span starts within 1 ms of kineto's event
  for it; a span on another thread carries that thread's id.
- Each of `port_bench`'s seven span readers gives its known answer on a
  hand-built list of spans and traces, and None on an empty one.
- On a card (marked ``cuda``, skipped without one): a CUDA-only profiler
  turns the spans on; two staged blocks record the ring's spans on the
  producer's and the launching thread; stage device times are
  non-negative; ``mc3d.pipeline.run`` starts within 0.1 ms of kineto's
  event.  On a machine with a card:

    python -m pytest tests/test_torch_spans.py -p no:cacheprovider --noconftest

This file imports no JAX.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.utils import profiling
from multi_camera_3d_pose_estimation_tpu_torch.utils.profiling import (
    Span,
    clear_spans,
    span,
    spans,
    tracing,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("mc3d.pipeline.crop", "mc3d.pipeline.model", "mc3d.pipeline.decode",
          "mc3d.pipeline.triangulate")
T, C, H, W = 2, 2, 48, 40


def _tiny_pipeline(device):
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import MODEL_REGISTRY

    cfg = MODEL_REGISTRY["test_tiny"]["cfg"]
    return build_pipeline(cfg, (32, 64), (T, C, H, W, 3), device=device)


def _host_blocks(n):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, (T, C, H, W, 3), dtype=np.uint8), T) for _ in range(n)]


def _kineto_mc3d(prof):
    """kineto's host events of the program's spans, by start."""
    return sorted(((ev.name(), ev.start_ns()) for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("mc3d.")
                   and ev.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda e: e[1])


def test_span_without_a_profiler_is_a_shared_noop_under_a_microsecond():
    assert not tracing()
    clear_spans()
    a, b = span("mc3d.test.a"), span("mc3d.test.b", block=3, device=True)
    assert a is b
    with a as inside:
        assert inside is None
    assert spans() == []

    def loop(n=10 ** 5):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("mc3d.test.cost", block=1):
                pass
        return (time.perf_counter() - t0) / n

    per_call = min(loop() for _ in range(5))
    assert per_call < 1e-6, per_call
    assert spans() == []


@pytest.fixture(scope="module")
def cpu_traced():
    """Two CPU blocks through the estimate loop under a CPU profiler: the
    recorder's spans and kineto's events of them."""
    from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import run_pipeline_on_blocks
    from multi_camera_3d_pose_estimation_tpu_torch.io.frames import stage_blocks

    pipe = _tiny_pipeline("cpu")
    blocks = _host_blocks(2)
    pipe.run(blocks[0][0])  # warm-up, untraced
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing()
        out = run_pipeline_on_blocks(pipe, stage_blocks(iter(blocks), "cpu"), progress=False,
                                     inflight=1)
    assert out[0].shape == (2 * T, 17, 3, C)
    recorded = spans()
    clear_spans()
    return recorded, _kineto_mc3d(prof)


def test_cpu_blocks_record_the_span_tree_per_block(cpu_traced):
    recorded, _ = cpu_traced
    assert all(s.thread == threading.get_ident() for s in recorded)
    assert all(s.device_ms is None for s in recorded)  # nothing ran on a card
    for b in (0, 1):
        mine = {}
        for s in recorded:
            if s.block == b:
                assert s.name not in mine, s.name  # one of each per block
                mine[s.name] = s
        assert set(mine) == {"mc3d.estimate.dispatch", "mc3d.pipeline.run",
                             "mc3d.estimate.drain_wait", "mc3d.estimate.drain_copy", *STAGES}
        dispatch, run = mine["mc3d.estimate.dispatch"], mine["mc3d.pipeline.run"]
        assert dispatch.parent is None and run.parent == dispatch.id
        assert dispatch.start_ns <= run.start_ns <= run.end_ns <= dispatch.end_ns
        stages = [mine[n] for n in STAGES]
        for s in stages:
            assert s.parent == run.id
            assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
        assert [s.name for s in sorted(stages, key=lambda s: s.start_ns)] == list(STAGES)
        wait, copy = mine["mc3d.estimate.drain_wait"], mine["mc3d.estimate.drain_copy"]
        assert wait.parent is None and copy.parent is None
        assert dispatch.end_ns <= wait.start_ns <= wait.end_ns <= copy.start_ns
    # Block 1 is dispatched before block 0 is drained (one block in flight).
    first = {s.name: s for s in recorded if s.block == 0}
    second = {s.name: s for s in recorded if s.block == 1}
    assert second["mc3d.estimate.dispatch"].end_ns <= first["mc3d.estimate.drain_wait"].start_ns


def test_recorder_starts_agree_with_kineto_within_a_millisecond(cpu_traced):
    recorded, kineto = cpu_traced
    assert [n for n, _ in kineto] == [s.name for s in recorded]
    worst = max(abs(k - s.start_ns) for (_, k), s in zip(kineto, recorded))
    assert worst < 1_000_000, worst


def test_span_on_a_second_thread_carries_its_thread_id():
    clear_spans()
    seen = {}

    def worker():
        seen["ident"] = threading.get_ident()
        with span("mc3d.test.outer", block=5):
            with span("mc3d.test.inner"):
                pass

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("mc3d.test.main", block=1):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    got = {s.name: s for s in spans()}
    clear_spans()
    assert got["mc3d.test.main"].thread == threading.get_ident()
    outer, inner = got["mc3d.test.outer"], got["mc3d.test.inner"]
    assert outer.thread == inner.thread == seen["ident"] != threading.get_ident()
    # The parent is the enclosing span on the same thread, not the main
    # thread's open one; the child inherits its block id.
    assert outer.parent is None and inner.parent == outer.id and inner.block == 5


# --- the benchmark's readers, on hand-built spans and traces ------------

MS = 1_000_000  # ns


class _Trace:
    """The parts of `port_bench.devtrace.DeviceTrace` the readers use."""

    def __init__(self, device=(), intervals=(), host=()):
        self.device = [(name, s * MS, e * MS, 0, 0) for name, s, e in device]
        self.intervals = [[s * MS, e * MS] for s, e in intervals]
        self.host = [(s * MS, e * MS, name) for s, e, name in host]


def _hand_built():
    main, producer = 1, 2
    rows = [  # id, name, block, parent, thread, start ms, end ms, device ms
        (0, "mc3d.stage.slot_wait", 0, None, producer, 50, 60, None),
        (1, "mc3d.stage.fill", 0, None, producer, 60, 70, None),
        (2, "mc3d.stage.slot_wait", 1, None, producer, 100, 110, None),
        (3, "mc3d.estimate.dispatch", 0, None, main, 150, 300, None),
        (4, "mc3d.pipeline.run", 0, 3, main, 160, 290, None),
        (5, "mc3d.pipeline.crop", 0, 4, main, 170, 180, 4.0),
        (6, "mc3d.pipeline.model", 0, 4, main, 180, 260, 30.0),
        (7, "mc3d.pipeline.decode", 0, 4, main, 260, 270, 1.0),
        (8, "mc3d.pipeline.triangulate", 0, 4, main, 270, 285, 2.0),
        (9, "mc3d.estimate.dispatch", 1, None, main, 300, 600, None),
        (10, "mc3d.pipeline.run", 1, 9, main, 310, 590, None),
        (11, "mc3d.pipeline.crop", 1, 10, main, 320, 330, 6.0),
        (12, "mc3d.pipeline.model", 1, 10, main, 330, 570, 50.0),
        (13, "mc3d.pipeline.triangulate", 1, 10, main, 575, 585, 4.0),
        (14, "mc3d.estimate.drain_wait", 0, None, main, 600, 650, None),
        (15, "mc3d.estimate.drain_copy", 0, None, main, 650, 660, None),
        (16, "mc3d.stage.slot_wait", 2, None, producer, 700, 710, None),
        # Block 2's run opens after the device stretch: not counted.
        (17, "mc3d.estimate.dispatch", 2, None, main, 940, 990, None),
        (18, "mc3d.pipeline.run", 2, 17, main, 960, 980, None),
        (19, "mc3d.pipeline.crop", 2, 18, main, 965, 970, 100.0),
    ]
    recorded = [Span(i, n, b, p, t, s * MS, e * MS, d) for i, n, b, p, t, s, e, d in rows]
    device = _Trace(device=[("k", 100, 200), ("k", 250, 580), ("k", 600, 630),
                            ("k", 680, 900)],
                    intervals=[(100, 200), (250, 580), (600, 630), (680, 900)])
    host = _Trace(device=[("k", 1000, 4000)],
                  host=[(1000, 2000, "mc3d.pipeline.run"),
                        (1100, 1200, "cudaStreamSynchronize"), (1300, 1400, "cudaMemcpy"),
                        (1500, 1600, "cudaMemcpyAsync"),
                        (3000, 4000, "mc3d.pipeline.run"),
                        (3100, 3200, "cudaDeviceSynchronize"),
                        (5000, 5100, "cudaStreamSynchronize")])
    return recorded, {"device_trace": device, "trace": host}


KNOWN = {
    "queue_ms_per_block": (110 + 210) / 2,  # run start less slot_wait start
    "dispatch_ms_per_block": (130 + 280) / 2,  # run durations
    "syncs_per_block": 3 / 2,  # three waits inside two run events
    "crop_ms_per_block": (4.0 + 6.0) / 2,
    "model_ms_per_block": (30.0 + 50.0) / 2,
    "triangulate_ms_per_block": (2.0 + 4.0) / 2,
    # Gaps 200-250 (in model 0), 580-600 (in run 1's triangulate), 630-680
    # (in the drain): 70 of 120 ms.
    "idle_in_run_share": 100.0 * 70 / 120,
}


def _reader(metric):
    from port_bench.catalog import Catalog

    return Catalog(ROOT).reader(metric)


@pytest.mark.parametrize("metric", sorted(KNOWN))
def test_span_reader_known_answer_and_none_when_empty(metric, monkeypatch):
    read = _reader(metric)
    recorded, ctx = _hand_built()
    monkeypatch.setattr(profiling, "spans", lambda: list(recorded))
    assert read(ctx) == pytest.approx(KNOWN[metric], rel=1e-12)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    empty = {"device_trace": _Trace(), "trace": _Trace()}
    assert read(empty) is None
    assert read({"device_trace": None, "trace": None}) is None


def test_profile_block_span_table_files_idle_under_the_innermost_span():
    from multi_camera_3d_pose_estimation_tpu_torch.profile_block import span_table

    recorded, ctx = _hand_built()
    intervals = ctx["device_trace"].intervals
    table = span_table(recorded, intervals, thread=1)
    host, dev, idle = table["mc3d.pipeline.model"]
    assert host == pytest.approx(80 + 240) and dev == pytest.approx(80.0)
    assert idle == pytest.approx(50.0)  # the gap that opened at 200 ms
    assert table["mc3d.pipeline.triangulate"][2] == pytest.approx(20.0)
    assert table["mc3d.estimate.drain_wait"][2] == pytest.approx(50.0)
    assert table["mc3d.stage.slot_wait"] == pytest.approx([30.0, None, 0.0])
    assert "(no span)" not in table
    assert span_table(recorded, [[0, 10], [20, 30]], thread=1)["(no span)"][2] == \
        pytest.approx(10 * 1e-6)


# --- on the card -------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_only_profiler_turns_spans_on(card):
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        assert tracing()
        x = torch.ones(1024, device=card)
        with span("mc3d.test.device", block=0, device=True):
            x = x * 2
    torch.cuda.synchronize()
    got = spans()
    clear_spans()
    assert [s.name for s in got] == ["mc3d.test.device"]
    assert got[0].device_ms is not None and got[0].device_ms >= 0


@pytest.mark.cuda
def test_staged_blocks_record_ring_spans_on_both_threads(card):
    from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import run_pipeline_on_blocks
    from multi_camera_3d_pose_estimation_tpu_torch.io.frames import stage_blocks

    pipe = _tiny_pipeline("cuda")
    blocks = _host_blocks(2)
    run_pipeline_on_blocks(pipe, stage_blocks(iter(blocks), card), progress=False)  # warm-up
    torch.cuda.synchronize()
    clear_spans()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_pipeline_on_blocks(pipe, stage_blocks(iter(blocks), card), progress=False)
        torch.cuda.synchronize()
    got = spans()
    clear_spans()
    me = threading.get_ident()
    for name, on_launcher in (("mc3d.stage.slot_wait", False), ("mc3d.stage.fill", False),
                              ("mc3d.stage.input_wait", True), ("mc3d.stage.h2d", True)):
        mine = [s for s in got if s.name == name and s.block in (0, 1)]
        assert sorted(s.block for s in mine) == [0, 1], name
        assert all((s.thread == me) == on_launcher for s in mine), name
    timed = [s for s in got if s.name in STAGES + ("mc3d.stage.h2d",)]
    assert len(timed) == 2 * (len(STAGES) + 1)
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in timed)
    runs = [s for s in got if s.name == "mc3d.pipeline.run"]
    kineto = [k for n, k in _kineto_mc3d(prof) if n == "mc3d.pipeline.run"]
    assert len(runs) == len(kineto) == 2
    worst = max(abs(k - s.start_ns) for k, s in zip(kineto, runs))
    assert worst < 100_000, worst
