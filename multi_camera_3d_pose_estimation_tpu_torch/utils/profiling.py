"""Tracing / profiling utilities (counterpart of the JAX package's
``utils/profiling.py``).

The reference's instrumentation is ad hoc: ``time.time()`` deltas around
the detector/pose forwards (mmpose_pose_estimation.py:235-256) and per-cost
cumulative wall-time percentages inside the SGD loop
(``print_compute_times``, pose_refinement.py:998-1067).  Here:

- `StepTimer`: wall time per named stage with a context manager, the card
  synchronized at the end of each stage; `report()` prints the
  reference-style percentage breakdown in the JAX package's format;
- `trace`: a ``torch.profiler`` window over CPU and CUDA activity that
  writes a Chrome/TensorBoard trace (``*.pt.trace.json``) under
  ``log_dir`` (the TensorBoard package is not needed);
- `profile_refinement_costs`: each refinement cost timed alone on one
  window of a `refine.PoseRefiner`, the reference's per-cost breakdown for
  tuning the λ weights (the production loop stays as it is);
- `span` / `spans` / `clear_spans`: the program's own spans at its layer
  boundaries (the staging ring, the estimate loop's dispatch and drain,
  the block pipeline's stages), recorded in memory only while a torch
  profiler runs in the process (`trace`, ``profile_block``, the
  benchmark's traced stretches, or an operator's own
  ``torch.profiler.profile``); with none running a span costs one flag
  read.  There is no other switch.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["StepTimer", "trace", "profile_refinement_costs", "Span", "span", "spans",
           "clear_spans", "tracing"]


def _sync_cuda() -> None:
    """Wait for the card's queued work, where CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulate wall time per named stage.  ``synchronize=True`` waits for
    the card's queued work at the end of each stage, so that a stage's time
    includes the work it launched (``block_jax`` is the JAX package's name
    for it, and wins when given)."""

    def __init__(self, synchronize: bool = True, block_jax: bool | None = None):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.synchronize = bool(synchronize if block_jax is None else block_jax)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.synchronize:
                _sync_cuda()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name}: {t:.3f}s ({100 * t / total:.1f}%), "
                f"{self.counts[name]} calls, {t / self.counts[name] * 1e3:.2f} ms/call"
            )
        out = "\n".join(lines)
        print(out)
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile CPU (and, where available, CUDA) activity in the block and
    write its Chrome trace to ``<log_dir>/<host>.<pid>.<ms>.pt.trace.json``
    (open it in TensorBoard's profile tab, Perfetto or chrome://tracing).
    Yields the ``torch.profiler.profile`` (its ``events()`` and
    ``key_averages()``); the trace's path is its ``trace_path`` once the
    block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync_cuda()
        prof.stop()
        path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                     f"{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


# Spans.  `torch.autograd.profiler._is_profiler_enabled` is one
# process-wide flag, True on every thread while any torch profiler runs
# (whatever its activities); read through the module at every call.
_autograd_profiler = torch.autograd.profiler
# Spans kept: the newest, a few blocks' worth of seconds of tracing.
SPAN_CAPACITY = 4096
# A span's host event in the profiler's trace (kineto records it only on
# the thread that started the profiler, and there it lands in the Chrome
# trace beside the device events).  The C++ context manager enters in ~1 us
# holding the GIL; ``torch.profiler.record_function`` enters through an
# operator call that releases the GIL, and on an H100 host, with the
# staging thread waiting for the GIL, its event then started up to 0.19 ms
# after a clock read taken just before it.
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class Span(NamedTuple):
    """One finished span.  ``parent`` is the ``id`` of the span that
    enclosed it on the same thread (None at the top); ``block`` is the
    block id given to it or inherited from that parent.  ``start_ns`` and
    ``end_ns`` are host times on ``time.time_ns()``'s clock, the clock of
    the profiler's own host events.  ``device_ms`` is the time on the
    stream between the span's two timing events (None without events, or
    while its work has not run)."""

    id: int
    name: str
    block: int | None
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int
    device_ms: float | None


class _NoSpan:
    """The span while no profiler runs: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("rec", "name", "block", "device", "id", "parent", "thread", "start", "events",
                 "annotation")

    def __init__(self, rec, name, block, device):
        self.rec, self.name, self.block, self.device = rec, name, block, device

    def __enter__(self):
        stack = self.rec.stack()
        outer = stack[-1] if stack else None
        if self.block is None and outer is not None:
            self.block = outer.block
        self.parent = outer.id if outer is not None else None
        self.id = next(self.rec.ids)
        self.thread = threading.get_ident()
        stack.append(self)
        if self.device is True:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        else:
            self.events = self.device or None  # the caller's pair, or none
        self.annotation = _annotation(self.name)
        self.annotation.__enter__()
        # Kineto's start_ns() of the annotation read 0.1-0.2 us before this
        # time_ns() on the CPU: time.time_ns() is the clock of the
        # profiler's host events.
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end = time.time_ns()
        if self.device is True:
            self.events[1].record()
        self.rec.stack().pop()
        self.rec.add((self.id, self.name, self.block, self.parent, self.thread, self.start, end,
                      self.events))
        return False


class _SpanRecorder:
    """The bounded ring of finished spans and each thread's open spans."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.ids = itertools.count()
        self._done: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, record: tuple) -> None:
        with self._lock:
            self._done.append(record)

    def snapshot(self) -> list:
        with self._lock:
            records = list(self._done)
        return [Span(*r[:7], _elapsed_ms(r[7])) for r in sorted(records, key=lambda r: r[5])]

    def clear(self) -> None:
        with self._lock:
            self._done.clear()


def _elapsed_ms(events) -> float | None:
    if events is None:
        return None
    start, end = events
    if not end.query():
        return None
    return start.elapsed_time(end)


_RECORDER = _SpanRecorder()


def tracing() -> bool:
    """Whether a torch profiler runs in this process (spans record)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, block: int | None = None, device=False):
    """A context manager marking one stage of the program.

    While no torch profiler runs it is one shared object that does
    nothing, returned after a single flag read: no lock, no allocation, no
    CUDA call.  While one runs, the span is kept in memory (`spans`) with
    its block id (``block``, else its enclosing span's on this thread),
    parent, thread and host start and end, and is entered as a profiler
    event of the same name (``record_function``'s, in its fast form).
    ``device=True`` also records a pair of timing CUDA events on the
    current stream around the span's work (pass it only where that work is
    on the card); ``device=(start, end)`` keeps the caller's own pair of
    timing events, which the caller records on a stream of its choice
    inside the span.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _OpenSpan(_RECORDER, name, block, device)


def spans() -> list:
    """The finished spans still in the ring (the newest `SPAN_CAPACITY`), by
    host start; each span's device time is read from its events now, so
    synchronize first."""
    return _RECORDER.snapshot()


def clear_spans() -> None:
    """Empty the ring of finished spans."""
    _RECORDER.clear()


def profile_refinement_costs(refiner, window: int | None = None, n_iters: int = 20):
    """Time each refinement cost alone on the first ``window`` frames of
    ``refiner`` (a `refine.PoseRefiner`; all of them by default), in its
    dtype on its device, each call synchronized before the clock is read.

    Returns {cost_name: seconds per evaluation}: ``likelihood_cost``,
    ``smoothness_cost`` and, when the refiner has body lengths,
    ``body_length_cost``; prints a reference-style percentage line
    (pose_refinement.py:1060-1067).
    """
    from ..refine.costs import body_length_cost, likelihood_cost, nan_mean, precompute_cov_inverse
    from ..utils.skeleton import body_length_edges

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or refiner.dtype, device=refiner.device)

    g = t(refiner.gaussians)
    B = window or g.shape[0]
    g = g[:B]
    means = g[..., :2]
    cov_inv = precompute_cov_inverse(g)
    traj = t(refiner.initial_trajectory[:B])
    Ks, Rs, Ts, ds = (t(np.stack([refiner.cam_params[i][k] for i in refiner.camera_ids]))
                      for k in range(4))

    fns = {
        "likelihood_cost": lambda x: likelihood_cost(x, means, cov_inv, Ks, Rs, Ts, ds),
        "smoothness_cost": lambda x: nan_mean(
            torch.sum((x[2:] - 2 * x[1:-1] + x[:-2]) ** 2, dim=(-2, -1))),
    }
    if refiner.body_lengths:
        e_s, e_e, e_t = body_length_edges(refiner.body_lengths)
        e_s, e_e = t(e_s, torch.long), t(e_e, torch.long)
        e_t = t(e_t)
        fns["body_length_cost"] = lambda x: body_length_cost(x, e_s, e_e, e_t)

    times = {}
    with torch.no_grad():
        for name, fn in fns.items():
            fn(traj)  # warm-up
            _sync_cuda()
            t0 = time.perf_counter()
            for _ in range(n_iters):
                fn(traj)
                _sync_cuda()
            times[name] = (time.perf_counter() - t0) / n_iters
    total = sum(times.values())
    print(
        "Proportional cost times: "
        + ", ".join(f"{k}: {100 * v / total:.2f}%" for k, v in times.items())
    )
    return times
