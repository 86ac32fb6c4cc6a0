"""What the profiler's trace of the card says, reduced once for every
per-layer reader.

The traced window is a stretch of the measured window, profiled with
``torch.profiler`` (CPU and CUDA activity).  The benchmark marks each
call into the block pipeline with a ``port_bench.block`` span; every
device event is tied to the span its launch came from by CUPTI's
correlation id.  From the raw kineto events:

- ``busy_s``: the union of the device intervals (kernels, copies and sets,
  on every stream), the window's busy time;
- per kernel name: launches and device seconds, of the whole window and of
  the launches made inside complete ``port_bench.block`` spans;
- ``blocks``: the complete spans, the blocks whose every launch the trace
  holds;
- the largest device operations and the longest idle gaps of the device,
  each gap named by the innermost host event running as it opened.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

__all__ = ["SPAN", "DeviceTrace"]

SPAN = "port_bench.block"
_COPY = ("Memcpy", "Memset")


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def _kind(ev) -> str:
    kind = ev.activity_type() if hasattr(ev, "activity_type") else ""
    return str(kind).lower()


class DeviceTrace:
    def __init__(self, prof, window_s: float):
        self.window_s = float(window_s)
        events = prof.profiler.kineto_results.events()
        host, device = [], []
        for ev in events:
            if ev.name().startswith("port_bench.") and _is_device(ev):
                continue  # the span's mirror on the device timeline
            if _is_device(ev):
                if "annotation" in _kind(ev):
                    continue
                device.append(ev)
            else:
                host.append(ev)
        self.device = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.correlation_id(), ev.linked_correlation_id()) for ev in device]
        self.host = sorted(((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                            for ev in host), key=lambda e: e[0])
        spans = sorted((s, e) for s, e, name in self.host if name == SPAN)
        self.blocks = len(spans)
        launch_at = {}  # CUPTI correlation id -> host time of the launch call
        for ev in host:
            kind = _kind(ev)
            runtime = ("runtime" in kind or "driver" in kind) if kind else \
                ev.name().startswith(("cuda", "cu"))
            if runtime and ev.correlation_id():
                launch_at.setdefault(ev.correlation_id(), ev.start_ns())
        self.total = defaultdict(lambda: [0, 0.0])  # name -> [launches, device s]
        self.in_blocks = defaultdict(lambda: [0, 0.0])
        self.tied = 0
        starts = [s for s, _ in spans]
        for name, s, e, cid, linked in self.device:
            row = self.total[name]
            row[0] += 1
            row[1] += (e - s) * 1e-9
            at = launch_at.get(cid) or launch_at.get(linked)
            if at is None:
                continue
            self.tied += 1
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and spans[i][0] <= at <= spans[i][1]:
                inb = self.in_blocks[name]
                inb[0] += 1
                inb[1] += (e - s) * 1e-9
        self.intervals = self._union()
        self.busy_s = sum(e - s for s, e in self.intervals) * 1e-9

    def _union(self):
        out = []
        for _, s, e, _, _ in sorted(self.device, key=lambda d: d[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @staticmethod
    def is_kernel(name: str) -> bool:
        return not name.startswith(_COPY)

    def launches_in_blocks(self) -> int:
        """Kernel launches made inside the complete block spans."""
        return sum(n for name, (n, _) in self.in_blocks.items() if self.is_kernel(name))

    def kernel_time(self, patterns) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose names contain any
        of ``patterns``, launched inside the complete block spans."""
        n = t = 0
        for name, (count, secs) in self.in_blocks.items():
            if any(p in name for p in patterns):
                n += count
                t += secs
        return n, t

    def top_ops(self, k: int = 10) -> list:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:160], secs] for name, (_, secs) in rows]

    def idle_gaps(self, k: int = 10) -> list:
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(self.intervals, self.intervals[1:])]
        gaps.sort(reverse=True)
        out = []
        starts = [s for s, _, _ in self.host]
        for length, at in gaps[:k]:
            inner = None
            for s, e, name in self.host[:bisect.bisect_right(starts, at)]:
                if e >= at and (inner is None or s >= inner[0]):
                    inner = (s, name)
            label = inner[1] if inner else "no recorded host event"
            out.append([f"host: {label}"[:160], length * 1e-9])
        return out
