"""The program's own spans (``utils.profiling.spans`` of the port) as the
per-layer readers see them.

The port records a span at each layer boundary while a torch profiler
runs (the CUDA-only "device" stretch's too): ``mc3d.stage.*`` (the
staging ring), ``mc3d.estimate.*`` (the estimate loop's dispatch and
drain) and ``mc3d.pipeline.*`` (``run`` and its stages), host times on
the clock of the profiler's events, stage device times from CUDA event
pairs.  A reader counts the blocks whose ``mc3d.pipeline.run`` opened
inside the traced "device" stretch (from its first to its last device
event): the "host" stretch slows the host several-fold.  A program
without spans (an older checkout) gives the readers nothing to read, and
they return None.
"""

from __future__ import annotations

import bisect

__all__ = ["RUN", "program_spans", "Stretch", "stretch"]

RUN = "mc3d.pipeline.run"


def program_spans() -> list:
    """The port's finished spans, or [] where the port records none."""
    try:
        from multi_camera_3d_pose_estimation_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


class Stretch:
    """The spans of the "device" stretch: ``runs``, the
    ``mc3d.pipeline.run`` spans that opened inside it, and every span, to
    find their stages, waits and threads in."""

    def __init__(self, all_spans: list, trace, lo: int, hi: int):
        self.trace = trace
        self.spans = sorted(all_spans, key=lambda s: s.start_ns)
        self.by_id = {s.id: s for s in self.spans}
        self.runs = [s for s in self.spans if s.name == RUN and lo <= s.start_ns <= hi]
        self.run_ids = {s.id for s in self.runs}
        self._threads: dict = {}

    def _ancestors(self, s):
        while s is not None:
            yield s
            s = self.by_id.get(s.parent)

    def counted(self, s) -> bool:
        """Whether ``s`` is, or lies in, a run that opened in the stretch."""
        return any(a.id in self.run_ids for a in self._ancestors(s))

    def in_run(self, s) -> bool:
        """Whether ``s`` is an ``mc3d.pipeline.run`` span or lies in one."""
        return any(a.name == RUN for a in self._ancestors(s))

    def stage_ms(self, name: str) -> list:
        """Device milliseconds of each ``name`` span inside a counted run."""
        return [s.device_ms for s in self.spans
                if s.name == name and s.device_ms is not None and self.counted(s)]

    def innermost(self, thread: int, at: int):
        """The innermost span open on ``thread`` at host time ``at``: the
        spans of one thread nest, so it is the latest-opened one that has
        not closed by then."""
        if thread not in self._threads:
            mine = [s for s in self.spans if s.thread == thread]
            self._threads[thread] = ([s.start_ns for s in mine], mine)
        starts, mine = self._threads[thread]
        for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            if mine[i].end_ns > at:
                return mine[i]
        return None


def stretch(ctx) -> Stretch | None:
    """The "device" stretch's spans; None without a traced stretch, without
    spans, or where no run opened inside it."""
    trace = ctx.get("device_trace")
    if trace is None or not trace.device:
        return None
    all_spans = program_spans()
    if not all_spans:
        return None
    st = Stretch(all_spans, trace, min(d[1] for d in trace.device),
                 max(d[2] for d in trace.device))
    return st if st.runs else None
