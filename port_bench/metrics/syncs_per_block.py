"""Host waits on the card inside ``ShardedPosePipeline.run``: the
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and synchronous
``cudaMemcpy`` calls that the "host" stretch's trace (where the profiler
records the launching thread's spans) holds inside an
``mc3d.pipeline.run`` event, over the number of those events (program
spans, counted from the profiler's host events).  A pageable
``torch.tensor(..., device=)`` is one such wait."""

import bisect

from port_bench.spanread import RUN

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device:  # no stretch, or nothing ran on a card
        return None
    runs = sorted((s, e) for s, e, name in trace.host if name == RUN)
    if not runs:
        return None
    starts = [s for s, _ in runs]
    n = 0
    for s, e, name in trace.host:
        if name in SYNCS:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= runs[i][1]:
                n += 1
    return n / len(runs)
