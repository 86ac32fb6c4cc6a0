"""The share of the card's idle time that opens while the launching
thread is inside ``ShardedPosePipeline.run``: of the gaps between the
traced stretch's device intervals (the union over every stream), the
time of those whose innermost open span on the thread that runs the
pipeline, at the gap's opening, is ``mc3d.pipeline.run`` or one of its
stages, over the time of all of them, in % (program spans against the
device trace).  Idle that opens elsewhere (the drain, the wait for
input) is the rest."""

from port_bench.spanread import stretch


def read(ctx):
    st = stretch(ctx)
    if st is None:
        return None
    threads = {r.thread for r in st.runs}
    intervals = st.trace.intervals
    total = inside = 0
    for (_, opened), (closed, _) in zip(intervals, intervals[1:]):
        gap = closed - opened
        if gap <= 0:
            continue
        total += gap
        for thread in threads:
            span = st.innermost(thread, opened)
            if st.in_run(span):
                inside += gap
                break
    return 100.0 * inside / total if total > 0 else None
