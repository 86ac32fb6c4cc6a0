"""How long ``ShardedPosePipeline.run`` holds the launching thread: the
mean host duration of the ``mc3d.pipeline.run`` spans that opened inside
the traced stretch (program spans).  Launches alone take a few
milliseconds; a ``run`` that waits on the card (a synchronizing copy)
holds the host until its block's work has run."""

from port_bench.spanread import stretch


def read(ctx):
    st = stretch(ctx)
    if st is None:
        return None
    return sum((r.end_ns - r.start_ns) * 1e-6 for r in st.runs) / len(st.runs)
