"""How long a block waits between reaching the staging ring and entering
the block pipeline: the mean, over the blocks whose
``mc3d.pipeline.run`` opened inside the traced stretch, of that span's
start less the start of the block's ``mc3d.stage.slot_wait`` (the
producer taking the block from its source, before it waits for a free
slot of the pinned ring), matched by block id (program spans)."""

from port_bench.spanread import stretch

WAIT = "mc3d.stage.slot_wait"


def read(ctx):
    st = stretch(ctx)
    if st is None:
        return None
    waits = {}
    for s in st.spans:
        if s.name == WAIT:
            waits.setdefault(s.block, []).append(s.start_ns)
    ms = []
    for run in st.runs:
        before = [t for t in waits.get(run.block, ()) if t <= run.start_ns]
        if before:
            ms.append((run.start_ns - max(before)) * 1e-6)
    return sum(ms) / len(ms) if ms else None
