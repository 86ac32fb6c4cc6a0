"""Device time of the 2D model's forward (`models.topdown._heatmaps`, with
the flip-TTA pass where it runs) per block: the mean device time of the
``mc3d.pipeline.model`` spans inside the ``mc3d.pipeline.run`` spans
that opened inside the traced stretch.  A span's device time is the time
between its two CUDA events on the one compute stream: from the stage's
first work to its last, idle gaps inside the stage included (program
spans)."""

from port_bench.spanread import stretch

SPAN = "mc3d.pipeline.model"


def read(ctx):
    st = stretch(ctx)
    if st is None:
        return None
    ms = st.stage_ms(SPAN)
    return sum(ms) / len(ms) if ms else None
