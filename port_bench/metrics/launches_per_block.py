"""Kernel launches per block: the kernels launched inside the traced
window's complete calls of ``ShardedPosePipeline.run`` (the benchmark's
``port_bench.block`` spans), over those calls; copies and sets are not
kernels."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.blocks == 0 or trace.launches_in_blocks() == 0:
        return None
    return trace.launches_in_blocks() / trace.blocks
