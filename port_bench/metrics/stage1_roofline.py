"""HRNet stage 1's share of its roofline: the least time of the Bottleneck
chain for the crops of the traced window's complete blocks
(`bounds.stage1_bound`), over the device time of the kernels below that
those blocks launched.  None where none of them ran."""

KERNELS = ("bottleneck_kernel",)


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.blocks == 0:
        return None
    launches, seconds = trace.kernel_time(KERNELS)
    if launches == 0 or seconds <= 0:
        return None
    crops = trace.blocks * ctx["crops_per_block"]
    return 100.0 * ctx["bounds"].stage1_bound(ctx["cfg"], crops).seconds / seconds
