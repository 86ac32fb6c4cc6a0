"""The SwinBlocks' token products' share of their roofline: the least time
of every block's qkv, proj, fc1 and fc2 with their LayerNorm prologues
for the crops of the traced window's complete blocks
(`bounds.swin_products_bound`), over the device time of the kernels below
that those blocks launched.  None where none of them ran."""

KERNELS = ("swin_gemm_kernel", "swin_gemm_ln_kernel")


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.blocks == 0:
        return None
    launches, seconds = trace.kernel_time(KERNELS)
    if launches == 0 or seconds <= 0:
        return None
    crops = trace.blocks * ctx["crops_per_block"]
    return 100.0 * ctx["bounds"].swin_products_bound(ctx["cfg"], crops) / seconds
