"""The whole step's share of the card's bf16 peak: the 2D model's
operations per crop (counted over the reference model's shapes) times the
crops of the frames finished in the window outside its traced stretches,
over that time, over 989 TFLOP/s."""


def read(ctx):
    frames, seconds = ctx["untraced_frames"], ctx["untraced_s"]
    if frames <= 0 or seconds <= 0:
        return None
    crops = frames * ctx["crops_per_block"] / ctx["traffic"]["block_size"]
    return 100.0 * ctx["flops_per_crop"] * crops / seconds / ctx["bounds"].PEAK_BF16_FLOPS
