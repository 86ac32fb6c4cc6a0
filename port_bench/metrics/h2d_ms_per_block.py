"""Host-to-device time of one block's frames: the mean over the window's
blocks of the copy stream's CUDA events around each block's copy, which
``io.stage_blocks(copy_events=...)`` records (a program span)."""


def read(ctx):
    ms = ctx["h2d_ms"]
    return sum(ms) / len(ms) if ms else None
