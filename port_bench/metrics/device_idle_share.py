"""The share of the traced window in which nothing ran on the card: 100 ·
(1 − the union of every device interval, kernels and copies on every
stream, over the window), from the stretch that records the card's
activity alone."""


def read(ctx):
    trace = ctx["device_trace"]
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - min(trace.busy_s, trace.window_s) / trace.window_s)
