"""The card's idle share over traced fit steps: the wall time, from the
steps' first kernel to their last, in which no kernel ran."""


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None:
        return None
    busy, window = ctx.trace.busy_window_us()
    return 100.0 * (1.0 - busy / window) if window > 0 else None
