"""The card's idle share over a traced stretch of frames: the wall time,
from the stretch's first kernel to its last, in which no kernel ran."""


def read(ctx):
    if ctx.kind != "frames" or ctx.trace is None:
        return None
    busy, window = ctx.trace.busy_window_us()
    return 100.0 * (1.0 - busy / window) if window > 0 else None
