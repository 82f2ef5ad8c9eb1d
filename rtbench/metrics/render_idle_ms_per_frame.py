"""Card-idle ms a frame inside the port's tpurt::render_rays spans: the
idle gaps between the traced kernels whose midpoint lies within a
render_rays range's host interval (the profiler's one clock), averaged
over the traced frames."""

SPAN = "tpurt::render_rays"


def read(ctx):
    if ctx.kind != "frames" or ctx.trace is None:
        return None
    spans = [(r[1], r[2]) for r in ctx.trace.ranges if r[0] == SPAN]
    if not spans:
        return None
    us = sum(e - s for s, e in ctx.trace.gaps()
             if any(a <= 0.5 * (s + e) <= b for a, b in spans))
    return us / 1e3 / ctx.frames_traced
