"""Card-idle ms a fit step inside the port's tpurt::fit.backward spans
(each chunk's autograd backward to the table and its flat gradient): the
idle gaps between the traced kernels whose midpoint lies within a
backward range's host interval."""

SPAN = "tpurt::fit.backward"


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None:
        return None
    spans = [(r[1], r[2]) for r in ctx.trace.ranges if r[0] == SPAN]
    if not spans:
        return None
    us = sum(e - s for s, e in ctx.trace.gaps()
             if any(a <= 0.5 * (s + e) <= b for a, b in spans))
    return us / 1e3 / ctx.steps_traced
