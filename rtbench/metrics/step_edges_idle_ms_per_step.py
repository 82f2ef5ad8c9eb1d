"""Card-idle ms a fit step at the step's edges: the idle gaps between the
traced kernels whose midpoint lies within one of the port's other
tpurt::fit.* spans (the table, the Adam update, the loss and gradient-norm
readback, the rebuild check) or its tpurt::refit span, and within no
tpurt::fit.forward or tpurt::fit.backward span.  Without the tpurt::fit.*
spans nothing is read (tpurt::refit alone is older than them)."""

CHUNK = ("tpurt::fit.forward", "tpurt::fit.backward")


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None:
        return None
    fit = [r for r in ctx.trace.ranges if r[0].startswith("tpurt::fit.")]
    if not fit:
        return None
    edges = [(r[1], r[2]) for r in ctx.trace.ranges
             if r[0] == "tpurt::refit" or (r[0].startswith("tpurt::fit.") and r[0] not in CHUNK)]
    chunks = [(r[1], r[2]) for r in ctx.trace.ranges if r[0] in CHUNK]
    us = 0.0
    for s, e in ctx.trace.gaps():
        mid = 0.5 * (s + e)
        if (any(a <= mid <= b for a, b in edges)
                and not any(a <= mid <= b for a, b in chunks)):
            us += e - s
    return us / 1e3 / ctx.steps_traced
