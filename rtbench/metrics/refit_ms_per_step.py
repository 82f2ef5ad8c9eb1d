"""Device ms a fit step of the kernels launched under the port's
tpurt::refit span (the tree refit to the step's vertices)."""


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None:
        return None
    us = sum(r[3] for r in ctx.trace.ranges if r[0] == "tpurt::refit")
    return us / 1e3 / ctx.steps_traced if us > 0 else None
