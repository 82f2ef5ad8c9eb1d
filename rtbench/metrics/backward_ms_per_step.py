"""Device ms a fit step of the kernels launched under autograd's backward:
the device time of every autograd::engine::evaluate_function range of
the traced steps."""

PREFIX = "autograd::engine::evaluate_function"


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None:
        return None
    us = sum(r[3] for r in ctx.trace.ranges if r[0].startswith(PREFIX))
    return us / 1e3 / ctx.steps_traced if us > 0 else None
