"""Device ms a fit step of the knear8 kernel (the soft render's layer and
occluder walks), from the traced steps."""


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(lambda name: "knear8_kernel" in name)
    return us / 1e3 / ctx.steps_traced if us > 0 else None
