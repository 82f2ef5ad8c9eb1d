"""Device ms a frame of every kernel other than the hard walks (closest8,
occluded8): the render's glue, from the traced stretch."""

WALKS = ("closest8_kernel", "occluded8_kernel")


def read(ctx):
    if ctx.kind != "frames" or ctx.trace is None or not ctx.trace.kernels:
        return None
    glue_us = ctx.trace.kernel_us(lambda name: not any(w in name for w in WALKS))
    return glue_us / 1e3 / ctx.frames_traced
