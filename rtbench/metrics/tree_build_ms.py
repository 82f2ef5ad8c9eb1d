"""One warm make_tracer of the cell's scene (the LBVH build and, for wide8,
its collapse and pack), synchronised before and after, on the host clock."""


def read(ctx):
    if ctx.kind != "frames" or ctx.tree_build_ms is None:
        return None
    return ctx.tree_build_ms
