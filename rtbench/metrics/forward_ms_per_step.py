"""Device ms a fit step of every kernel that is neither knear8, nor under
autograd's backward, nor under the refit: the soft forward's glue, with
the table, the loss, Adam's update and the step's norms."""

BACKWARD = "autograd::engine::evaluate_function"


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None or not ctx.trace.kernels:
        return None
    knear = ctx.trace.kernel_us(lambda name: "knear8_kernel" in name)
    other = sum(r[3] for r in ctx.trace.ranges
                if r[0].startswith(BACKWARD) or r[0] == "tpurt::refit")
    return (ctx.trace.total_us - knear - other) / 1e3 / ctx.steps_traced
