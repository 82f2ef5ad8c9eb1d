"""Device ms a frame under the port's tpurt::area spans (the area lights:
emitter sampling, the area shadow rays, their walk and the contribution),
less the walks: each area range's device time less that of the
tpurt::walk.* ranges inside it.  The same whether or not the profiler
credits the walks' kernels, launched through ctypes, to the range that
was open."""

SPAN = "tpurt::area"
WALK = "tpurt::walk."


def read(ctx):
    if ctx.kind != "frames" or ctx.trace is None:
        return None
    spans = [r for r in ctx.trace.ranges if r[0] == SPAN]
    if not spans:
        return None
    walks = [r for r in ctx.trace.ranges if r[0].startswith(WALK)
             and any(s[1] <= r[1] and r[2] <= s[2] for s in spans)]
    us = sum(r[3] for r in spans) - sum(r[3] for r in walks)
    return us / 1e3 / ctx.frames_traced
