"""Host ms from entering Renderer.render_rays until it returns, before the
frame's sync, averaged over every frame of the window."""


def read(ctx):
    if ctx.kind != "frames" or not ctx.dispatch_ms:
        return None
    return sum(ctx.dispatch_ms) / len(ctx.dispatch_ms)
