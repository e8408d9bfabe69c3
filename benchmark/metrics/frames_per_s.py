"""frames_per_s: the frames of every request completed in the window over
the window's seconds (host clock)."""


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.done else None
