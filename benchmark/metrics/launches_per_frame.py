"""launches_per_frame: kernels the device ran in the traced window (the
profiler's CUDA kernel events) per frame completed in it."""


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    return int(ctx.trace.select(kind="kernel").sum()) / ctx.frames
