"""device_idle: the share of the traced window, in percent, in which no
operation (kernel, copy or set) ran on the device."""


def read(ctx):
    if ctx.trace is None or not len(ctx.trace.names):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / (ctx.t_end - ctx.t_start))
