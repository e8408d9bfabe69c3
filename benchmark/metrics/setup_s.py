"""setup_s: process start to the first measured request: imports, the
scene, the kernels' build or load and one warm request of the cell's own
shapes."""


def read(ctx):
    return ctx.setup_s
