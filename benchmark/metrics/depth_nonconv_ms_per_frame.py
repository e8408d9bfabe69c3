"""depth_nonconv_ms_per_frame: device time of every kernel in the traced
window that is not a convolution or GEMM (layout transposes, resize,
BatchNorm, padding, pooling, concatenation, elementwise; the classes of
benchmark/inputs/depth_counts.py) per frame through the network (the
port's `depth.frames` counter). The depth driver's own thumbnail kernel is
left out."""

import numpy as np

from benchmark import program_spans
from benchmark.inputs import depth_counts

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    frames = w.count("depth.frames") if w is not None else 0
    if ctx.trace is None or not frames:
        return None
    nonconv = {name: depth_counts.is_nonconv(name) for name in set(ctx.trace.names)}
    mask = ctx.trace.select(kind="kernel") & np.array([nonconv[n] for n in ctx.trace.names], bool)
    return float((ctx.trace.end - ctx.trace.start)[mask].sum()) / 1e6 / frames
