"""dav2_nonmatmul_ms_per_frame: device time of every kernel in the traced
window that is not a GEMM, a convolution or attention (LayerNorm, GELU,
residual adds, interpolation, ReLU, casts, layout; the classes of
benchmark/inputs/dav2_counts.py) per frame through the network (the port's
`depth.frames` counter). The driver's own thumbnail kernel is left out."""

import numpy as np

from benchmark import program_spans
from benchmark.inputs import dav2_counts

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    frames = w.count("depth.frames") if w is not None else 0
    if ctx.trace is None or not frames:
        return None
    other = {name: dav2_counts.is_nonmatmul(name) for name in set(ctx.trace.names)}
    mask = ctx.trace.select(kind="kernel") & np.array([other[n] for n in ctx.trace.names], bool)
    return float((ctx.trace.end - ctx.trace.start)[mask].sum()) / 1e6 / frames
