"""dav2_attention_roofline: attention's share, in percent, of its roofline
in the traced window: its least time, the q k^T and p v operations of every
frame through the encoder (the port's `depth.frames` and `depth.tokens`
counters; benchmark/inputs/dav2_counts.py) at the H100's dense bfloat16
peak of 989.4 TFLOP/s (its bytes, q, k, v and the output once, take an
eighth of that at 3.35 TB/s, so the operations bound it), over the device time of the attention kernels
(F.scaled_dot_product_attention's; the classes of dav2_counts.py)."""

import numpy as np

from benchmark import program_spans
from benchmark.inputs import dav2_counts

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    frames = w.count("depth.frames") if w is not None else 0
    tokens = w.count("depth.tokens") if w is not None else 0
    if ctx.trace is None or not frames or not tokens or tokens % frames:
        return None
    attention = {name: dav2_counts.is_attention(name) for name in set(ctx.trace.names)}
    mask = ctx.trace.select(kind="kernel") & np.array([attention[n] for n in ctx.trace.names], bool)
    device_s = float((ctx.trace.end - ctx.trace.start)[mask].sum()) / 1e9
    if device_s <= 0:
        return None
    flop = frames * dav2_counts.attention_flop_per_frame(ctx.config["model"], tokens // frames)
    return 100.0 * flop / dav2_counts.BF16_FLOP_PER_S / device_s
