"""lg_attention_roofline: LightGlue attention's share, in percent, of its
roofline in the traced window: its least time, the least q k^T and p v
operations of every pair through LightGlue (the cross block's similarity
counted once, as upstream's non-flash form computes it, where the port's
flash attention computes it for each direction; the port's `lg.pairs` counter,
at `sp.keypoint_slots` / `sp.frames` slots; benchmark/inputs/splg_counts.py)
at the H100's dense bfloat16 peak of 989.4 TFLOP/s (its bytes, q, k, v and
the output once each, 151 MB a pair at 2048 slots, take under a third of
that at 3.35 TB/s, so the operations bound it), over the device time of the attention kernels
(F.scaled_dot_product_attention's, by name in splg_counts.py)."""

import numpy as np

from benchmark import program_spans
from benchmark.inputs import splg_counts

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or ctx.trace is None:
        return None
    frames, slots, pairs = (w.count(n) for n in ("sp.frames", "sp.keypoint_slots", "lg.pairs"))
    if not frames or not pairs or slots % frames:
        return None
    attention = {name: splg_counts.is_attention(name) for name in set(ctx.trace.names)}
    mask = ctx.trace.select(kind="kernel") & np.array([attention[n] for n in ctx.trace.names], bool)
    device_s = float((ctx.trace.end - ctx.trace.start)[mask].sum()) / 1e9
    if device_s <= 0:
        return None
    flop = pairs * splg_counts.attention_flop(slots // frames)
    return 100.0 * flop / splg_counts.BF16_FLOP_PER_S / device_s
