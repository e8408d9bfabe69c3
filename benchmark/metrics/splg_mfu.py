"""splg_mfu: the share, in percent, of one H100 SXM's dense bfloat16 peak
(989.4 TFLOP/s) that SuperPoint + LightGlue reach over the window: the
frames through SuperPoint (the port's `sp.frames` counter) x its
operations at the configuration's image size, plus the pairs through
LightGlue (`lg.pairs`) x its operations at the slots a frame
(`sp.keypoint_slots` / `sp.frames`) (benchmark/inputs/splg_counts.py),
over the window's seconds. A port without the counters reads nothing."""

from benchmark import program_spans
from benchmark.inputs import splg_counts

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None:
        return None
    frames, slots, pairs = (w.count(n) for n in ("sp.frames", "sp.keypoint_slots", "lg.pairs"))
    if not frames or not pairs or slots % frames:
        return None
    image = ctx.config["image"]
    flop = frames * splg_counts.superpoint_flop(image["height"], image["width"]) \
        + pairs * splg_counts.lightglue_flop(slots // frames)
    return 100.0 * flop / ctx.window_s / splg_counts.BF16_FLOP_PER_S
