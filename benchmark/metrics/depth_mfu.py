"""depth_mfu: the share, in percent, of one H100 SXM's dense bfloat16 peak
(989.4 TFLOP/s) that MonoDepth2 reaches over the window: the frames through
the network (the port's `depth.frames` counter, padding included) x the
network's operations a frame at the configuration's size
(benchmark/inputs/depth_counts.py: 2 x the multiply-adds of every
convolution) over the window's seconds."""

from benchmark import program_spans
from benchmark.inputs import depth_counts

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    frames = w.count("depth.frames") if w is not None else 0
    if not frames:
        return None
    model = ctx.config["model"]
    flop = frames * depth_counts.flop_per_frame(model["height"], model["width"])
    return 100.0 * flop / ctx.window_s / depth_counts.BF16_FLOP_PER_S
