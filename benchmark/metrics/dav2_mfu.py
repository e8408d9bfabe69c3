"""dav2_mfu: the share, in percent, of one H100 SXM's dense bfloat16 peak
(989.4 TFLOP/s) that Depth Anything V2 reaches over the window: the frames
through the network (the port's `depth.frames` counter) and the ViT's
tokens (its `depth.tokens` counter, class tokens included) x the network's
operations (benchmark/inputs/dav2_counts.py: 2 x the multiply-adds of
every linear layer, convolution and transposed convolution, plus
attention's q k^T and p v), over the window's seconds. The head's count
takes the patch grid of the configuration's frames; a window whose tokens
a frame are not that grid's reports nothing."""

from benchmark import program_spans
from benchmark.inputs import dav2_counts

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    frames = w.count("depth.frames") if w is not None else 0
    tokens = w.count("depth.tokens") if w is not None else 0
    if not frames or not tokens:
        return None
    model = ctx.config["model"]
    gh, gw = dav2_counts.grid(ctx.config["image"]["height"], ctx.config["image"]["width"], model)
    if tokens != frames * (1 + gh * gw):
        return None
    flop = frames * dav2_counts.flop_per_frame(model, gh, gw)
    return 100.0 * flop / ctx.window_s / dav2_counts.BF16_FLOP_PER_S
