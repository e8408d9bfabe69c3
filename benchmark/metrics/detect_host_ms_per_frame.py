"""detect_host_ms_per_frame: host time inside the feature layer's entry
(`pipeline.vo._detect`: pyramid, blur, K1, top-k, K2, orientation, BRIEF)
per frame completed in the window. The flagship's frame 0 is detected
outside it."""

SPANS = {"detect": ("slamtpu_torch.pipeline.vo:_detect", None)}


def read(ctx):
    if not ctx.spans.count("detect") or not ctx.frames:
        return None
    return 1e3 * ctx.spans.total_s("detect") / ctx.frames
