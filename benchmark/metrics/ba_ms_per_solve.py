"""ba_ms_per_solve: wall time of the fused flagship's window bundle
adjustment (`pipeline.point_cloud._fused_window_ba`) per solve. Its LM loop
reads a scalar every iteration, so the wall time is the solve's time."""

SPANS = {"window_ba": ("slamtpu_torch.pipeline.point_cloud:_fused_window_ba", None)}


def read(ctx):
    n = ctx.spans.count("window_ba")
    return 1e3 * ctx.spans.total_s("window_ba") / n if n else None
