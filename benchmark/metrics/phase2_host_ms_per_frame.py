"""phase2_host_ms_per_frame: host time inside the fused flagship's mapping
layer (`pipeline.point_cloud._fused_phase2_chunk`: keyframe matching,
triangulation, map insert, re-association, window BA, prune) per frame
completed in the window."""

SPANS = {"phase2": ("slamtpu_torch.pipeline.point_cloud:_fused_phase2_chunk", None)}


def read(ctx):
    if not ctx.spans.count("phase2") or not ctx.frames:
        return None
    return 1e3 * ctx.spans.total_s("phase2") / ctx.frames
