"""pose_host_ms_per_frame: host time inside the odometry layer's entry
(`pipeline.vo._pair_poses`: matching, per-octave sigma, five-point RANSAC
and its polish) per frame completed in the window."""

SPANS = {"pose": ("slamtpu_torch.pipeline.vo:_pair_poses", None)}


def read(ctx):
    if not ctx.spans.count("pose") or not ctx.frames:
        return None
    return 1e3 * ctx.spans.total_s("pose") / ctx.frames
