"""mapping_self_host_ms_per_frame: host time inside the program's
`map.phase2` span (the fused flagship's keyframe loop) less the part its
`map.window_ba` spans cover, per frame completed in the window: keyframe
matching, triangulation and insert, re-association, the ring, the BA-due
test and the prune."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or not w.named("map.phase2") or not ctx.frames:
        return None
    inside = [s for s in w.named("map.window_ba") if any(a.name == "map.phase2" for a in w.ancestors(s))]
    ba_s = sum(s.end_ns - s.start_ns for s in inside) / 1e9
    return 1e3 * (w.total_s("map.phase2") - ba_s) / ctx.frames
