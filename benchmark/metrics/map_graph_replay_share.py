"""map_graph_replay_share: of the fused flagship's map steps on the card
under a request's root span (`map.step`, a region of
`slamtpu_torch/utils/graphs.py`: keyframe matching, triangulation and
insert, re-association and the observation ring), the share that replayed a
captured CUDA graph: the port's counters `map.graph_replays` /
(`map.graph_replays` + `map.graph_captures` + `map.graph_eager`) over the
window, in percent. A port without the counters reads nothing."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or ctx.device.type != "cuda":
        return None
    replays, captures, eager = (w.count(f"map.graph_{k}", roots=program_spans.ROOTS)
                                for k in ("replays", "captures", "eager"))
    if not replays + captures + eager:
        return None
    return 100.0 * replays / (replays + captures + eager)
