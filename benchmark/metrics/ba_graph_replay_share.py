"""ba_graph_replay_share: of the window bundle adjustment's graph-region
calls on the card under a request's root span (`ba.setup`, the window's
problem set-up, and `ba.step`, one Levenberg-Marquardt iteration, regions
of `slamtpu_torch/utils/graphs.py`), the share that replayed a captured
CUDA graph: the port's counters `ba.graph_replays` / (`ba.graph_replays` +
`ba.graph_captures` + `ba.graph_eager`) over the window, in percent. A port
without the counters reads nothing."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or ctx.device.type != "cuda":
        return None
    replays, captures, eager = (w.count(f"ba.graph_{k}", roots=program_spans.ROOTS)
                                for k in ("replays", "captures", "eager"))
    if not replays + captures + eager:
        return None
    return 100.0 * replays / (replays + captures + eager)
