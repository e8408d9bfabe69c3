"""hypotheses_host_ms_per_frame: host time inside the program's
`pose.hypotheses` span (`ops/ransac.py::ransac_essential`: the top-k
sampling, the five-point solver with its `pose.nullspace` QR, or the
8-point solver, and the prescore slot choice) per frame completed in the
window."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or not w.named("pose.hypotheses") or not ctx.frames:
        return None
    return 1e3 * w.total_s("pose.hypotheses") / ctx.frames
