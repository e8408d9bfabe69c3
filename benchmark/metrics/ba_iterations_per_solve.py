"""ba_iterations_per_solve: Levenberg-Marquardt iterations per bundle
adjustment solve in the window (the port's `ba.lm_iterations` over its
`ba.solves`, both counted by `mapping/bundle_adjustment.py::ba_solve` from
the iteration count it holds on the host)."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None:
        return None
    solves = w.count("ba.solves")
    return w.count("ba.lm_iterations") / solves if solves else None
