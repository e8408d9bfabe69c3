"""The port's own spans and counters (`slamtpu_torch.utils.metrics`: `span`,
`count`, `records`) for the per-layer metrics that read them.

Only those metrics' readers import this module, so it loads in traced runs
only, after the warm request and before the window; importing it, and
loading each such reader, turns the port's tracer on. The first reader to
read takes the window's records once a run, turns the tracer off again
(the check that follows runs untraced) and adds the program's spans to
the run's `spans.Recorder` under their own dotted names, so that the
idle-gap breakdown can give a gap to the innermost program span. No
program span shares a name with a span of the benchmark's own, and no
existing reader reads a dotted name, so no existing metric reads
otherwise. Against a port without the tracer every function here returns
None and the readers report nothing.
"""

from __future__ import annotations

import importlib

ROOTS = ("vo.run", "vo.run_batched", "flagship.run")  # the program's request spans


def _tracer():
    """The port's tracer module, or None where the port has none."""
    try:
        mod = importlib.import_module("slamtpu_torch.utils.metrics")
    except ImportError:
        return None
    return mod if all(hasattr(mod, n) for n in ("enable", "disable", "records", "span")) else None


def begin() -> None:
    """Turn the port's tracer on and drop whatever it held."""
    mod = _tracer()
    if mod is not None:
        mod.enable()
        mod.records()


class Window:
    """The program's spans that lie inside one window, and the counts made
    under them."""

    def __init__(self, spans, counts, t_start: int, t_end: int):
        self.spans = [s for s in spans if s.start_ns >= t_start and s.end_ns <= t_end]
        self.by_id = {s.id: s for s in self.spans}
        self.counts = {key: n for key, n in counts.items() if key[1] in self.by_id}

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def total_s(self, name: str) -> float:
        return sum(s.end_ns - s.start_ns for s in self.named(name)) / 1e9

    def ancestors(self, s):
        while s.parent is not None and s.parent in self.by_id:
            s = self.by_id[s.parent]
            yield s

    def root(self, span_id):
        s = self.by_id[span_id]
        return [s, *self.ancestors(s)][-1]

    def count(self, name: str, roots=None) -> int:
        """Counter `name` summed over the window (only under root spans
        named in `roots`, when given)."""
        return sum(n for (key, sid), n in self.counts.items()
                   if key == name and (roots is None or self.root(sid).name in roots))


def merge(ctx, window: Window) -> None:
    """Add the window's program spans to ctx.spans under their own names;
    a name the recorder already holds is left as it is."""
    if ctx.spans is None:
        return
    taken = set(ctx.spans.spans)
    for s in window.spans:
        if s.name not in taken:
            ctx.spans.spans.setdefault(s.name, []).append((s.start_ns, s.end_ns, None))


def window(ctx):
    """The program's Window of ctx's run (read and merged once a run), or
    None against a port without the tracer."""
    if not hasattr(ctx, "program_window"):
        mod = _tracer()
        if mod is None:
            ctx.program_window = None
        else:
            mod.disable()
            rec = mod.records()
            ctx.program_window = Window(rec.spans, rec.counts, ctx.t_start, ctx.t_end)
            merge(ctx, ctx.program_window)
    return ctx.program_window


begin()
