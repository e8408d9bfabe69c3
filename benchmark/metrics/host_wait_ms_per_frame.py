"""host_wait_ms_per_frame: host time inside the program's `*.read` spans
(each a block that reads device data on the host, so the host waits there
for the device: the final fetches, the flagship's keyframe flags, its
BA-due test and each LM iteration's stop test) per frame completed in the
window; a `.read` span inside another is counted once."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or not ctx.frames:
        return None
    reads = [s for s in w.spans if s.name.endswith(".read")]
    if not reads:
        return None
    outer = [s for s in reads if not any(a.name.endswith(".read") for a in w.ancestors(s))]
    return sum(s.end_ns - s.start_ns for s in outer) / 1e6 / ctx.frames
