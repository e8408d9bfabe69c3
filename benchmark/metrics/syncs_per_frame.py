"""syncs_per_frame: synchronizing CUDA calls (the port's `syncs` counter,
each warning of `torch.cuda.set_sync_debug_mode("warn")` under a request's
root span: `vo.run`, `vo.run_batched`, `flagship.run`) per frame completed
in the window. Read on a CUDA device only."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or ctx.device.type != "cuda" or not ctx.frames:
        return None
    if not any(w.named(name) for name in program_spans.ROOTS):
        return None
    return w.count("syncs", roots=program_spans.ROOTS) / ctx.frames
