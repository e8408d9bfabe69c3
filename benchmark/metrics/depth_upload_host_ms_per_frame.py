"""depth_upload_host_ms_per_frame: host time inside the program's
`depth.upload` span (`depth/monodepth2.py`: the frames, host uint8, to the
device) per frame completed in the window."""

from benchmark import program_spans

program_spans.begin()


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or not w.named("depth.upload") or not ctx.frames:
        return None
    return 1e3 * w.total_s("depth.upload") / ctx.frames
