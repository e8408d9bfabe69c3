"""k1_roofline: the share, in percent, of the H100 SXM roofline that kernel
K1 (`csrc/corner_response.cu`, `corner_kernel`) reaches over the traced
window: the least time its launches need (benchmark/inputs/kernel_counts.py,
from each launch's level shapes and the compass candidates of the frames
it saw) over their device time in the trace."""

from benchmark.inputs import kernel_counts as kc

KERNEL = "corner_kernel"


def _keep(levels, threshold=20.0, with_harris=False):
    levels = list(levels)
    flags = [with_harris] * len(levels) if isinstance(with_harris, bool) else list(with_harris)
    return [tuple(x.shape) for x in levels], [bool(f) for f in flags]


SPANS = {"k1": ("slamtpu_torch.feature.detector:corner_response_levels", _keep)}


def read(ctx):
    if ctx.trace is None or not ctx.spans.count("k1"):
        return None
    mask = ctx.trace.select(kind="kernel", contains=KERNEL)
    device_s = float((ctx.trace.end - ctx.trace.start)[mask].sum()) / 1e9
    if device_s <= 0:
        return None
    calls = [kept for _, _, kept in ctx.spans.spans["k1"]]
    n_bytes = sum(kc.k1_bytes(shapes, flags) for shapes, flags in calls)
    pixels = sum(kc.k1_pixels(shapes) for shapes, _ in calls)
    orb = ctx.config["vo"]["orb"] if "vo" in ctx.config else ctx.config["point_cloud"]["vo"]["orb"]
    per_frame = kc.compass_candidates(ctx.scene.frames, orb["n_levels"], orb["scale_factor"], orb["fast_threshold"],
                                      ctx.device)
    candidates = sum(int(per_frame[r["detected"]].sum()) for r in ctx.done)
    return 100.0 * kc.bound_s(n_bytes, kc.k1_ops(pixels, candidates)) / device_s
