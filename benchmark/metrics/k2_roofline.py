"""k2_roofline: the share, in percent, of the H100 SXM roofline that kernel
K2 (`csrc/extract_patches.cu`, `patch_kernel`) reaches over the traced
window: the bytes its launches need (the distinct pixels their windows
cover, read once, and every window written) over HBM bandwidth, over
their device time in the trace."""

from benchmark.inputs import kernel_counts as kc

KERNEL = "patch_kernel"


def _keep(levels, starts, radius):
    return [None if x is None else tuple(x.shape) for x in levels], list(starts), int(radius)


SPANS = {"k2": ("slamtpu_torch.feature.detector:extract_patches_levels", _keep)}


def read(ctx):
    if ctx.trace is None or not ctx.spans.count("k2"):
        return None
    mask = ctx.trace.select(kind="kernel", contains=KERNEL)
    device_s = float((ctx.trace.end - ctx.trace.start)[mask].sum()) / 1e9
    if device_s <= 0:
        return None
    n_bytes = 0
    for _, _, (shapes, starts, radius) in ctx.spans.spans["k2"]:
        size = 2 * radius + 1
        n_bytes += kc.k2_write_bytes(starts[0].shape[0], sum(st.shape[1] for st in starts), size)
        n_bytes += sum(kc.k2_read_bytes(shape, st, size) for shape, st in zip(shapes, starts) if shape is not None)
    return 100.0 * kc.bound_s(n_bytes) / device_s
