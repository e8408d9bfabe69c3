"""The least work the two hand-written kernels' launches need, for their
roofline shares: bytes and operations counted from each launch's shapes
and inputs (K1: FAST-9 + NMS + Harris; K2: per-keypoint windows), and the
published peaks of one NVIDIA H100 SXM. A copy of the arithmetic of the
port's chip smoke test; it imports nothing of the port.

K1 reads every pixel once and writes the ranked map, plus the dense Harris
map on the levels whose sub-pixel step needs it: 4 * (2 px + px_harris)
bytes. Its operations: 83 a pixel (compass pre-test 12, Sobel 14, gradient
products 3, the 7x7 box sums of three products 36, Harris 7, NMS 10, select
1) and 179 for each compass candidate (the full FAST score: 16
differences, two 9-arc trees of 64 minima or maxima and 16 of the other,
negation, max, threshold compare). K2 reads the distinct pixels the
windows cover and writes every window.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
K1_OPS_PER_PIXEL = 83
K1_OPS_PER_CANDIDATE = 179


def k1_pixels(shapes) -> int:
    """Pixels of one launch: shapes [(B, H, W)] of its levels."""
    return sum(b * h * w for b, h, w in shapes)


def k1_bytes(shapes, harris_flags) -> int:
    px_harris = sum(b * h * w for (b, h, w), f in zip(shapes, harris_flags, strict=True) if f)
    return 4 * (2 * k1_pixels(shapes) + px_harris)


def k1_ops(pixels: int, candidates: int) -> int:
    return K1_OPS_PER_PIXEL * pixels + K1_OPS_PER_CANDIDATE * candidates


def bound_s(n_bytes: float, ops: float = 0.0) -> float:
    """The least time: the larger of bytes over HBM bandwidth and operations
    over the FP32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def k2_read_bytes(shape, starts: torch.Tensor, size: int) -> int:
    """Bytes of the distinct pixels that one level's windows cover: image
    shape (B, H, W), window starts [B, K, 2] (x0, y0), clamped into the
    image as the kernel clamps them."""
    b, h, w = shape
    covered = torch.zeros((b, h + 1, w + 1), dtype=torch.int32, device=starts.device)
    x0 = starts[..., 0].clamp(0, max(w - size, 0)).long()
    y0 = starts[..., 1].clamp(0, max(h - size, 0)).long()
    bi = torch.arange(b, device=starts.device)[:, None].expand_as(x0)
    one = torch.ones_like(x0, dtype=torch.int32)
    for yy, xx, sgn in ((y0, x0, 1), (y0, x0 + size, -1), (y0 + size, x0, -1), (y0 + size, x0 + size, 1)):
        covered.index_put_((bi, yy, xx), sgn * one, accumulate=True)
    covered = covered.cumsum(1).cumsum(2)
    return 4 * int((covered[:, :h, :w] > 0).sum())


def k2_write_bytes(batch: int, slots: int, size: int) -> int:
    return 4 * batch * slots * size * size


def compass_candidates(frames: np.ndarray, n_levels: int, scale_factor: float, threshold: float, device,
                       block: int = 16) -> np.ndarray:
    """Per frame of `frames` [N, H, W] uint8: the pixels over all pyramid
    levels that pass K1's compass pre-test."""
    from benchmark.reference.plainslam.ops.fast import fast_candidates
    from benchmark.reference.plainslam.ops.pyramid import build_pyramid

    out = np.zeros(len(frames), np.int64)
    for start in range(0, len(frames), block):
        x = torch.as_tensor(frames[start : start + block], device=device).to(torch.float32)
        for level in build_pyramid(x, n_levels, scale_factor):
            out[start : start + len(x)] += fast_candidates(level, threshold).sum(dim=(1, 2)).cpu().numpy()
    return out
