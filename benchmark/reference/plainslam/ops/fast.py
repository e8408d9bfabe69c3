"""FAST-9/16 corner scores and 3x3 non-maximum suppression (counterpart of
slamtpu/ops/fast.py). Together with ops/harris.py this is the plain
version of kernel K1 (ops/corner.py).

Rolled copies of the image give the 16 Bresenham circle neighbours; the
"9 contiguous of 16" test is a min-tree over the circular index axis. Only
subtracts, minima, maxima and compares, so the result is bit-exact with the
JAX package on the same f32 inputs.
"""

from __future__ import annotations

import torch

__all__ = ["CIRCLE_OFFSETS", "fast_candidates", "fast_score", "nms3x3"]

# Bresenham circle of radius 3, clockwise from 12 o'clock ((dy, dx) pairs).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

_ARC = 9  # contiguous run length for FAST-9


def _circular_window_min(d: torch.Tensor, window: int) -> torch.Tensor:
    """out[k] = min(d[k], ..., d[k+window-1]) over axis 0 with wraparound:
    doubling min-tree plus one overlapped combine."""
    min_p = d
    p = 1
    while p * 2 <= window:
        min_p = torch.minimum(min_p, torch.roll(min_p, -p, dims=0))
        p *= 2
    if p < window:
        min_p = torch.minimum(min_p, torch.roll(min_p, -(window - p), dims=0))
    return min_p


def fast_score(images: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """[B, H, W] f32 -> FAST-9/16 score map: 0 where not a corner, else the
    largest threshold at which the segment test still passes. The 3-pixel
    border is always 0."""
    diffs = torch.stack(
        [torch.roll(images, (-dy, -dx), dims=(1, 2)) - images for dy, dx in CIRCLE_OFFSETS],
        dim=0,
    )
    bright = _circular_window_min(diffs, _ARC)
    dark = _circular_window_min(-diffs, _ARC)
    score = torch.maximum(bright.amax(dim=0), dark.amax(dim=0))
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    score = torch.where(score > threshold, score, zero)
    _, h, w = images.shape
    row = torch.arange(h, device=images.device)[None, :, None]
    col = torch.arange(w, device=images.device)[None, None, :]
    interior = (row >= 3) & (row < h - 3) & (col >= 3) & (col < w - 3)
    return torch.where(interior, score, zero)


def fast_candidates(images: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """[B, H, W] f32 -> bool map of the pixels that can have a non-zero
    FAST-9 score (the compass pre-test kernel K1 runs before its trees).

    Every 9-long arc of the circle holds two consecutive compass points
    (circle indices 0, 4, 8, 12), so a pixel whose score is above the
    threshold has two consecutive compass differences d > threshold
    (bright) or -d > threshold (dark). A pixel that fails both tests has a
    score of exactly 0: the map is a superset of `fast_score(...) > 0`.
    """
    d = [torch.roll(images, (-CIRCLE_OFFSETS[k][0], -CIRCLE_OFFSETS[k][1]), dims=(1, 2)) - images
         for k in (0, 4, 8, 12)]
    bright = [x > threshold for x in d]
    dark = [-x > threshold for x in d]
    cand = torch.zeros_like(images, dtype=torch.bool)
    for k in range(4):
        cand |= (bright[k] & bright[(k + 1) % 4]) | (dark[k] & dark[(k + 1) % 4])
    _, h, w = images.shape
    row = torch.arange(h, device=images.device)[None, :, None]
    col = torch.arange(w, device=images.device)[None, None, :]
    return cand & (row >= 3) & (row < h - 3) & (col >= 3) & (col < w - 3)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep strictly-greater-than-all-8-neighbours maxima, zero the rest
    (equal-score plateaus are suppressed on both sides)."""
    neighbor_max = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifted = torch.roll(score, (-dy, -dx), dims=(1, 2))
            neighbor_max = shifted if neighbor_max is None else torch.maximum(neighbor_max, shifted)
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    return torch.where(score > neighbor_max, score, zero)
