"""FAST-9 + NMS + Harris corner ranking in plain PyTorch (the port's K1
kernel computes the same)."""

from __future__ import annotations

import torch

from .fast import fast_score, nms3x3
from .harris import harris_response

__all__ = ["corner_response_levels", "corner_response_plain"]


def corner_response_plain(images: torch.Tensor, threshold: float = 20.0, with_harris: bool = False):
    """[B, H, W] f32 -> ranked map [B, H, W]: Harris where a FAST-9 corner
    survives strict 3x3 NMS, -inf elsewhere; with_harris=True also returns
    the dense Harris map."""
    score = nms3x3(fast_score(images, threshold))
    harris = harris_response(images)
    ranked = torch.where(score > 0.0, harris, torch.full_like(harris, float("-inf")))
    return (ranked, harris) if with_harris else ranked


def corner_response_levels(levels, threshold: float = 20.0, with_harris=False):
    """`corner_response_plain` on each level: (ranked list, Harris list with
    None where `with_harris` (a bool, or one per level) is False)."""
    levels = list(levels)
    flags = [with_harris] * len(levels) if isinstance(with_harris, bool) else list(with_harris)
    ranked, harris = [], []
    for img, flag in zip(levels, flags, strict=True):
        out = corner_response_plain(img, threshold, with_harris=True)
        ranked.append(out[0])
        harris.append(out[1] if flag else None)
    return ranked, harris
