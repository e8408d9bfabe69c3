"""Per-keypoint window extraction in plain PyTorch (the port's K2 kernel
computes the same): one advanced-indexing gather per level."""

from __future__ import annotations

import torch

__all__ = ["extract_patches_levels"]


def _windows(images: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W] + window starts [B, K, 2] (x0, y0) -> [B, K, size, size],
    each start clamped to [0, W-size] x [0, H-size]."""
    b, h, w = images.shape
    x0 = starts[..., 0].clamp(0, max(w - size, 0)).long()
    y0 = starts[..., 1].clamp(0, max(h - size, 0)).long()
    r = torch.arange(size, device=images.device)
    bi = torch.arange(b, device=images.device)[:, None, None, None]
    return images[bi, (y0[..., None] + r)[..., :, None], (x0[..., None] + r)[..., None, :]]


def extract_patches_levels(levels, starts, radius: int) -> torch.Tensor:
    """Per-level images ([B, H_l, W_l], or None for a level too small for a
    window) + per-level starts ([B, K_l, 2]) -> [B, sum K_l, 2r+1, 2r+1],
    in level order; the slots of a level without an image are zero."""
    size = 2 * radius + 1
    parts = []
    for img, st in zip(levels, starts, strict=True):
        if img is None:
            parts.append(torch.zeros((st.shape[0], st.shape[1], size, size), dtype=torch.float32, device=st.device))
        else:
            parts.append(_windows(img, st, size))
    return torch.cat(parts, dim=1)
