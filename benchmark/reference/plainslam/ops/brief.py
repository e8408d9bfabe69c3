"""Steered BRIEF descriptors and intensity-centroid orientation
(counterpart of slamtpu/ops/brief.py).

The 256 point-pair pattern comes from the same numpy seed as the JAX
package, so the descriptor format is identical: bit j of byte i is test
(pair 8i+j), little bit order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .hamming import pack_bits

__all__ = [
    "HALF_PATCH",
    "PATCH_RADIUS",
    "PATCH_SIZE",
    "brief_pattern",
    "orientation",
    "brief_descriptors",
    "brief_descriptors_binned",
]

HALF_PATCH = 15  # orientation circle radius (OpenCV HALF_PATCH_SIZE)
_PATTERN_CLIP = 13  # pattern coordinates live in [-13, 13]
PATCH_RADIUS = 19  # ceil(13 * sqrt(2)): the rotated pattern stays inside
PATCH_SIZE = 2 * PATCH_RADIUS + 1  # 39


@functools.lru_cache()
def brief_pattern(n_pairs: int = 256, seed: int = 0x0B12F) -> np.ndarray:
    """Deterministic point-pair pattern, [n_pairs, 4] int32 (x1, y1, x2, y2):
    Gaussian(0, (31/5)^2) endpoints clipped to +/-13, degenerate pairs
    nudged. Read-only: the cached array is shared by every caller."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(n_pairs, 4))
    pts = np.clip(np.round(pts), -_PATTERN_CLIP, _PATTERN_CLIP).astype(np.int32)
    same = np.all(pts[:, :2] == pts[:, 2:], axis=1)
    pts[same, 2] = np.minimum(pts[same, 2] + 1, _PATTERN_CLIP)
    pts[same & (pts[:, 0] == pts[:, 2]), 2] -= 2
    pts.setflags(write=False)
    return pts


@functools.lru_cache()
def _orientation_weights():
    """Circular-mask (dx, dy) weight grids for the intensity centroid."""
    r = HALF_PATCH
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (dx * dx + dy * dy) <= r * r
    return (dx * mask).astype(np.float32), (dy * mask).astype(np.float32)


def orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) per patch [..., P, P] -> [...]
    over the central 31x31 circular region."""
    wx_np, wy_np = _orientation_weights()
    wx = torch.from_numpy(wx_np).to(patches.device)
    wy = torch.from_numpy(wy_np).to(patches.device)
    c = (patches.shape[-1] - 1) // 2
    r = HALF_PATCH
    center = patches[..., c - r : c + r + 1, c - r : c + r + 1]
    m10 = torch.sum(center * wx, dim=(-2, -1))
    m01 = torch.sum(center * wy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def brief_descriptors(blurred_patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF with the orientation taken as is (OpenCV's continuous
    rotation): [..., P, P] blurred patches + [...] angles -> [..., 32] uint8.
    Each pattern point is rotated by its keypoint's angle, rounded to the
    nearest pixel as cvRound rounds (ties to even) and read from the patch."""
    p = blurred_patches.shape[-1]
    c = (p - 1) // 2
    pat = torch.tensor(brief_pattern(), dtype=angles.dtype, device=blurred_patches.device)
    cos, sin = torch.cos(angles)[..., None], torch.sin(angles)[..., None]

    def sample_index(px, py):
        rx = torch.round(px * cos - py * sin).to(torch.int64) + c
        ry = torch.round(px * sin + py * cos).to(torch.int64) + c
        return ry * p + rx

    flat = blurred_patches.reshape(*blurred_patches.shape[:-2], p * p)
    v1 = torch.gather(flat, -1, sample_index(pat[:, 0], pat[:, 1]))
    v2 = torch.gather(flat, -1, sample_index(pat[:, 2], pat[:, 3]))
    return pack_bits((v1 < v2).to(torch.uint8))


@functools.lru_cache()
def _binned_sample_indices(n_bins: int, patch: int = PATCH_SIZE) -> np.ndarray:
    """[n_bins, 512] int32 flat patch indices: the pattern endpoints rotated
    by each bin's center angle (the ORB paper's discretized steering),
    rounded and clipped. Read-only."""
    pat = brief_pattern()
    pts = np.concatenate([pat[:, :2], pat[:, 2:]], axis=0).astype(np.float64)
    c = (patch - 1) // 2
    out = np.zeros((n_bins, 512), np.int32)
    for b in range(n_bins):
        ang = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(ang), np.sin(ang)
        x = np.round(pts[:, 0] * ca - pts[:, 1] * sa).astype(np.int64) + c
        y = np.round(pts[:, 0] * sa + pts[:, 1] * ca).astype(np.int64) + c
        x = np.clip(x, 0, patch - 1)
        y = np.clip(y, 0, patch - 1)
        out[b] = (y * patch + x).astype(np.int32)
    out.setflags(write=False)
    return out


def brief_descriptors_binned(blurred_patches: torch.Tensor, angles: torch.Tensor, n_bins: int = 12):
    """Steered BRIEF with the orientation snapped to the nearest of
    `n_bins` bins: [..., P, P] patches + [...] angles -> [..., 32] uint8.

    Each keypoint reads only its own bin's 512 static sample indices (the
    JAX package samples every bin and selects; the values are the same).
    """
    p = blurred_patches.shape[-1]
    flat = blurred_patches.reshape(*blurred_patches.shape[:-2], p * p)
    idx = torch.from_numpy(_binned_sample_indices(n_bins, p).astype(np.int64)).to(flat.device)
    frac = torch.remainder(angles / (2.0 * math.pi), 1.0)
    bin_idx = torch.remainder(torch.round(frac * n_bins).to(torch.int64), n_bins)
    vals = torch.gather(flat, -1, idx[bin_idx])  # [..., 512]
    bits = (vals[..., :256] < vals[..., 256:]).to(torch.uint8)
    return pack_bits(bits)
