"""Batched image pyramids and Gaussian blur (counterpart of
slamtpu/ops/pyramid.py).

The bilinear resize is two dense weight matmuls. With two non-zero taps per
row it is EXACT only in full fp32 (two f32 products plus exact zeros), so
the package keeps `torch.backends.cuda.matmul.allow_tf32 = False` (set in
slamtpu_torch/__init__.py). The blur is written as shifted-slice sums, not
`F.conv2d`, whose cuDNN algorithm (and so summation order) is cuDNN's choice;
the package turns cuDNN's TF32 off as well.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pyramid_shapes", "build_pyramid", "gaussian_blur", "resize_bilinear_matmul"]


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """Dense [n_out, n_in] bilinear weights (half-pixel centers, cv2
    INTER_LINEAR taps), built from f64 numpy tap vectors as the JAX package
    builds them, so the f32 weights are bit-identical."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = torch.from_numpy((src - lo).astype(np.float32)).to(device)
    lo_c = torch.from_numpy(np.clip(lo, 0, n_in - 1)).to(device)
    hi_c = torch.from_numpy(np.clip(lo + 1, 0, n_in - 1)).to(device)
    i = torch.arange(n_in, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    w = torch.where(i == lo_c[:, None], 1.0 - frac[:, None], zero)
    return w + torch.where(i == hi_c[:, None], frac[:, None], zero)


def resize_bilinear_matmul(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, H, W] f32 -> [B, out_h, out_w] bilinear resize as two matmuls."""
    wh = _resize_weights(images.shape[1], out_h, images.device)
    ww = _resize_weights(images.shape[2], out_w, images.device)
    return torch.matmul(torch.matmul(wh, images), ww.T)


def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float = 1.2):
    """Per-level (H, W) shapes, OpenCV-style rounding."""
    return [
        (int(round(height / scale_factor**level)), int(round(width / scale_factor**level)))
        for level in range(n_levels)
    ]


def build_pyramid(images: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2):
    """[B, H, W] f32 -> list of n_levels tensors [B, H_l, W_l]; every level is
    resized from the ORIGINAL image (like OpenCV ORB)."""
    b, h, w = images.shape
    levels = [images]
    for hl, wl in pyramid_shapes(h, w, n_levels, scale_factor)[1:]:
        levels.append(resize_bilinear_matmul(images, hl, wl))
    return levels


def _gaussian_taps(ksize: int, sigma: float):
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return [float(v) for v in k.astype(np.float32)]


def _pad_edge(x: torch.Tensor, half: int, dim: int) -> torch.Tensor:
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    reps = [1] * x.dim()
    reps[dim] = half
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=dim)


def gaussian_blur(images: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge-replicate padding, [B, H, W] -> same.

    Taps are summed in the JAX package's order (rows, then columns, tap 0
    first), each product in f32.
    """
    half = ksize // 2
    taps = _gaussian_taps(ksize, sigma)
    h, w = images.shape[1], images.shape[2]
    padded = _pad_edge(images, half, 1)
    rows = torch.zeros_like(images)
    for i, k in enumerate(taps):
        rows = rows + k * padded[:, i : i + h, :]
    padded = _pad_edge(rows, half, 2)
    out = torch.zeros_like(images)
    for i, k in enumerate(taps):
        out = out + k * padded[:, :, i : i + w]
    return out
