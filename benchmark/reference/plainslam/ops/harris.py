"""Dense Harris corner response (counterpart of slamtpu/ops/harris.py).

3x3 Sobel gradients, a (2r+1)^2 box-summed structure tensor with
wraparound rolls, and det - k * trace^2. Sums are taken in the JAX
package's order so that the two agree to the last few ulps.
"""

from __future__ import annotations

import torch

__all__ = ["harris_response"]


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(img, (-dy, -dx), dims=(1, 2))


def _box_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 box filter as two separable running sums (wraparound)."""
    out = img
    acc = out
    for d in range(1, radius + 1):
        acc = acc + torch.roll(out, d, dims=1) + torch.roll(out, -d, dims=1)
    out = acc
    acc = out
    for d in range(1, radius + 1):
        acc = acc + torch.roll(out, d, dims=2) + torch.roll(out, -d, dims=2)
    return acc


def harris_response(images: torch.Tensor, block_radius: int = 3, k: float = 0.04) -> torch.Tensor:
    """[B, H, W] f32 -> Harris response det(M) - k * trace(M)^2."""
    gx = (_shift(images, -1, 1) + 2.0 * _shift(images, 0, 1) + _shift(images, 1, 1)) - (
        _shift(images, -1, -1) + 2.0 * _shift(images, 0, -1) + _shift(images, 1, -1)
    )
    gy = (_shift(images, 1, -1) + 2.0 * _shift(images, 1, 0) + _shift(images, 1, 1)) - (
        _shift(images, -1, -1) + 2.0 * _shift(images, -1, 0) + _shift(images, -1, 1)
    )
    sxx = _box_sum(gx * gx, block_radius)
    syy = _box_sum(gy * gy, block_radius)
    sxy = _box_sum(gx * gy, block_radius)
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace
