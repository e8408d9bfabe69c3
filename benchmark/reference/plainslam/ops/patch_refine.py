"""Sub-pixel match refinement by local patch alignment (counterpart of
slamtpu/ops/patch_refine.py).

For each match (p1, p2): the (2r+1)^2 template around round(p1) in frame 1
slides over a (2s+1)^2 grid of offsets around round(p2) in frame 2; the SSD
minimum (ties broken toward the centre) plus a clamped 1-D parabola per
axis gives the refined p2. Windows are cut by one gather with each start
taken as the reference's `lax.dynamic_slice` takes it: a negative start
counts from the end of its axis, then the start is clamped so that the
window lies in the image. Batched over leading dimensions (one per frame
pair).
"""

from __future__ import annotations

import torch

__all__ = ["refine_matches"]


def _gather_windows(images: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """[B, H, W] images + [B, K, 2] centres -> [B, K, 2r+1, 2r+1] windows
    around the rounded centres, starts placed as `lax.dynamic_slice`
    places them (see the module note)."""
    b, h, w = images.shape
    size = 2 * radius + 1
    starts = torch.round(xy).to(torch.int64) - radius

    def place(s, n):
        return torch.where(s < 0, s + n, s).clamp(0, max(n - size, 0))

    x0, y0 = place(starts[..., 0], w), place(starts[..., 1], h)
    r = torch.arange(size, device=images.device)
    rows = (y0[..., None] + r)[..., :, None]  # [B, K, size, 1]
    cols = (x0[..., None] + r)[..., None, :]  # [B, K, 1, size]
    flat = (rows * w + cols).reshape(b, -1)
    return torch.gather(images.reshape(b, -1), 1, flat).reshape(*xy.shape[:-1], size, size)


def refine_matches(img1, img2, p1, p2, mask=None, radius: int = 4, search: int = 2) -> torch.Tensor:
    """Refine matched positions p2 by SSD alignment against p1.

    img1, img2: [..., H, W] level-0 frames (uint8 or float); p1, p2:
    [..., K, 2] pixel coordinates of the matched keypoints (query in img1,
    train in img2); mask [..., K] live matches, the dead ones pass through
    unrefined. Returns p2 refined, [..., K, 2] float32: round(p2) plus the
    integer SSD argmin within +-search px and a parabola-interpolated
    sub-pixel term (0 where the surface is not locally convex, or the
    minimum sits on the grid's edge).
    """
    lead = p1.shape[:-2]
    k = p1.shape[-2]
    h, w = img1.shape[-2:]
    img1 = img1.to(torch.float32).reshape(-1, h, w)
    img2 = img2.to(torch.float32).reshape(-1, h, w)
    q1, q2 = p1.reshape(-1, k, 2), p2.reshape(-1, k, 2)
    if mask is None:
        mask = torch.ones(lead + (k,), dtype=torch.bool, device=p1.device)

    tpl = _gather_windows(img1, q1, radius)  # [B, K, T, T]
    win = _gather_windows(img2, q2, radius + search)  # [B, K, T + 2s, T + 2s]
    t = 2 * radius + 1
    n_off = 2 * search + 1
    cost = torch.stack([
        torch.stack([torch.sum((win[..., dy:dy + t, dx:dx + t] - tpl) ** 2, dim=(-2, -1)) for dx in range(n_off)],
                    dim=-1)
        for dy in range(n_off)
    ], dim=-2)  # [B, K, n_off, n_off]

    # Centre-preferring tie-break: each cell is biased by its squared offset
    # times ~1e-6 of the match's cost range, so a flat surface keeps the
    # centre and any genuine minimum still wins.
    flat = cost.reshape(*cost.shape[:-2], -1)
    off2 = (torch.arange(n_off, dtype=torch.float32, device=flat.device) - search) ** 2
    dist2 = (off2[:, None] + off2[None, :]).reshape(-1)
    rng_cost = torch.amax(flat, dim=-1, keepdim=True) - torch.amin(flat, dim=-1, keepdim=True)
    amin = torch.argmin(flat + dist2 * (1e-6 * rng_cost + 1e-30), dim=-1)
    iy, ix = amin // n_off, amin % n_off

    def parabola(lo, c, hi):
        denom = lo - 2.0 * c + hi
        pos = denom > 0
        off = torch.where(pos, 0.5 * (lo - hi) / torch.where(pos, denom, torch.ones_like(denom)),
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    def at(yy, xx):
        return torch.gather(flat, -1, (yy * n_off + xx)[..., None])[..., 0]

    ixc, iyc = ix.clamp(1, n_off - 2), iy.clamp(1, n_off - 2)
    zero = torch.zeros_like(rng_cost[..., 0])
    sub_x = torch.where((ix > 0) & (ix < n_off - 1), parabola(at(iy, ixc - 1), at(iy, ixc), at(iy, ixc + 1)), zero)
    sub_y = torch.where((iy > 0) & (iy < n_off - 1), parabola(at(iyc - 1, ix), at(iyc, ix), at(iyc + 1, ix)), zero)
    delta = torch.stack([(ix - search).to(torch.float32) + sub_x, (iy - search).to(torch.float32) + sub_y], dim=-1)
    refined = (torch.round(q2) + delta).reshape(lead + (k, 2))
    return torch.where(mask[..., None], refined, p2).to(torch.float32)
