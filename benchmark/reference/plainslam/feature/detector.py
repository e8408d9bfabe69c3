"""ORB keypoint detector + descriptor over batched image pyramids
(counterpart of slamtpu/feature/detector.py).

Fixed shapes: each pyramid level contributes a static quota of keypoints
(OpenCV's geometric per-level distribution) and short levels pad with
masked slots. One launch of kernel K1 (ops/corner.py: FAST + NMS + Harris
ranking) covers every level; then, per level, exact top-k with a
sub-pixel Harris fit at the finest levels; one launch of kernel K2
(ops/patch.py) cuts the 39x39 windows of every level's blurred image into
one [B, K, 39, 39] tensor in slot order; intensity-centroid orientation and
binned rBRIEF run once over all K slots. With `descriptor_bins=0` the same
launch also cuts the windows of the raw levels: orientation is measured on
those and OpenCV's continuously steered BRIEF reads the blurred ones. Both
kernels run on CUDA tensors; their plain versions on CPU tensors.

Selection uses exact `torch.topk`; the JAX package's approx_max_k is exact
on the CPU, where the parity tests run it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.brief import PATCH_RADIUS, brief_descriptors, brief_descriptors_binned, orientation
from ..ops.corner import corner_response_levels
from ..ops.patch import extract_patches_levels
from ..ops.pyramid import build_pyramid, gaussian_blur

__all__ = ["OrbConfig", "OrbFeatures", "OrbDetector", "detect_and_compute", "features_per_level"]


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """The JAX package's OrbConfig without its two TPU switches
    (`exact_topk`: selection here is always exact; `corner_backend`: the
    kernel is chosen by tensor device)."""

    max_features: int = 500
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: float = 20.0
    edge_threshold: int = 31
    patch_size: int = 31
    descriptor_bins: int = 12  # > 0: binned steering; 0: continuous rotation (orientation on the raw image)
    subpixel: bool = True
    subpixel_max_octave: int = 2


class OrbFeatures(NamedTuple):
    """Struct-of-tensors keypoints + descriptors, K slots with a mask.
    Coordinates are level-0 pixels (x, y)."""

    xy: torch.Tensor  # [..., K, 2] float32
    response: torch.Tensor  # [..., K] float32 Harris score
    angle: torch.Tensor  # [..., K] float32 radians
    octave: torch.Tensor  # [..., K] int32 pyramid level
    size: torch.Tensor  # [..., K] float32 scaled patch diameter
    descriptors: torch.Tensor  # [..., K, 32] uint8 rBRIEF, little bit order
    mask: torch.Tensor  # [..., K] bool

    def count(self) -> torch.Tensor:
        """Live keypoints per frame, [...] int32."""
        return torch.sum(self.mask, dim=-1, dtype=torch.int32)


def features_per_level(max_features: int, n_levels: int, scale_factor: float):
    """OpenCV's geometric keypoint quota per level (last takes the remainder)."""
    factor = 1.0 / scale_factor
    n_first = max_features * (1.0 - factor) / (1.0 - factor**n_levels)
    quotas = []
    acc = 0
    for level in range(n_levels - 1):
        q = int(round(n_first * factor**level))
        quotas.append(q)
        acc += q
    quotas.append(max(max_features - acc, 0))
    return quotas


def _subpixel_offsets(harris_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Quadratic-fit offsets in (-0.5, 0.5) from each keypoint's 3x3 Harris
    neighbourhood: harris_map [B, H, W], xy [B, K, 2] integer-valued ->
    [B, K, 2]; 0 where the surface is not locally concave."""
    b, h, w = harris_map.shape
    xi = torch.round(xy).to(torch.int64)
    offs = torch.arange(-1, 2, device=xy.device)
    rows = xi[..., 1][..., None, None] + offs[:, None]
    cols = xi[..., 0][..., None, None] + offs[None, :]
    flat = (rows * w + cols).reshape(b, -1)
    s = torch.gather(harris_map.reshape(b, -1), 1, flat).reshape(*xi.shape[:-1], 3, 3)

    def parabola(lo, c, hi):
        denom = lo - 2.0 * c + hi
        neg = denom < 0
        off = torch.where(neg, 0.5 * (lo - hi) / torch.where(neg, denom, -torch.ones_like(denom)),
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    dx = parabola(s[..., 1, 0], s[..., 1, 1], s[..., 1, 2])
    dy = parabola(s[..., 0, 1], s[..., 1, 1], s[..., 2, 1])
    return torch.stack([dx, dy], dim=-1)


def _select_level(ranked: torch.Tensor, quota: int, margin: int, harris_map=None):
    """Top-`quota` Harris-ranked corners per image of one level.

    ranked [B, H, W] -> (xy [B, quota, 2] integer centers, xy_out with the
    sub-pixel term, response, mask). Masked slots park at the level center.
    """
    b, h, w = ranked.shape
    row = torch.arange(h, device=ranked.device)[:, None]
    col = torch.arange(w, device=ranked.device)[None, :]
    interior = (row >= margin) & (row < h - margin) & (col >= margin) & (col < w - margin)
    neg_inf = torch.full((), float("-inf"), dtype=ranked.dtype, device=ranked.device)
    ranked = torch.where(interior, ranked, neg_inf).reshape(b, -1)
    top_vals, top_idx = torch.topk(ranked, quota, dim=-1)
    mask = torch.isfinite(top_vals)
    x = torch.where(mask, (top_idx % w).to(torch.float32), float(w // 2))
    y = torch.where(mask, (top_idx // w).to(torch.float32), float(h // 2))
    xy = torch.stack([x, y], dim=-1)
    xy_out = xy + _subpixel_offsets(harris_map, xy) if harris_map is not None else xy
    return xy, xy_out, torch.where(mask, top_vals, torch.zeros_like(top_vals)), mask


def detect_and_compute(images: torch.Tensor, config: OrbConfig = OrbConfig(), groups: int = 1) -> OrbFeatures:
    """Batched ORB: [B, H, W] (float or uint8) -> OrbFeatures with
    K = config.max_features slots per image, on the images' device.

    groups: the batch is that many equal runs of frames (sequences of
    run_vo_batched). The pyramid's resize matmuls run once per run: cuBLAS
    picks their kernels by batch size, so this keeps each run's features
    those it gets when detected alone. Everything else, both kernels
    included, runs once over the whole batch."""
    images = images.to(torch.float32).contiguous()
    batch = images.shape[0]
    device = images.device
    if groups == 1:
        pyramid = build_pyramid(images, config.n_levels, config.scale_factor)
    else:
        pyramid = [torch.cat(parts) for parts in zip(*(build_pyramid(x, config.n_levels, config.scale_factor)
                                                       for x in images.chunk(groups)))]
    quotas = features_per_level(config.max_features, config.n_levels, config.scale_factor)
    min_extent = max(2 * PATCH_RADIUS + 1, 2 * config.edge_threshold + 1)
    # Levels with a quota, in slot order; those too small for the patch /
    # border margin keep masked slots so K stays static.
    slot_levels = [lv for lv, q in enumerate(quotas) if q > 0]
    used = [lv for lv in slot_levels if min(pyramid[lv].shape[1:]) >= min_extent]
    level_images = {lv: pyramid[lv].contiguous() for lv in used}
    want_sub = [config.subpixel and lv <= config.subpixel_max_octave for lv in used]

    # K1, one launch over every used level.
    ranked, harris = corner_response_levels([level_images[lv] for lv in used], config.fast_threshold, want_sub)
    xy, resp, mask, octave, size, starts = [], [], [], [], [], []
    for lv in slot_levels:
        q, scale = quotas[lv], config.scale_factor**lv
        octave.append(torch.full((batch, q), lv, dtype=torch.int32, device=device))
        size.append(torch.full((batch, q), config.patch_size * scale, dtype=torch.float32, device=device))
        if lv in level_images:
            i = used.index(lv)
            xy_int, xy_l, resp_l, mask_l = _select_level(ranked[i], q, config.edge_threshold, harris[i])
            xy.append(xy_l * scale)
            resp.append(resp_l)
            mask.append(mask_l)
            starts.append((torch.round(xy_int).to(torch.int32) - PATCH_RADIUS).contiguous())
        else:
            xy.append(torch.zeros((batch, q, 2), dtype=torch.float32, device=device))
            resp.append(torch.zeros((batch, q), dtype=torch.float32, device=device))
            mask.append(torch.zeros((batch, q), dtype=torch.bool, device=device))
            starts.append(torch.zeros((batch, q, 2), dtype=torch.int32, device=device))

    # K2, one launch over every level (zero windows for the unused ones);
    # then orientation and BRIEF once over all slots. The continuous path
    # adds the raw levels to the same launch.
    blurred = [gaussian_blur(level_images[lv]) if lv in level_images else None for lv in slot_levels]
    if config.descriptor_bins > 0:
        patches = extract_patches_levels(blurred, starts, PATCH_RADIUS)
        ang = orientation(patches)
        desc = brief_descriptors_binned(patches, ang, config.descriptor_bins)
    else:
        raw = [level_images.get(lv) for lv in slot_levels]
        both = extract_patches_levels(raw + blurred, starts + starts, PATCH_RADIUS)
        k = both.shape[1] // 2
        ang = orientation(both[:, :k])
        desc = brief_descriptors(both[:, k:], ang)
    if len(used) < len(slot_levels):
        used_slot = torch.cat([torch.full((batch, quotas[lv]), lv in level_images, dtype=torch.bool, device=device)
                               for lv in slot_levels], dim=1)
        ang = torch.where(used_slot, ang, torch.zeros_like(ang))
        desc = torch.where(used_slot[..., None], desc, torch.zeros_like(desc))
    xy, resp, octave, size, mask = (torch.cat(parts, dim=1) for parts in (xy, resp, octave, size, mask))
    return OrbFeatures(xy, resp, ang, octave, size, desc, mask)


class OrbDetector:
    """Eager detector on one image [H, W] (or a batch [B, H, W]) with the
    requested feature budget. Images are moved to `device` ("cuda" unless
    the caller asks for the CPU)."""

    def __init__(self, max_features: int = 500, config: OrbConfig | None = None, device=None):
        self.config = dataclasses.replace(config or OrbConfig(), max_features=max_features)
        self.device = resolve_device(device)

    def detect(self, image) -> OrbFeatures:
        """Keypoints (the descriptors come with them)."""
        return self.detect_and_compute(image)

    def detect_and_compute(self, image) -> OrbFeatures:
        """Keypoints + descriptors; a single image gives unbatched fields."""
        image = torch.as_tensor(image, device=self.device)
        single = image.dim() == 2
        feats = detect_and_compute(image[None] if single else image, self.config)
        return OrbFeatures(*[x[0] for x in feats]) if single else feats
