"""Two-view relative pose: RANSAC essential + cheirality-voted (R, t)
(counterpart of slamtpu/odometry/pose.py `estimate_relative_pose`).
Batched over leading dimensions (one per frame pair)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.epipolar import recover_pose_from_essential
from ..ops.ransac import RansacConfig, ransac_essential
from .camera import CameraIntrinsics

__all__ = ["MIN_MATCHES", "RelativePose", "estimate_relative_pose"]

MIN_MATCHES = 8


class RelativePose(NamedTuple):
    rotation: torch.Tensor  # [..., 3, 3]
    translation: torch.Tensor  # [..., 3] unit norm
    num_inliers: torch.Tensor  # [...] int32
    valid: torch.Tensor  # [...] bool — >= MIN_MATCHES cheirality inliers and input matches
    inliers: torch.Tensor  # [..., N] bool


def estimate_relative_pose(intrinsics: CameraIntrinsics, points1, points2, mask=None,
                           config: RansacConfig = RansacConfig(), sigma=None, uniforms=None,
                           generator=None) -> RelativePose:
    """Pixel correspondences [..., N, 2] -> relative pose, p2 = R p1 + t.

    Failures (too few matches or cheirality inliers) come back as
    valid=False with identity rotation and zero translation. `uniforms`
    ([..., iters, N]) and `generator` feed ransac_essential's sampling.
    """
    if config.homography_fallback:
        raise NotImplementedError("homography_fallback is not ported yet")
    if mask is None:
        mask = torch.ones(points1.shape[:-1], dtype=torch.bool, device=points1.device)
    norm1 = intrinsics.normalize(points1)
    norm2 = intrinsics.normalize(points2)
    threshold_norm = config.threshold / torch.tensor(intrinsics.fx, dtype=norm1.dtype, device=norm1.device)
    result = ransac_essential(
        norm1, norm2, mask=mask, threshold_norm=threshold_norm, config=config, sigma=sigma,
        uniforms=uniforms, generator=generator,
    )
    rotation, translation, votes = recover_pose_from_essential(
        result.essential, norm1, norm2, mask=result.inliers
    )
    # recoverPose's count: RANSAC inliers passing the winning candidate's
    # cheirality test; the reference requires >= 8 of THOSE.
    cheirality_inliers = torch.amax(votes, dim=-1)
    enough_input = torch.sum(mask, dim=-1) >= MIN_MATCHES
    valid = enough_input & (cheirality_inliers >= MIN_MATCHES)
    eye = torch.eye(3, dtype=rotation.dtype, device=rotation.device)
    rotation = torch.where(valid[..., None, None], rotation, eye)
    translation = torch.where(valid[..., None], translation, torch.zeros_like(translation))
    return RelativePose(rotation, translation, result.num_inliers, valid, result.inliers)
