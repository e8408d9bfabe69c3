"""Two-view relative pose: RANSAC essential + cheirality-voted (R, t)
(counterpart of slamtpu/odometry/pose.py). `estimate_relative_pose` is
batched over leading dimensions (one per frame pair); `PoseEstimator` is
the eager one-pair API that raises where the batched path returns a flag.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.epipolar import recover_pose_from_essential, sampson_error
from ..ops.homography import ransac_homography, recover_pose_from_homography
from ..ops.ransac import PairDraws, RansacConfig, RansacResult, as_draws, ransac_essential
from ..utils import graphs
from ..utils.graphs import device_constant
from ..utils.metrics import span
from .camera import CameraIntrinsics

__all__ = ["MIN_MATCHES", "PoseEstimator", "RelativePose", "estimate_relative_pose", "extract_matched_points"]

MIN_MATCHES = 8


class RelativePose(NamedTuple):
    rotation: torch.Tensor  # [..., 3, 3]
    translation: torch.Tensor  # [..., 3] unit norm
    num_inliers: torch.Tensor  # [...] int32
    valid: torch.Tensor  # [...] bool — >= MIN_MATCHES cheirality inliers and input matches
    inliers: torch.Tensor  # [..., N] bool


def extract_matched_points(kp1, kp2, train_idx, mask):
    """Matched pixel pairs at static shape: kp1 [..., N, 2], kp2 [..., M, 2],
    train_idx [..., N], mask [..., N] -> (points1 [..., N, 2], points2
    [..., N, 2], mask); row i pairs kp1[i] with kp2[train_idx[i]] and dead
    rows stay in place, excluded by the mask."""
    idx = train_idx.to(torch.int64)[..., None].expand(*train_idx.shape, 2)
    return kp1, torch.gather(kp2, -2, idx), mask


def estimate_relative_pose(intrinsics: CameraIntrinsics, points1, points2, mask=None,
                           config: RansacConfig = RansacConfig(), sigma=None, uniforms=None,
                           generator=None) -> RelativePose:
    """Pixel correspondences [..., N, 2] -> relative pose, p2 = R p1 + t.

    Failures (too few matches or cheirality inliers) come back as
    valid=False with identity rotation and zero translation. `uniforms` is
    the essential stream [..., iters, N] or a `PairDraws` with the streams
    the config needs; a stream not given is drawn with `generator`.

    With `config.homography_fallback` a homography is fitted beside E
    (same threshold and sigma, `homography_iters` hypotheses) and its pose
    is taken when its share S_H / (S_H + S_E) of the two inlier counts
    exceeds `homography_ratio`; that pose is gated on the homography's own
    inlier count.
    """
    draws = as_draws(uniforms)
    if mask is None:
        mask = torch.ones(points1.shape[:-1], dtype=torch.bool, device=points1.device)
    norm1 = intrinsics.normalize(points1)
    norm2 = intrinsics.normalize(points2)
    threshold_norm = config.threshold / device_constant(intrinsics.fx, norm1.dtype, norm1.device)
    result = ransac_essential(
        norm1, norm2, mask=mask, threshold_norm=threshold_norm, config=config, sigma=sigma,
        uniforms=draws, generator=generator,
    )
    fallback = config.homography_fallback
    with span("pose.recover"):
        rotation, translation, num_inliers, valid = graphs.run(
            "pose.recover", functools.partial(_recover, config=config, generator=generator),
            (result.essential, result.inliers, result.num_inliers, norm1, norm2, mask,
             *((sigma, threshold_norm, draws.homography) if fallback else (None,) * 3)),
            static=config, eager=fallback and draws.homography is None)
        return RelativePose(rotation, translation, num_inliers, valid, result.inliers)


def _recover(essential, inliers, num_inliers, norm1, norm2, mask, sigma, threshold_norm, u_homography,
             config: RansacConfig, generator=None):
    """The `pose.recover` region: (R, t, inlier count, valid) of the
    cheirality vote, or of the homography where it wins."""
    rotation, translation, votes = recover_pose_from_essential(essential, norm1, norm2, mask=inliers)
    # recoverPose's count: RANSAC inliers passing the winning candidate's
    # cheirality test; the reference requires >= 8 of THOSE.
    cheirality_inliers = torch.amax(votes, dim=-1)

    if config.homography_fallback:
        h, h_inliers, h_count = ransac_homography(
            norm1, norm2, mask=mask, threshold_norm=threshold_norm, iters=config.homography_iters,
            sigma=sigma, uniforms=u_homography, generator=generator,
        )
        r_h, t_h, _ = recover_pose_from_homography(h, norm1, norm2, mask=h_inliers)
        ratio = h_count.to(norm1.dtype) / torch.clamp((h_count + num_inliers).to(norm1.dtype), min=1.0)
        use_h = ratio > config.homography_ratio
        rotation = torch.where(use_h[..., None, None], r_h, rotation)
        translation = torch.where(use_h[..., None], t_h, translation)
        num_inliers = torch.where(use_h, h_count, num_inliers)
        cheirality_inliers = torch.where(use_h, h_count, cheirality_inliers)

    enough_input = torch.sum(mask, dim=-1) >= MIN_MATCHES
    valid = enough_input & (cheirality_inliers >= MIN_MATCHES)
    eye = torch.eye(3, dtype=rotation.dtype, device=rotation.device)
    rotation = torch.where(valid[..., None, None], rotation, eye)
    translation = torch.where(valid[..., None], translation, torch.zeros_like(translation))
    return rotation, translation, num_inliers, valid


class PoseEstimator:
    """Eager one-pair pose API that raises on too few points or inliers.

    Its tensors live on `device` ("cuda" unless the caller asks for the
    CPU). RANSAC draws come from a `torch.Generator` seeded with `seed`
    (CPU-side, so a seed draws the same numbers on every device) unless a
    call passes `uniforms`.
    """

    def __init__(self, intrinsics: CameraIntrinsics, min_matches: int = MIN_MATCHES, seed: int = 0,
                 device=None):
        self.intrinsics = intrinsics
        self.min_matches = min_matches
        self.device = resolve_device(device)
        self._generator = torch.Generator().manual_seed(seed)

    def extract_matched_points(self, kp1, kp2, matches):
        """Live matches of a `Matches` as two [L, 2] numpy arrays."""
        kp1, kp2 = np.asarray(kp1), np.asarray(kp2)
        live = np.asarray(torch.as_tensor(matches.mask).cpu())
        idx = np.asarray(torch.as_tensor(matches.train_idx).cpu())
        return kp1[live], kp2[idx[live]]

    def _points(self, points):
        return torch.as_tensor(points, device=self.device)

    def compute_essential_matrix(self, points1, points2, config: RansacConfig = RansacConfig(),
                                 uniforms=None) -> RansacResult:
        """RANSAC essential matrix of [N, 2] pixel pairs; raises ValueError
        below `min_matches` points."""
        points1, points2 = self._points(points1), self._points(points2)
        if points1.shape[0] < self.min_matches or points2.shape[0] < self.min_matches:
            raise ValueError(f"Insufficient points: {points1.shape[0]} (need {self.min_matches})")
        n = points1.shape[0]
        if uniforms is None:
            uniforms = PairDraws(torch.rand((config.iters, n), generator=self._generator),
                                 prescore=torch.rand((n,), generator=self._generator)
                                 if config.prescore_subset else None)
        draws = PairDraws(*[None if d is None else torch.as_tensor(d).to(self.device) for d in as_draws(uniforms)])
        return ransac_essential(
            self.intrinsics.normalize(points1), self.intrinsics.normalize(points2),
            threshold_norm=config.threshold / float(self.intrinsics.fx), config=config, uniforms=draws,
        )

    def recover_pose(self, essential_or_result, points1, points2):
        """(R, t) numpy arrays with cheirality disambiguation; raises
        ValueError below `min_matches` cheirality inliers. Given a bare E,
        the inliers are the pairs within a 1 px Sampson band."""
        norm1 = self.intrinsics.normalize(self._points(points1))
        norm2 = self.intrinsics.normalize(self._points(points2))
        if isinstance(essential_or_result, RansacResult):
            essential, inlier_mask = essential_or_result.essential, essential_or_result.inliers
        else:
            essential = torch.as_tensor(essential_or_result, dtype=norm1.dtype, device=self.device)
            inlier_mask = sampson_error(essential, norm1, norm2) < (1.0 / float(self.intrinsics.fx)) ** 2
        rotation, translation, votes = recover_pose_from_essential(essential, norm1, norm2, mask=inlier_mask)
        inliers = int(torch.amax(votes))
        if inliers < self.min_matches:
            raise ValueError(f"Too few inliers: {inliers}")
        return rotation.cpu().numpy(), translation.cpu().numpy()
