"""Two-view DLT triangulation into map points (counterpart of
slamtpu/mapping/triangulation.py).

One batched 4x4 eigenproblem over all correspondences: each pair gives the
four DLT rows of P_1 = K [R_1 | t_1] and P_2, rows normalised, and the
homogeneous point is the smallest eigenvector of A^T A by single-vector
inverse iteration (the DLT null space is 1-D for any point with parallax).
A point is accepted where |w| > 1e-10 and it lies in front of both cameras;
the parallax and reprojection filters exist behind flags that default off,
as in the reference.

Poses are world-to-camera (R, t); points come out in the frame the poses
are expressed in.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..odometry.camera import CameraIntrinsics
from ..ops.epipolar import smallest_eigvec

__all__ = ["MapPoint", "MapPoints", "Triangulator", "triangulate_points"]


@dataclasses.dataclass
class MapPoint:
    """One map point on the host."""

    position: np.ndarray  # [3]
    descriptor: Optional[np.ndarray] = None  # [32] uint8
    observations: int = 1
    id: int = 0

    def add_observation(self):
        self.observations += 1


class MapPoints(NamedTuple):
    """A batch of map points with a validity mask."""

    positions: torch.Tensor  # [N, 3]
    descriptors: torch.Tensor  # [N, 32] uint8 (zeros where absent)
    valid: torch.Tensor  # [N] bool

    def count(self):
        return torch.sum(self.valid, dtype=torch.int32)


def _as(x, dtype, device):
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def triangulate_points(intrinsics: CameraIntrinsics, pose1, pose2, points1, points2, *,
                       min_parallax_deg: float = 1.0, max_reproj_error: float = 4.0,
                       enforce_parallax: bool = False, enforce_reproj: bool = False):
    """pose1/pose2: (R [3, 3], t [3]) world-to-camera; points1/points2 [N, 2]
    pixels. Returns (positions [N, 3], valid [N] bool) in the points' float
    dtype (f32 for integer input), on the points' device."""
    p1 = torch.as_tensor(points1)
    p2 = torch.as_tensor(points2)
    dtype = p1.dtype if p1.is_floating_point() else torch.float32
    dev = p1.device
    p1, p2 = p1.to(dtype), p2.to(dtype=dtype, device=dev)
    r1, t1 = _as(pose1[0], dtype, dev), _as(pose1[1], dtype, dev)
    r2, t2 = _as(pose2[0], dtype, dev), _as(pose2[1], dtype, dev)
    k = intrinsics.to_matrix(dtype, dev)
    proj1 = k @ torch.cat([r1, t1[:, None]], dim=-1)
    proj2 = k @ torch.cat([r2, t2[:, None]], dim=-1)

    def rows(proj, pts):
        return torch.stack([pts[:, 0, None] * proj[None, 2] - proj[None, 0],
                            pts[:, 1, None] * proj[None, 2] - proj[None, 1]], dim=1)  # [N, 2, 4]

    a = torch.cat([rows(proj1, p1), rows(proj2, p2)], dim=1)  # [N, 4, 4]
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-12)
    xh = smallest_eigvec(a.transpose(-1, -2) @ a, iters=3, block=1)  # [N, 4]

    w = xh[:, 3]
    w_ok = w.abs() > 1e-10
    xyz = xh[:, :3] / torch.where(w_ok, w, torch.ones_like(w))[:, None]
    z1 = xyz @ r1[2] + t1[2]
    z2 = xyz @ r2[2] + t2[2]
    valid = w_ok & (z1 > 0.0) & (z2 > 0.0)

    if enforce_reproj:
        def reproj_err(r, t, px):
            return torch.linalg.vector_norm(intrinsics.project(xyz @ r.T + t) - px, dim=-1)

        valid = valid & (torch.maximum(reproj_err(r1, t1, p1), reproj_err(r2, t2, p2)) <= max_reproj_error)

    if enforce_parallax:
        ray1 = xyz + r1.T @ t1  # xyz - c1, c1 = -R1^T t1
        ray2 = xyz + r2.T @ t2
        cos = torch.sum(ray1 * ray2, dim=-1) / torch.clamp(
            torch.linalg.vector_norm(ray1, dim=-1) * torch.linalg.vector_norm(ray2, dim=-1), min=1e-12)
        valid = valid & (torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0))) >= min_parallax_deg)

    return xyz, valid


class Triangulator:
    """The reference's triangulator API with with_* setters. triangulate_batch
    runs on its inputs' device; the eager `triangulate` (numpy in, f64) on
    `device` ("cuda" when None)."""

    def __init__(self, intrinsics: CameraIntrinsics, device=None):
        self.intrinsics = intrinsics
        self.device = resolve_device(device)
        self.min_parallax_deg = 1.0
        self.max_reproj_error = 4.0
        self.enforce_parallax = False
        self.enforce_reproj = False

    def with_min_parallax(self, deg: float) -> "Triangulator":
        self.min_parallax_deg = deg
        return self

    def with_max_reproj_error(self, error: float) -> "Triangulator":
        self.max_reproj_error = error
        return self

    def with_enforcement(self, parallax: bool = True, reproj: bool = True) -> "Triangulator":
        """Opt into the filters the reference declares but skips."""
        self.enforce_parallax = parallax
        self.enforce_reproj = reproj
        return self

    def triangulate_batch(self, pose1, pose2, points1, points2, descriptors=None, mask=None) -> MapPoints:
        """Fixed-shape MapPoints with a validity mask."""
        xyz, valid = triangulate_points(
            self.intrinsics, pose1, pose2, points1, points2,
            min_parallax_deg=self.min_parallax_deg, max_reproj_error=self.max_reproj_error,
            enforce_parallax=self.enforce_parallax, enforce_reproj=self.enforce_reproj,
        )
        if mask is not None:
            valid = valid & torch.as_tensor(mask, dtype=torch.bool, device=valid.device)
        if descriptors is None:
            desc = torch.zeros((xyz.shape[0], 32), dtype=torch.uint8, device=xyz.device)
        else:
            desc = torch.as_tensor(descriptors).to(device=xyz.device, dtype=torch.uint8)
        return MapPoints(positions=xyz, descriptors=desc, valid=valid)

    def triangulate(self, pose1, pose2, points1, points2, descriptors=None):
        """A list of MapPoint for the accepted correspondences, solved at
        f64 (descriptor row i attaches to point i)."""
        points1 = np.asarray(points1, np.float64)
        points2 = np.asarray(points2, np.float64)
        if points1.shape != points2.shape:
            raise ValueError("Point arrays must have the same length")
        if points1.shape[0] == 0:
            return []
        pose1 = tuple(np.asarray(p, np.float64) for p in pose1)
        pose2 = tuple(np.asarray(p, np.float64) for p in pose2)
        batch = self.triangulate_batch(pose1, pose2, torch.from_numpy(points1).to(self.device),
                                       torch.from_numpy(points2).to(self.device))
        xyz = batch.positions.cpu().numpy()
        out = []
        for i in np.nonzero(batch.valid.cpu().numpy())[0]:
            mp = MapPoint(position=xyz[i], id=int(i))
            if descriptors is not None:
                mp.descriptor = np.asarray(descriptors)[i]
            out.append(mp)
        return out
