"""Planar two-view geometry: homography RANSAC and the calibrated
decomposition (counterpart of slamtpu/ops/homography.py).

The essential-matrix solvers are degenerate on a (near-)planar scene.
ORB-SLAM's remedy is to fit a homography beside the essential matrix and
take the pose from H when the plane has the stronger support
(odometry/pose.py, `RansacConfig.homography_fallback`).

The 4-point DLT null vector comes from `epipolar.smallest_eigvec`; the
decomposition is Ma-Soatto's Algorithm 5.2 (H = R + t n^T / d in
normalized coordinates) over the closed-form symmetric 3x3
eigendecomposition. Everything is batched over leading dimensions and
branch-free. Determinants are summed in the reference's order (the six
triple products of `_det3`), so the two packages round alike.
"""

from __future__ import annotations

import math

import torch

from .epipolar import _homogeneous, cheirality_counts, smallest_eigvec
from .five_point import _topk_first

__all__ = [
    "four_point_homography",
    "homography_transfer_error",
    "ransac_homography",
    "decompose_homography",
    "recover_pose_from_homography",
]


def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinant as the sum of its six triple products."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def four_point_homography(pts1, pts2, weights=None):
    """DLT homography from [..., N, 2] normalized correspondences (N >= 4),
    optionally row-weighted: [..., 3, 3] H with x2 ~ H x1 (up to scale)."""
    x1 = _homogeneous(pts1)
    u2, v2 = pts2[..., 0], pts2[..., 1]
    zeros = torch.zeros_like(x1)
    row_a = torch.cat([x1, zeros, -u2[..., None] * x1], dim=-1)  # [..., N, 9]
    row_b = torch.cat([zeros, x1, -v2[..., None] * x1], dim=-1)
    a = torch.cat([row_a, row_b], dim=-2)  # [..., 2N, 9]
    if weights is not None:
        a = a * torch.cat([weights, weights], dim=-1)[..., :, None]
    h = smallest_eigvec(a.transpose(-1, -2) @ a)
    return h.reshape(*h.shape[:-1], 3, 3)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det, det floored at 1e-18)."""
    det = _det3(m)
    adj = torch.stack([
        torch.linalg.cross(m[..., 1, :], m[..., 2, :], dim=-1),
        torch.linalg.cross(m[..., 2, :], m[..., 0, :], dim=-1),
        torch.linalg.cross(m[..., 0, :], m[..., 1, :], dim=-1),
    ], dim=-1)
    det_safe = torch.where(det.abs() < 1e-18, torch.full_like(det, 1e-18), det)
    return adj / det_safe[..., None, None]


def homography_transfer_error(h, pts1, pts2):
    """Symmetric transfer error (squared, normalized units), [..., N]."""
    x1, x2 = _homogeneous(pts1), _homogeneous(pts2)

    def transfer(hm, xs):
        y = xs @ hm.transpose(-1, -2)
        w = y[..., 2]
        w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
        return y[..., :2] / w_safe[..., None]

    fwd = torch.sum((transfer(h, x1) - pts2) ** 2, dim=-1)
    bwd = torch.sum((transfer(_inv3(h), x2) - pts1) ** 2, dim=-1)
    return fwd + bwd


def ransac_homography(pts1, pts2, mask=None, threshold_norm=1.0 / 700.0, iters: int = 256,
                      refine_rounds: int = 2, sigma=None, uniforms=None, generator=None):
    """Fixed-iteration homography RANSAC on 4-point samples, batched over
    leading dimensions: pts [..., N, 2] -> (H [..., 3, 3], inliers [..., N],
    num_inliers [...] int32).

    Samples are the top 4 of `uniforms` [..., iters, N] (drawn with
    `generator` when None) over the live rows. The symmetric transfer
    threshold is 2 * threshold^2, widened per point by sigma^2 as the
    essential path's band is. The winner is refitted `refine_rounds` times
    on its inliers (kept when fewer than 4 remain).
    """
    batch, n = pts1.shape[:-2], pts1.shape[-2]
    dtype, device = pts1.dtype, pts1.device
    if mask is None:
        mask = torch.ones(batch + (n,), dtype=torch.bool, device=device)
    thresh = 2.0 * torch.as_tensor(threshold_norm, dtype=dtype, device=device) ** 2
    if sigma is not None:
        thresh = thresh * sigma.to(dtype) ** 2
    thresh_row = thresh[..., None, :] if thresh.dim() else thresh

    if uniforms is None:
        uniforms = torch.rand(batch + (iters, n), generator=generator, device=device)
    u = uniforms.to(torch.float32)
    u = torch.where(mask[..., None, :], u, torch.full_like(u, float("-inf")))
    idx = _topk_first(u, 4)  # [..., iters, 4]
    gather = idx.reshape(*batch, -1)[..., None].expand(*batch, idx.shape[-2] * 4, 2)
    s1 = torch.gather(pts1, -2, gather).reshape(*idx.shape, 2)
    s2 = torch.gather(pts2, -2, gather).reshape(*idx.shape, 2)

    hyps = four_point_homography(s1, s2)  # [..., iters, 3, 3]
    errors = homography_transfer_error(hyps, pts1[..., None, :, :], pts2[..., None, :, :])
    inlier_mat = (errors < thresh_row) & mask[..., None, :]
    counts = torch.sum(inlier_mat, dim=-1, dtype=torch.int32)
    best = torch.argmax(counts, dim=-1)  # first maximum
    h = torch.gather(hyps, -3, best[..., None, None, None].expand(*batch, 1, 3, 3))[..., 0, :, :]
    inliers = torch.gather(inlier_mat, -2, best[..., None, None].expand(*batch, 1, n))[..., 0, :]

    for _ in range(refine_rounds):
        enough = torch.sum(inliers, dim=-1) >= 4
        h_new = four_point_homography(pts1, pts2, weights=(inliers & mask).to(dtype))
        h = torch.where(enough[..., None, None], h_new, h)
        inliers = (homography_transfer_error(h, pts1, pts2) < thresh) & mask
    return h, inliers, torch.sum(inliers, dim=-1, dtype=torch.int32)


def _eig3_full(s: torch.Tensor):
    """Closed-form eigendecomposition of symmetric [..., 3, 3]: eigenvalues
    descending [..., 3] and eigenvectors as columns [..., 3, 3] (Cardano,
    then annihilating products; the middle vector is v3 x v1). Assumes
    distinct eigenvalues, as H^T H has away from a pure rotation."""
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    q = s.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    s_q = s - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(s_q * s_q, dim=(-2, -1)) / 6.0, min=1e-30))
    r = torch.clamp(_det3(s_q / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3

    def vec_for(lb, lc):
        m = (s - lb[..., None, None] * eye) @ (s - lc[..., None, None] * eye)
        col = torch.argmax(torch.linalg.vector_norm(m, dim=-2), dim=-1)
        v = torch.gather(m, -1, col[..., None, None].expand(*m.shape[:-1], 1))[..., 0]
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)

    v1 = vec_for(lam2, lam3)
    v3 = vec_for(lam1, lam2)
    v2 = torch.linalg.cross(v3, v1, dim=-1)
    return torch.stack([lam1, lam2, lam3], dim=-1), torch.stack([v1, v2, v3], dim=-1)


def decompose_homography(h):
    """Calibrated H = R + t n^T / d -> the four (R, t/d, n) candidates:
    rs [..., 4, 3, 3], ts [..., 4, 3] (scaled by 1/d), ns [..., 4, 3].
    H is normalized so that its middle singular value is 1 and signed so
    that its determinant is positive."""
    vals, _ = _eig3_full(h.transpose(-1, -2) @ h)
    h = h / torch.sqrt(torch.clamp(vals[..., 1], min=1e-30))[..., None, None]
    sign = torch.sign(_det3(h))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    h = h * sign[..., None, None]

    vals, vecs = _eig3_full(h.transpose(-1, -2) @ h)
    l1 = torch.clamp(vals[..., 0], min=1.0 + 1e-12)
    l3 = torch.clamp(vals[..., 2], max=1.0 - 1e-12)
    v1, v2, v3 = vecs[..., :, 0], vecs[..., :, 1], vecs[..., :, 2]
    a = torch.sqrt(torch.clamp(1.0 - l3, min=0.0))[..., None]
    b = torch.sqrt(torch.clamp(l1 - 1.0, min=0.0))[..., None]
    denom = torch.sqrt(torch.clamp(l1 - l3, min=1e-30))[..., None]
    u1 = (a * v1 + b * v3) / denom
    u2 = (a * v1 - b * v3) / denom

    def solution(u):
        n = torch.linalg.cross(v2, u, dim=-1)
        big_u = torch.stack([v2, u, n], dim=-1)
        hv2 = (h @ v2[..., None])[..., 0]
        hu = (h @ u[..., None])[..., 0]
        big_w = torch.stack([hv2, hu, torch.linalg.cross(hv2, hu, dim=-1)], dim=-1)
        r = big_w @ big_u.transpose(-1, -2)
        return r, ((h - r) @ n[..., None])[..., 0], n

    r1, t1, n1 = solution(u1)
    r2, t2, n2 = solution(u2)
    # The (-t, -n) twins: the same R with the plane on the other side.
    return (torch.stack([r1, r1, r2, r2], dim=-3), torch.stack([t1, -t1, t2, -t2], dim=-2),
            torch.stack([n1, -n1, n2, -n2], dim=-2))


def recover_pose_from_homography(h, pts1, pts2, mask=None):
    """The physical (R, t) of H by cheirality vote, among the candidates
    whose plane normal faces camera 1 (n_z > 0): (R [..., 3, 3], unit
    t [..., 3], votes [..., 4]); first candidate on ties."""
    rs, ts, ns = decompose_homography(h)
    ts_unit = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-18)
    votes = cheirality_counts(rs, ts_unit, pts1[..., None, :, :], pts2[..., None, :, :],
                              mask=None if mask is None else mask[..., None, :])
    votes = torch.where(ns[..., 2] > 0, votes, torch.zeros_like(votes))
    best = torch.argmax(votes, dim=-1)
    r = torch.gather(rs, -3, best[..., None, None, None].expand(*rs.shape[:-3], 1, 3, 3))[..., 0, :, :]
    t = torch.gather(ts_unit, -2, best[..., None, None].expand(*ts.shape[:-2], 1, 3))[..., 0, :]
    return r, t, votes
