"""Two-view epipolar geometry (counterpart of slamtpu/ops/epipolar.py):
Sampson error, the linear 8-point estimate, essential-matrix projection and
decomposition, midpoint triangulation and the cheirality vote.

Conventions: points are NORMALIZED image coordinates [..., N, 2]; the
relative pose maps view 1 to view 2, p2 = R p1 + t; E = [t]x R and
x2^T E x1 = 0. Everything broadcasts over leading batch dimensions and is
branch-free. Full-fp32 matmuls are the package default (TF32 off).
"""

from __future__ import annotations

import math

import torch

from ..utils.graphs import device_constant

__all__ = [
    "sampson_parts",
    "sampson_error",
    "smallest_eigvec",
    "eight_point",
    "enforce_rank2",
    "decompose_essential",
    "triangulate_two_view",
    "cheirality_counts",
    "recover_pose_from_essential",
]


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of [..., 3, 3]."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _eig3_smallest(s: torch.Tensor) -> torch.Tensor:
    """Closed-form smallest eigenvector of symmetric [..., 3, 3]: Cardano
    eigenvalues, then the largest-norm column of (S - l1 I)(S - l2 I);
    isotropic S falls back to e0."""
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    q = s.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    s_q = s - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(s_q * s_q, dim=(-2, -1)) / 6.0, min=0.0))
    p_safe = torch.where(p > 0, p, torch.ones_like(p))
    r = torch.clamp(_det3(s_q / p_safe[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    m = (s - lam1[..., None, None] * eye) @ (s - lam2[..., None, None] * eye)
    col = torch.argmax(torch.linalg.vector_norm(m, dim=-2), dim=-1)
    v = torch.gather(m, -1, col[..., None, None].expand(*m.shape[:-1], 1))[..., 0]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., 0].fill_(1.0)  # a fill kernel also where the slice is 0-d (a copy from the host there)
    return torch.where(vn > 1e-20, v / torch.clamp(vn, min=1e-30), fallback)


def _inv3x3_adj(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    adj = torch.stack(
        [torch.stack([c00, c10, c20], dim=-1), torch.stack([c01, c11, c21], dim=-1),
         torch.stack([c02, c12, c22], dim=-1)],
        dim=-2,
    )
    return adj / det[..., None, None]


def _inv4x4_spd(m: torch.Tensor) -> torch.Tensor:
    """Batched SPD 4x4 inverse by the block-Schur identity over the 3x3
    adjugate: m = [[A, b], [b^T, d]], S = d - b^T A^-1 b, u = A^-1 b,
    inv = [[A^-1 + u u^T / S, -u / S], [-u^T / S, 1 / S]]."""
    a_inv = _inv3x3_adj(m[..., :3, :3])
    b = m[..., :3, 3]
    u = (a_inv @ b[..., None])[..., 0]
    s_inv = 1.0 / (m[..., 3, 3] - torch.sum(b * u, dim=-1))
    top_left = a_inv + s_inv[..., None, None] * u[..., :, None] * u[..., None, :]
    top_right = -s_inv[..., None] * u
    top = torch.cat([top_left, top_right[..., :, None]], dim=-1)
    return torch.cat([top, torch.cat([top_right, s_inv[..., None]], dim=-1)[..., None, :]], dim=-2)


def smallest_eigvec(ata: torch.Tensor, iters: int = 2, method: str = "chol", block: int = 3):
    """Unit eigenvector of the smallest eigenvalue of PSD [..., D, D].

    method="chol": inverse iteration on (A + eps tr(A) I). 4x4 systems use
    its closed-form inverse, larger ones one Cholesky factor. block=3 (the
    default) iterates a 3-column subspace and finishes with a closed-form
    3x3 Rayleigh-Ritz step, which resolves the near-null cluster of
    small-motion 8-point systems; block=1 iterates the single constant
    start vector d**-0.5, enough for a 1-D null space (DLT triangulation).
    method="eigh": exact reference path.
    """
    if method == "eigh":
        return torch.linalg.eigh(ata)[1][..., :, 0]
    if block not in (1, 3):
        raise ValueError("block must be 1 or 3")
    d = ata.shape[-1]
    eye = torch.eye(d, dtype=ata.dtype, device=ata.device)
    eps = (1e-6 if ata.dtype == torch.float32 else 1e-12) * ata.diagonal(dim1=-2, dim2=-1).sum(-1)
    eps = torch.where(eps > 0, eps, torch.ones_like(eps))[..., None, None]
    shifted = ata + eps * eye
    if d == 4:
        a_inv = _inv4x4_spd(shifted)

        def solve(rhs):
            return a_inv @ rhs
    else:
        chol = torch.linalg.cholesky_ex(shifted)[0]

        def solve(rhs):
            y = torch.linalg.solve_triangular(chol, rhs, upper=False)
            return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)

    if block == 1:
        v1 = torch.full((*ata.shape[:-1], 1), d ** -0.5, dtype=ata.dtype, device=ata.device)
        for _ in range(iters):
            v1 = solve(v1)
            v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-2, keepdim=True), min=1e-30)
        return v1[..., 0]

    def orthonormalize(v):
        cols = []
        for j in range(block):
            c = v[..., j]
            for prev in cols:
                c = c - torch.sum(c * prev, dim=-1, keepdim=True) * prev
            cols.append(c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-30))
        return torch.stack(cols, dim=-1)

    v = eye[:, :block].expand(*ata.shape[:-2], d, block)
    for _ in range(iters):
        v = orthonormalize(solve(v))
    s = v.transpose(-1, -2) @ (ata @ v)
    e = (v @ _eig3_smallest(s)[..., None])[..., 0]
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-30)


def eight_point(pts1, pts2, weights=None, method: str = "chol", iters: int = 2):
    """Linear 8-point estimate of E from [..., N, 2] pairs: the unit
    minimizer of |A e| over the (optionally row-weighted) design matrix."""
    x1 = _homogeneous(pts1)
    x2 = _homogeneous(pts2)
    a = (x2[..., :, :, None] * x1[..., :, None, :]).reshape(*x1.shape[:-1], 9)
    if weights is not None:
        a = a * weights[..., :, None]
    e = smallest_eigvec(a.transpose(-1, -2) @ a, iters=iters, method=method)
    return e.reshape(*e.shape[:-1], 3, 3)


def sampson_parts(essential, pts1, pts2):
    """(x2^T E x1, |(E x1)_{0,1}|^2 + |(E^T x2)_{0,1}|^2) per pair.

    essential [..., 3, 3] broadcasts against points [..., N, 2]; written
    out elementwise so a batch of hypotheses never materializes a copy of
    the points per hypothesis.
    """
    u1, v1 = pts1[..., 0], pts1[..., 1]
    u2, v2 = pts2[..., 0], pts2[..., 1]
    e = [[essential[..., i, j][..., None] for j in range(3)] for i in range(3)]
    ex1 = [e[i][0] * u1 + e[i][1] * v1 + e[i][2] for i in range(3)]
    etx2 = [e[0][j] * u2 + e[1][j] * v2 + e[2][j] for j in range(2)]
    num = u2 * ex1[0] + v2 * ex1[1] + ex1[2]
    denom = ex1[0] * ex1[0] + ex1[1] * ex1[1] + etx2[0] * etx2[0] + etx2[1] * etx2[1]
    return num, denom


def sampson_error(essential, pts1, pts2):
    """First-order geometric (Sampson) error of x2^T E x1 = 0, per pair."""
    num, denom = sampson_parts(essential, pts1, pts2)
    return num * num / torch.clamp(denom, min=1e-18)


def _essential_frames(essential):
    """Closed-form near-SVD frames of an (approximately) essential matrix:
    (u1, u2, u3, v1, v2, v3, s1, s2), with v3 the smallest eigenvector of
    E^T E and (v1, v2) any orthonormal basis of its complement."""
    v3 = _eig3_smallest(essential.transpose(-1, -2) @ essential)
    probe = torch.nn.functional.one_hot(torch.argmin(v3.abs(), dim=-1), 3).to(v3.dtype)
    v1 = torch.linalg.cross(v3, probe, dim=-1)
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True), min=1e-30)
    v2 = torch.linalg.cross(v3, v1, dim=-1)
    ev1 = (essential @ v1[..., None])[..., 0]
    ev2 = (essential @ v2[..., None])[..., 0]
    s1 = torch.linalg.vector_norm(ev1, dim=-1, keepdim=True)
    u1 = ev1 / torch.clamp(s1, min=1e-30)
    w = ev2 - torch.sum(u1 * ev2, dim=-1, keepdim=True) * u1
    s2 = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    u2 = w / torch.clamp(s2, min=1e-30)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    return u1, u2, u3, v1, v2, v3, s1[..., 0], s2[..., 0]


def enforce_rank2(essential):
    """Project E onto the essential manifold: singular values (s, s, 0)."""
    u1, u2, _, v1, v2, _, s1, s2 = _essential_frames(essential)
    mean = 0.5 * (s1 + s2)
    return mean[..., None, None] * (
        u1[..., :, None] * v1[..., None, :] + u2[..., :, None] * v2[..., None, :]
    )


def decompose_essential(essential):
    """E -> the four (R, t) candidates ((R1,t), (R1,-t), (R2,t), (R2,-t)):
    rs [..., 4, 3, 3], ts [..., 4, 3] with |t| = 1 (closed-form W-trick)."""
    u1, u2, u3, v1, v2, v3, _, _ = _essential_frames(essential)
    u = torch.stack([u1, u2, u3], dim=-1)
    vt = torch.stack([v1, v2, v3], dim=-2)
    w = device_constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), essential.dtype, essential.device)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u3 / torch.clamp(torch.linalg.vector_norm(u3, dim=-1, keepdim=True), min=1e-18)
    return torch.stack([r1, r1, r2, r2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def triangulate_two_view(rotation, translation, pts1, pts2):
    """Closed-form two-ray midpoint triangulation in view-1 coordinates:
    [..., N, 2] normalized pairs -> [..., N, 3]."""
    d1 = _homogeneous(pts1)
    d2 = _homogeneous(pts2) @ rotation  # R^T d2, per point
    c = -(translation[..., None, :] @ rotation)  # camera-2 center -R^T t, [..., 1, 3]
    a11 = torch.sum(d1 * d1, dim=-1)
    a12 = -torch.sum(d1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    b1 = torch.sum(d1 * c, dim=-1)
    b2 = -torch.sum(d2 * c, dim=-1)
    det = a11 * a22 - a12 * a12
    det_safe = torch.where(det.abs() < 1e-18, torch.full_like(det, 1e-18), det)
    z1 = (b1 * a22 - a12 * b2) / det_safe
    z2 = (a11 * b2 - a12 * b1) / det_safe
    return 0.5 * (z1[..., None] * d1 + (c + z2[..., None] * d2))


def cheirality_counts(rotation, translation, pts1, pts2, mask=None, max_depth=50.0):
    """Correspondences in front of BOTH cameras (and nearer than
    `max_depth`) for a candidate pose — OpenCV recoverPose's vote."""
    points = triangulate_two_view(rotation, translation, pts1, pts2)
    z1 = points[..., 2]
    z2 = (points @ rotation.transpose(-1, -2))[..., 2] + translation[..., None, 2]
    ok = (z1 > 0) & (z2 > 0) & (z1 < max_depth) & (z2 < max_depth)
    if mask is not None:
        ok = ok & mask
    return torch.sum(ok, dim=-1, dtype=torch.int32)


def recover_pose_from_essential(essential, pts1, pts2, mask=None):
    """The (R, t) candidate with the best cheirality vote (first on ties):
    (R [..., 3, 3], t [..., 3], votes [..., 4])."""
    rs, ts = decompose_essential(essential)
    votes = cheirality_counts(
        rs, ts, pts1[..., None, :, :], pts2[..., None, :, :],
        mask=None if mask is None else mask[..., None, :],
    )
    best = torch.argmax(votes, dim=-1)
    r = torch.gather(rs, -3, best[..., None, None, None].expand(*rs.shape[:-3], 1, 3, 3))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(*ts.shape[:-2], 1, 3))[..., 0, :]
    return r, t, votes
