"""Sparse bundle adjustment: Levenberg-Marquardt with Schur elimination
(counterpart of slamtpu/mapping/bundle_adjustment.py).

Per-observation residuals and analytic Jacobians are batched tensor math;
segment sums build the [P, 6, 6] / [L, 3, 3] block diagonals and the
per-observation [M, 6, 3] coupling blocks; the Schur complement with its
pose-pose coupling is assembled over landmark chunks (one matmul per chunk)
or, for long trajectories, over co-observing pose pairs; the reduced pose
system is solved densely and the points are back-substituted. The LM loop
is a Python loop that reads one flag per iteration; the set-up and each
iteration are regions of utils/graphs.py, which replay as CUDA graphs on
the card.

Numerics kept from the JAX package: Huber delta 2 px with a consistent IRLS
weight min(1, delta/|r|) on both sides; damping lam * 10 on the pose and
the landmark diagonals; exact gauge fix (pose 0 pinned after reduction) and
frozen poses (`pose_mask`) as identity rows; a Jacobian-only depth floor of
1e-3; a divergent step (error > 1.5x, or not finite) is rolled back and
stops the loop; convergence on |d err| < min_error_change; a state with no
valid projection scores +inf.

Segment sums (`segment_method`) are chosen by tensor device under "auto":
scatter-adds (`index_add_`) on the CPU, and on CUDA, where float
scatter-adds are atomic and their order (so the rounding) varies from run
to run, the gather mode: per-landmark observer tables built once per solve
and summed in a fixed order, so a CUDA solve repeats bit for bit. The
"coobs" Schur assembly keeps its pose-pair scatter-add and is therefore
not deterministic on CUDA.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..odometry.camera import CameraIntrinsics
from ..ops.five_point import _solve_pivoted
from ..ops.lie import hat, so3_exp
from ..utils import graphs
from ..utils.metrics import count, span

__all__ = ["Observation", "ObservationBatch", "BaConfig", "BundleAdjuster", "ba_solve", "compute_total_error",
           "pose_point_jacobians"]

# Largest indicator matrix ([L, M] or [P, M] elements) the one-hot
# reductions may build; past it they use tables or scatter-adds.
ONEHOT_CAP = 40_000_000
# Past this many observers of one landmark the [L, K] gather table is mostly
# padding, and "auto" on CUDA keeps the one-hot / scatter paths.
_GATHER_MAX_K = 256


@dataclasses.dataclass
class Observation:
    """One observation on the host."""

    keyframe_idx: int
    point_idx: int
    pixel: np.ndarray  # [2]


class ObservationBatch(NamedTuple):
    """Fixed-shape observation set."""

    kf_idx: torch.Tensor  # [M] int64
    pt_idx: torch.Tensor  # [M] int64
    pixels: torch.Tensor  # [M, 2]
    mask: torch.Tensor  # [M] bool

    @staticmethod
    def from_list(observations, dtype=torch.float64, device=None) -> "ObservationBatch":
        if not observations:
            return ObservationBatch(torch.zeros((0,), dtype=torch.int64, device=device),
                                    torch.zeros((0,), dtype=torch.int64, device=device),
                                    torch.zeros((0, 2), dtype=dtype, device=device),
                                    torch.zeros((0,), dtype=torch.bool, device=device))
        return ObservationBatch(
            kf_idx=torch.tensor([o.keyframe_idx for o in observations], dtype=torch.int64, device=device),
            pt_idx=torch.tensor([o.point_idx for o in observations], dtype=torch.int64, device=device),
            pixels=torch.tensor(np.stack([np.asarray(o.pixel, float) for o in observations]), dtype=dtype,
                                device=device),
            mask=torch.ones((len(observations),), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass(frozen=True)
class BaConfig:
    max_iterations: int = 10
    lam: float = 1e-3
    min_error_change: float = 1e-6
    huber_delta: float = 2.0


def _inv3x3(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse; the blocks here are
    damped SPD, so the determinant stays away from zero."""
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


def _huber_loss(r_norm, delta):
    """r^2 below delta, 2 delta |r| - delta^2 above."""
    return torch.where(r_norm <= delta, r_norm * r_norm, 2.0 * delta * r_norm - delta * delta)


def _project_and_residual(intrinsics, rotations, translations, points, obs):
    """Per-observation camera point, safe depth, residual and validity
    (masked and z > 1e-6)."""
    p_cam = (rotations[obs.kf_idx] @ points[obs.pt_idx][..., None])[..., 0] + translations[obs.kf_idx]
    z = p_cam[:, 2]
    valid = obs.mask & (z > 1e-6)
    z_safe = torch.where(valid, z, torch.ones_like(z))
    u = intrinsics.fx * (p_cam[:, 0] / z_safe) + intrinsics.cx
    v = intrinsics.fy * (p_cam[:, 1] / z_safe) + intrinsics.cy
    return p_cam, z_safe, torch.stack([u, v], dim=-1) - obs.pixels, valid


def compute_total_error(intrinsics, rotations, translations, points, obs, huber_delta=2.0):
    """Sum of Huber losses over valid projections (0-d tensor).

    A state with no valid projection among masked observations scores +inf,
    not 0: an update that throws every landmark behind the camera (or a NaN
    pose) must count as divergence, not as a perfect fit. A problem with no
    masked observation scores 0.
    """
    _, _, residual, valid = _project_and_residual(intrinsics, rotations, translations, points, obs)
    r_norm = torch.linalg.vector_norm(residual, dim=-1)
    total = torch.sum(torch.where(valid, _huber_loss(r_norm, huber_delta), torch.zeros_like(r_norm)))
    has_any = valid.any() | ~obs.mask.any()
    return torch.where(has_any, total, torch.full_like(total, float("inf")))


def pose_point_jacobians(intrinsics, rotation, translation, point):
    """Analytic Jacobians of one observation's pixel: (j_pose [2, 6],
    j_point [2, 3]); left-perturbation SE(3), d p_cam / d omega = -[R X]x."""
    rotation = torch.as_tensor(rotation)
    dtype = rotation.dtype
    translation = torch.as_tensor(translation, dtype=dtype)
    point = torch.as_tensor(point, dtype=dtype)
    rx = rotation @ point
    x, y, z = (rx + translation).unbind()
    zero = torch.zeros((), dtype=dtype)
    j_proj = torch.stack([torch.stack([intrinsics.fx / z, zero, -intrinsics.fx * x / (z * z)]),
                          torch.stack([zero, intrinsics.fy / z, -intrinsics.fy * y / (z * z)])])
    return torch.cat([-j_proj @ hat(rx), j_proj], dim=1), j_proj @ rotation


def _segment_ranks(keys, n_segments: int, valid):
    """Stable sort of the observations by segment (invalid ones keyed past
    the end): (order, sorted keys, rank of each sorted observation within
    its segment)."""
    keyed = torch.where(valid, keys, n_segments)
    order = torch.argsort(keyed, stable=True)
    key_sorted = keyed[order]
    seg_starts = torch.searchsorted(key_sorted, torch.arange(n_segments, device=keys.device))
    rank_sorted = torch.arange(keys.shape[0], device=keys.device) - seg_starts[torch.clamp(key_sorted, 0, n_segments - 1)]
    return order, key_sorted, rank_sorted


def _observer_table(keys, n_segments: int, width: int, valid):
    """[n_segments, width] table of observation indices per segment (M =
    padding), in index order within a segment; ranks >= width are dropped."""
    order, key_sorted, rank_sorted = _segment_ranks(keys, n_segments, valid)
    in_tbl = (key_sorted < n_segments) & (rank_sorted < width)
    tbl = torch.full((n_segments + 1, width), keys.shape[0], dtype=torch.int64, device=keys.device)
    tbl[torch.where(in_tbl, key_sorted, n_segments), torch.clamp(rank_sorted, 0, width - 1)] = order
    return tbl[:n_segments]


def _gather_sum(tbl):
    """Segment sum through a table from _observer_table: one gather and a
    fixed-order sum over the table's width."""

    def seg(v):
        vp = torch.cat([v, torch.zeros_like(v[:1])], dim=0)
        return torch.sum(vp[tbl], dim=1)

    return seg


def _rows_to_mat(blocks, rows: int, cols: int, n_a: int, n_b: int):
    """[n_a, n_b, rows, cols] blocks -> [n_a * rows, n_b * cols] matrix."""
    return blocks.permute(0, 2, 1, 3).reshape(n_a * rows, n_b * cols)


class _Plan(NamedTuple):
    """A solve's Python values: all that its regions read besides tensors,
    and the static part of their graph keys."""

    intrinsics: CameraIntrinsics
    config: BaConfig
    fix_first_pose: bool
    schur_method: str  # "dense" or "coobs"
    coobs_k: int
    segments: str  # landmark sums: "gather", "onehot" or "scatter"
    gather_k_pt: int | None
    pose_sums: str  # "onehot", "table" or "scatter"
    pose_width: int  # the per-pose table's width ("table"), else 0
    landmark_chunk: int


def _plan(intrinsics, config, fix_first_pose, dev, n_poses, n_points, m, landmark_chunk, segment_method,
          schur_method, coobs_k, gather_k_pt, busiest_pose) -> _Plan:
    """Resolve a solve's segment sums and Schur assembly (see ba_solve);
    busiest_pose() gives the observations of the busiest pose, asked for
    only where a per-pose table is needed."""
    if schur_method not in ("dense", "coobs"):
        raise ValueError(f"unknown schur_method {schur_method!r}")
    if segment_method == "auto":
        segment_method = "scatter" if dev.type != "cuda" else "onehot" if gather_k_pt is None else "gather"
    elif segment_method not in ("onehot", "scatter", "gather"):
        raise ValueError(f"unknown segment_method {segment_method!r}")
    if segment_method == "gather" and (gather_k_pt is None or gather_k_pt < 1):
        raise ValueError("segment_method='gather' requires gather_k_pt >= 1")
    if segment_method == "onehot" and (n_points * m > ONEHOT_CAP or n_poses * m > ONEHOT_CAP):
        segment_method = "scatter"
    pose_sums, pose_width = "scatter", 0
    if segment_method == "onehot" or (segment_method == "gather" and n_poses * m <= ONEHOT_CAP):
        pose_sums = "onehot"
    elif segment_method == "gather":
        # Past the cap: a per-pose observer table, as wide as the busiest pose.
        pose_sums, pose_width = "table", busiest_pose()
    return _Plan(intrinsics, config, fix_first_pose, schur_method, coobs_k, segment_method,
                 gather_k_pt if segment_method == "gather" else None, pose_sums, pose_width, landmark_chunk)


def _lm_setup(rot, trans, pts, kf_idx, pt_idx, pixels, mask, *, plan: _Plan):
    """Region `ba.setup` of a solve: its tables and the start error.
    Returns (landmark table, pose table, pose one-hot, landmark one-hot,
    eye3, eye6, pose indices, error), None where the plan sums otherwise."""
    dtype, dev = rot.dtype, rot.device
    n_poses, n_points = rot.shape[0], pts.shape[0]
    tbl_pt = tbl_pose = oh_pose = oh_pt = None
    if plan.segments == "gather":
        tbl_pt = _observer_table(pt_idx, n_points, plan.gather_k_pt, mask)
    if plan.pose_sums == "onehot":
        oh_pose = (kf_idx[None, :] == torch.arange(n_poses, device=dev)[:, None]).to(dtype)
    elif plan.pose_sums == "table":
        tbl_pose = _observer_table(kf_idx, n_poses, plan.pose_width, torch.ones_like(mask))
    if plan.segments == "onehot":
        oh_pt = (pt_idx[None, :] == torch.arange(n_points, device=dev)[:, None]).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag = torch.arange(n_poses, device=dev)
    err = compute_total_error(plan.intrinsics, rot, trans, pts, ObservationBatch(kf_idx, pt_idx, pixels, mask),
                              plan.config.huber_delta)
    return tbl_pt, tbl_pose, oh_pose, oh_pt, eye3, eye6, diag, err


def _schur_offdiag(plan: _Plan, obs, u_pl, h_ll_inv, w, coobs_rank, tbl_pt, oh_pose, oh_pt, diag, n_poses):
    """sum over landmarks of W Hll^-1 W^T, [P, P, 6, 6]."""
    dtype, dev = u_pl.dtype, u_pl.device
    n_points, m = h_ll_inv.shape[0], obs.mask.shape[0]
    if plan.schur_method == "coobs":
        # Scatter each live observation's coupling block into its
        # landmark's observer slot, form the K^2 per-landmark pair
        # products, and sum them onto (i1, i2) pose-pair buckets.
        coobs_k = plan.coobs_k
        pt_safe = torch.where(w > 0, obs.pt_idx, n_points)
        rank = torch.clamp(coobs_rank, 0, coobs_k - 1)
        wjk = torch.zeros((n_points + 1, coobs_k, 6, 3), dtype=dtype, device=dev)
        wjk[pt_safe, rank] = u_pl
        wjk = wjk[:n_points]
        pjk = torch.full((n_points + 1, coobs_k), n_poses, dtype=torch.int64, device=dev)
        pjk[pt_safe, rank] = obs.kf_idx
        pjk = pjk[:n_points]
        tjk = torch.einsum("lkab,lbc->lkac", wjk, h_ll_inv)
        n_buckets = n_poses * n_poses
        s_flat = torch.zeros((n_buckets + 1, 36), dtype=dtype, device=dev)
        for k1 in range(coobs_k):
            c = torch.einsum("lab,lkcb->lkac", tjk[:, k1], wjk)  # [L, K, 6, 6]
            sid = torch.where((pjk[:, k1, None] < n_poses) & (pjk < n_poses),
                              pjk[:, k1, None] * n_poses + pjk, n_buckets)
            s_flat.index_add_(0, sid.reshape(-1), c.reshape(-1, 36))
        return s_flat[:-1].reshape(n_poses, n_poses, 6, 6)
    lc = min(n_points, plan.landmark_chunk)
    n_chunks = -(-n_points // lc)
    if plan.segments == "onehot" and n_chunks == 1:
        stacked = oh_pose[:, :, None] * u_pl.reshape(m, 18)[None]  # [P, M, 18]
        w_full = torch.einsum("pmk,lm->plk", stacked, oh_pt).reshape(n_poses, n_points, 6, 3)
        t_full = torch.einsum("pjab,jbc->pjac", w_full, h_ll_inv)
        s = _rows_to_mat(t_full, 6, 3, n_poses, n_points) @ _rows_to_mat(w_full, 6, 3, n_poses, n_points).T
        return s.reshape(n_poses, 6, n_poses, 6).permute(0, 2, 1, 3)
    # Landmark chunks: each assembles a small dense W_c [P, lc, 6, 3] and
    # adds one [P*6, lc*3] @ [lc*3, P*6] product.
    use_gather = plan.segments == "gather"
    l_pad = n_chunks * lc
    h_ll_inv_pad = torch.zeros((l_pad, 3, 3), dtype=dtype, device=dev)
    h_ll_inv_pad[:n_points] = h_ll_inv
    if use_gather:
        u_pad = torch.cat([u_pl, torch.zeros_like(u_pl[:1])], dim=0)
        kf_pad = torch.cat([obs.kf_idx, torch.zeros_like(obs.kf_idx[:1])], dim=0)
        tbl_pad = torch.full((l_pad, plan.gather_k_pt), m, dtype=torch.int64, device=dev)
        tbl_pad[:n_points] = tbl_pt
    s_acc = torch.zeros((n_poses, n_poses, 6, 6), dtype=dtype, device=dev)
    for c in range(n_chunks):
        base = c * lc
        if use_gather:
            tbl_c = tbl_pad[base : base + lc]
            # Padding cells point at a zero block (and at pose 0).
            ohp = (kf_pad[tbl_c][..., None] == diag).to(dtype)  # [lc, K, P]
            w_c = torch.einsum("lkp,lkab->plab", ohp, u_pad[tbl_c])
        else:
            local = obs.pt_idx - base
            safe = torch.where((local >= 0) & (local < lc), local, lc)  # out of chunk -> dropped row
            w_c = torch.zeros((n_poses, lc + 1, 6, 3), dtype=dtype, device=dev)
            w_c.index_put_((obs.kf_idx, safe), u_pl, accumulate=True)
            w_c = w_c[:, :lc]
        t_c = torch.einsum("pjab,jbc->pjac", w_c, h_ll_inv_pad[base : base + lc])
        s_c = _rows_to_mat(t_c, 6, 3, n_poses, lc) @ _rows_to_mat(w_c, 6, 3, n_poses, lc).T
        s_acc = s_acc + s_c.reshape(n_poses, 6, n_poses, 6).permute(0, 2, 1, 3)
    return s_acc


def _lm_step(rot, trans, pts, err, kf_idx, pt_idx, pixels, mask, free, coobs_rank, tbl_pt, tbl_pose, oh_pose, oh_pt,
             eye3, eye6, diag, *, plan: _Plan):
    """Region `ba.step`: one LM iteration from (rot, trans, pts) at error
    err, the divergent step rolled back. Returns (rot, trans, pts, err,
    stop), stop the 0-d bool "diverged or converged"."""
    intrinsics, config = plan.intrinsics, plan.config
    dtype, dev = rot.dtype, rot.device
    n_poses, n_points, m = rot.shape[0], pts.shape[0], mask.shape[0]
    obs = ObservationBatch(kf_idx, pt_idx, pixels, mask)
    delta = config.huber_delta
    lam_damp = config.lam * 10.0

    if plan.pose_sums == "onehot":
        def seg_pose(v):
            return (oh_pose @ v.reshape(m, -1)).reshape(n_poses, *v.shape[1:])
    elif plan.pose_sums == "table":
        seg_pose = _gather_sum(tbl_pose)
    else:
        def seg_pose(v):
            return torch.zeros((n_poses, *v.shape[1:]), dtype=v.dtype, device=dev).index_add_(0, obs.kf_idx, v)

    if plan.segments == "gather":
        seg_pt = _gather_sum(tbl_pt)
    elif plan.segments == "onehot":
        def seg_pt(v):
            return (oh_pt @ v.reshape(m, -1)).reshape(n_points, *v.shape[1:])
    else:
        def seg_pt(v):
            return torch.zeros((n_points, *v.shape[1:]), dtype=v.dtype, device=dev).index_add_(0, obs.pt_idx, v)

    p_cam, z_safe, residual, valid = _project_and_residual(intrinsics, rot, trans, pts, obs)
    r_norm = torch.linalg.vector_norm(residual, dim=-1)
    w = torch.where(r_norm > delta, delta / torch.clamp(r_norm, min=1e-12), torch.ones_like(r_norm))
    w = torch.where(valid, w, torch.zeros_like(w))

    # Jacobian-only depth floor: a landmark grazing z > 1e-6 would give
    # fx/z ~ 1e9, whose squares and fourth powers overflow f32 in the
    # normal equations; residuals and the error keep the exact depth.
    z = torch.clamp(z_safe, min=1e-3)
    z2 = z * z
    zero = torch.zeros_like(z)
    j_proj = torch.stack([
        torch.stack([intrinsics.fx / z, zero, -intrinsics.fx * p_cam[:, 0] / z2], dim=-1),
        torch.stack([zero, intrinsics.fy / z, -intrinsics.fy * p_cam[:, 1] / z2], dim=-1),
    ], dim=-2)  # [M, 2, 3]
    rot_m = rot[obs.kf_idx]
    rx = (rot_m @ pts[obs.pt_idx][..., None])[..., 0]  # R X, without t
    j_pose = torch.cat([-(j_proj @ hat(rx)), j_proj], dim=-1)  # [M, 2, 6]
    j_point = j_proj @ rot_m  # [M, 2, 3]

    wj_pose = j_pose * w[:, None, None]
    wj_point = j_point * w[:, None, None]
    h_pp = seg_pose(wj_pose.transpose(1, 2) @ j_pose)  # [P, 6, 6]
    h_ll = seg_pt(wj_point.transpose(1, 2) @ j_point)  # [L, 3, 3]
    b_p = -seg_pose((wj_pose.transpose(1, 2) @ residual[..., None])[..., 0])  # [P, 6]
    b_l = -seg_pt((wj_point.transpose(1, 2) @ residual[..., None])[..., 0])  # [L, 3]
    u_pl = wj_pose.transpose(1, 2) @ j_point  # [M, 6, 3] per-observation coupling

    h_pp = torch.where(free[:, None, None], h_pp, torch.zeros_like(h_pp))
    b_p = torch.where(free[:, None], b_p, torch.zeros_like(b_p))
    u_pl = u_pl * free[obs.kf_idx][:, None, None].to(dtype)

    # Damping the landmark diagonal too keeps every block invertible (a
    # landmark seen once has a rank-2 H_ll).
    h_ll_inv = _inv3x3(h_ll + lam_damp * eye3)

    s = -_schur_offdiag(plan, obs, u_pl, h_ll_inv, w, coobs_rank, tbl_pt, oh_pose, oh_pt, diag, n_poses)
    s[diag, diag] += h_pp
    hinv_bl = (h_ll_inv @ b_l[..., None])[..., 0]  # [L, 3]
    b_red = b_p - seg_pose((u_pl @ hinv_bl[obs.pt_idx][..., None])[..., 0])  # [P, 6]

    if plan.fix_first_pose:
        s[0, :] = 0.0
        s[:, 0] = 0.0
        s[0, 0] = eye6
        b_red[0] = 0.0
    frozen = ~free
    s = torch.where(frozen[:, None, None, None] | frozen[None, :, None, None], torch.zeros_like(s), s)
    s[diag, diag] += torch.where(frozen[:, None, None], eye6, torch.zeros_like(eye6))
    b_red = torch.where(frozen[:, None], torch.zeros_like(b_red), b_red)
    s[diag, diag] += lam_damp * eye6

    s_mat = s.permute(0, 2, 1, 3).reshape(n_poses * 6, n_poses * 6)
    if n_poses * 6 <= 64:
        delta_p = _solve_pivoted(s_mat, b_red.reshape(-1, 1))[:, 0].reshape(n_poses, 6)
    else:
        # solve_ex does not raise on a singular system: like the JAX
        # package's solve it gives a non-finite step, which the error
        # check below rolls back.
        delta_p = torch.linalg.solve_ex(s_mat, b_red.reshape(-1))[0].reshape(n_poses, 6)

    new_rot = so3_exp(delta_p[:, :3]) @ rot
    new_trans = trans + delta_p[:, 3:]
    wtd = seg_pt((u_pl.transpose(1, 2) @ delta_p[obs.kf_idx][..., None])[..., 0])  # [L, 3]
    delta_x = (h_ll_inv @ (b_l - wtd)[..., None])[..., 0]
    observed = seg_pt(w) > 0  # points with no (free) observation stay put
    new_pts = pts + torch.where(observed[:, None], delta_x, torch.zeros_like(delta_x))

    new_err = compute_total_error(intrinsics, new_rot, new_trans, new_pts, obs, delta)
    # NaN-safe: a non-finite error counts as divergence and is rolled back.
    diverged = ~(new_err <= err * 1.5)
    converged = torch.abs(err - new_err) < config.min_error_change
    keep = ~diverged
    return (torch.where(keep, new_rot, rot), torch.where(keep, new_trans, trans), torch.where(keep, new_pts, pts),
            torch.where(keep, new_err, err), diverged | converged)


def _lm(plan: _Plan, rot, trans, pts, err, problem):
    """The LM loop: region `ba.step` an iteration (problem: its inputs after
    the iterates) and one host read of its stop flag. A reduced system
    past 64 rows (torch.linalg.solve_ex) runs eagerly. Returns (rot, trans,
    pts, err, iterations)."""
    step = functools.partial(_lm_step, plan=plan)
    eager = rot.shape[0] * 6 > 64
    iters = 0
    while iters < plan.config.max_iterations:
        with span("ba.iteration"):
            rot, trans, pts, err, stop = graphs.run("ba.step", step, (rot, trans, pts, err, *problem), static=plan,
                                                    eager=eager)
            iters += 1
            with span("ba.stop.read"):
                stop = bool(stop)
        if stop:
            break
    count("ba.solves")
    count("ba.lm_iterations", iters)
    return rot, trans, pts, err, iters


def ba_solve(intrinsics: CameraIntrinsics, rotations, translations, points, obs: ObservationBatch,
             config: BaConfig = BaConfig(), fix_first_pose: bool = True, pose_mask=None,
             landmark_chunk: int = 2048, segment_method: str = "auto", schur_method: str = "dense",
             coobs_k: int = 16, gather_k_pt: int | None = None):
    """Run LM with Schur elimination. Returns (rotations, translations,
    points, final_error (0-d tensor), iterations_run (int)).

    pose_mask [P] bool: poses whose parameters may move; None = all free
    (except the gauge fix). landmark_chunk: landmarks per Schur-assembly
    chunk; peak memory O(P * landmark_chunk * 18) whatever the problem size.
    schur_method:
      * "dense" - landmark-chunked dense Schur product, O(P^2 L) operations:
        right for windows and <= 256-pose global solves;
      * "coobs" - co-observation pair assembly: each landmark's observers
        compacted into <= coobs_k slots, only their pair products formed and
        summed onto pose-pair buckets, O(M coobs_k). Observations of a
        landmark beyond coobs_k observers are dropped from the whole problem.
    segment_method: "scatter" (index_add_), "onehot" ([L, M] / [P, M]
      indicator matmuls, used while each has <= ONEHOT_CAP elements, else
      scatter), "gather" (observer tables; needs gather_k_pt >= the largest
      number of observations of one landmark, or the excess is dropped),
      or "auto": scatter on the CPU; on CUDA gather, with gather_k_pt as
      given or counted here (a bincount of pt_idx) when it is at most 256,
      else one-hot. In gather mode the per-pose sums use the [P, M] one-hot
      matmul up to ONEHOT_CAP elements and a per-pose table above it.
    All float inputs are promoted to the rotations' dtype (f64 on the CPU
    for reference-grade results; f32 on the card).

    The set-up and each iteration are graph regions (`ba.setup`, `ba.step`
    of utils/graphs.py): on the card they replay once their key recurs.
    """
    rotations = torch.as_tensor(rotations)
    dtype, dev = rotations.dtype, rotations.device
    translations = torch.as_tensor(translations).to(device=dev, dtype=dtype)
    points = torch.as_tensor(points).to(device=dev, dtype=dtype)
    n_poses, n_points, m = rotations.shape[0], points.shape[0], obs.pixels.shape[0]
    if m == 0 or n_poses == 0:
        return rotations, translations, points, torch.zeros((), dtype=dtype, device=dev), 0
    obs = ObservationBatch(torch.as_tensor(obs.kf_idx).to(device=dev, dtype=torch.int64),
                           torch.as_tensor(obs.pt_idx).to(device=dev, dtype=torch.int64),
                           torch.as_tensor(obs.pixels).to(device=dev, dtype=dtype),
                           torch.as_tensor(obs.mask).to(device=dev, dtype=torch.bool))

    coobs_rank = None
    if schur_method == "coobs":
        # Rank each observation within its landmark (indices never change
        # across LM iterations, so once per solve) and drop ranks >= coobs_k.
        order, _, rank_sorted = _segment_ranks(obs.pt_idx, n_points, obs.mask)
        coobs_rank = torch.empty_like(rank_sorted)
        coobs_rank[order] = rank_sorted
        obs = obs._replace(mask=obs.mask & (coobs_rank < coobs_k))

    free = (torch.ones((n_poses,), dtype=torch.bool, device=dev) if pose_mask is None
            else torch.as_tensor(pose_mask).to(device=dev, dtype=torch.bool))

    if segment_method == "auto" and dev.type == "cuda" and gather_k_pt is None:
        counts = torch.bincount(obs.pt_idx[obs.mask], minlength=n_points)
        k = max(int(counts.max()) if counts.numel() else 1, 1)
        if k <= _GATHER_MAX_K:
            gather_k_pt = k
    plan = _plan(intrinsics, config, fix_first_pose, dev, n_poses, n_points, m, landmark_chunk, segment_method,
                 schur_method, coobs_k, gather_k_pt,
                 lambda: max(int(torch.bincount(obs.kf_idx, minlength=n_poses).max()), 1))
    *tables, err = graphs.run("ba.setup", functools.partial(_lm_setup, plan=plan),
                              (rotations, translations, points, *obs), static=plan, eager=n_poses * 6 > 64)
    return _lm(plan, rotations, translations, points, err, (*obs, free, coobs_rank, *tables))


class BundleAdjuster:
    """The reference's eager BA API over lists of poses, points and
    Observations, solved at f64 on `device` ("cuda" when None)."""

    def __init__(self, intrinsics: CameraIntrinsics, device=None):
        self.intrinsics = intrinsics
        self.config = BaConfig()
        self.device = resolve_device(device)

    def with_max_iterations(self, n: int) -> "BundleAdjuster":
        self.config = dataclasses.replace(self.config, max_iterations=n)
        return self

    def with_lambda(self, lam: float) -> "BundleAdjuster":
        self.config = dataclasses.replace(self.config, lam=lam)
        return self

    def with_huber_delta(self, delta: float) -> "BundleAdjuster":
        self.config = dataclasses.replace(self.config, huber_delta=delta)
        return self

    def compute_total_error(self, poses, points, observations) -> float:
        rot, trans, pts, obs = self._pack(poses, points, observations)
        return float(compute_total_error(self.intrinsics, rot, trans, pts, obs, self.config.huber_delta))

    def optimize(self, poses, points, observations, fix_first_pose: bool):
        """Returns (new_poses, new_points, final_error)."""
        if not observations:
            return poses, points, 0.0
        rot, trans, pts, obs = self._pack(poses, points, observations)
        out = ba_solve(self.intrinsics, rot, trans, pts, obs, self.config, fix_first_pose)
        return self._unpack(out, len(poses))

    def local_bundle_adjustment(self, poses, points, observations, window_size: int):
        """Optimise only the last `window_size` poses: observations of older
        keyframes are dropped, and the first pose is fixed only when the
        window reaches pose 0."""
        if not poses:
            return poses, points, 0.0
        start_idx = max(len(poses) - window_size, 0)
        local_obs = [o for o in observations if o.keyframe_idx >= start_idx]
        if not local_obs:
            return poses, points, 0.0
        rot, trans, pts, obs = self._pack(poses, points, local_obs)
        pose_mask = torch.zeros(len(poses), dtype=torch.bool, device=self.device)
        pose_mask[start_idx:] = True
        out = ba_solve(self.intrinsics, rot, trans, pts, obs, self.config, fix_first_pose=(start_idx == 0),
                       pose_mask=pose_mask)
        return self._unpack(out, len(poses))

    def _pack(self, poses, points, observations):
        kw = dict(dtype=torch.float64, device=self.device)
        rot = torch.tensor(np.stack([np.asarray(p[0], float) for p in poses]), **kw)
        trans = torch.tensor(np.stack([np.asarray(p[1], float).reshape(3) for p in poses]), **kw)
        pts = torch.tensor(np.stack([np.asarray(p, float).reshape(3) for p in points]), **kw)
        return rot, trans, pts, ObservationBatch.from_list(observations, **kw)

    @staticmethod
    def _unpack(out, n_poses):
        new_rot, new_trans, new_pts, err, _ = (x.cpu().numpy() if torch.is_tensor(x) else x for x in out)
        return [(new_rot[i], new_trans[i]) for i in range(n_poses)], list(new_pts), float(err)
