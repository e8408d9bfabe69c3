"""Trajectory evaluation: ATE and KITTI odometry drift metrics
(counterpart of slamtpu/utils/evaluate.py; host numpy, a copy).

- `align_umeyama`: closed-form SE(3)/Sim(3) alignment (Umeyama 1991) — a
  monocular pipeline estimates translation only up to scale, so ATE is
  conventionally reported after Sim(3) alignment.
- `ate_rmse`: absolute trajectory error after optional alignment.
- `kitti_relative_errors`: the KITTI odometry devkit metric — average
  translational drift (%) and rotational drift (deg/m) of relative motions
  over all subsequences of length 100..800 m.

These are offline metrics over a few thousand poses, not device work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "align_umeyama",
    "ate_rmse",
    "kitti_relative_errors",
    "TrajectoryErrors",
]


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform mapping `est` onto `gt`.

    est, gt: [T, 3] positions. Returns (scale s, rotation R [3,3],
    translation t [3]) minimizing ||gt - (s R est + t)||^2 (Umeyama 1991).
    with_scale=False pins s=1 (SE(3) alignment).
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    assert est.shape == gt.shape and est.ndim == 2 and est.shape[1] == 3
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    cov = xg.T @ xe / est.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1.0
    rot = u @ s_fix @ vt
    var_e = (xe**2).sum() / est.shape[0]
    scale = float(np.trace(np.diag(d) @ s_fix) / var_e) if (with_scale and var_e > 0) else 1.0
    trans = mu_g - scale * rot @ mu_e
    return scale, rot, trans


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: str = "sim3") -> float:
    """RMSE of position error after alignment.

    align: "sim3" (monocular convention: scale+rotation+translation),
    "se3" (rotation+translation), or "none".
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align == "sim3":
        s, r, t = align_umeyama(est, gt, with_scale=True)
        est = (s * (r @ est.T)).T + t
    elif align == "se3":
        _, r, t = align_umeyama(est, gt, with_scale=False)
        est = (r @ est.T).T + t
    elif align != "none":
        raise ValueError(f"unknown align mode {align!r}")
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


@dataclasses.dataclass(frozen=True)
class TrajectoryErrors:
    """KITTI devkit-style averages. t_rel is a fraction (0.02 = 2%);
    r_rel is radians per meter."""

    t_rel: float
    r_rel: float
    n_segments: int

    @property
    def t_rel_percent(self) -> float:
        return 100.0 * self.t_rel

    @property
    def r_rel_deg_per_100m(self) -> float:
        return float(np.degrees(self.r_rel) * 100.0)


def _homogenize(poses: np.ndarray) -> np.ndarray:
    """Accept [T, 3, 4] (the KITTI devkit / io.kitti.load_poses row format)
    or [T, 4, 4]; return [T, 4, 4]."""
    if poses.shape[1:] == (3, 4):
        bottom = np.zeros((poses.shape[0], 1, 4), poses.dtype)
        bottom[:, 0, 3] = 1.0
        return np.concatenate([poses, bottom], axis=1)
    assert poses.shape[1:] == (4, 4), f"expected [T,3,4] or [T,4,4], got {poses.shape}"
    return poses


def _trajectory_distances(positions: np.ndarray) -> np.ndarray:
    steps = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def kitti_relative_errors(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    lengths=(100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0),
    step: int = 10,
) -> TrajectoryErrors:
    """KITTI odometry devkit metric over [T, 4, 4] camera-to-world poses.

    For every start frame (stride `step`, the devkit's 10-frame stride) and
    every segment length L in `lengths`, find the first frame at path
    distance >= L, form the relative-pose error
    E = (gt_i^-1 gt_j)^-1 (est_i^-1 est_j), and accumulate
    |trans(E)| / L and rot_angle(E) / L. Returns the averages; segments the
    ground-truth path is too short to cover are skipped (the devkit does
    the same).
    """
    est_poses = _homogenize(np.asarray(est_poses, np.float64))
    gt_poses = _homogenize(np.asarray(gt_poses, np.float64))
    assert est_poses.shape == gt_poses.shape
    t_total = est_poses.shape[0]
    dist = _trajectory_distances(gt_poses[:, :3, 3])

    t_err, r_err, count = 0.0, 0.0, 0
    for i in range(0, t_total, step):
        for length in lengths:
            # First j with dist[j] >= dist[i] + length.
            j = int(np.searchsorted(dist, dist[i] + length))
            if j >= t_total:
                break
            rel_gt = np.linalg.inv(gt_poses[i]) @ gt_poses[j]
            rel_est = np.linalg.inv(est_poses[i]) @ est_poses[j]
            err = np.linalg.inv(rel_gt) @ rel_est
            t_err += float(np.linalg.norm(err[:3, 3])) / length
            tr = np.trace(err[:3, :3])
            angle = float(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
            r_err += angle / length
            count += 1
    if count == 0:
        return TrajectoryErrors(float("nan"), float("nan"), 0)
    return TrajectoryErrors(t_err / count, r_err / count, count)
