"""The port's bundle adjustment against the JAX package's, at f64 on the
CPU: every segment-sum mode (scatter, onehot, gather, auto) and Schur
assembly (dense in one or several landmark chunks, one-hot single chunk,
gather, co-observation with and without overflow), the gauge and frozen
poses, Huber outliers, the one-hot cap's per-pose table, the error metric's
+inf and empty cases, the Jacobians and the eager BundleAdjuster.

The reference is the JAX package's scatter path (its CPU default) with the
same Schur assembly; only summation order differs, and LM carries it
through up to ten iterations. Measured on this CPU, bars at most 10x:
poses and points within 5e-8 of the largest coordinate (measured 5.9e-9,
the coobs overflow case; 1.7e-9 past the one-hot cap); final errors
within 2.5e-7 relative (measured 2.8e-8). BundleAdjuster.optimize on 12
poses: rotations 2e-12 (measured 2.8e-13), points 1e-9 of the largest
coordinate (measured 1.5e-10), error 1e-13 relative (measured 1.7e-14);
its local window equals the port's masked ba_solve bit for bit.
Iteration counts are exact. Jacobians: 2e-15 relative (measured
2.7e-16). The error metric: measured bit-identical, bar 1e-15 relative
(through BundleAdjuster, 12 poses: 5e-15, measured 6.7e-16).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.mapping import bundle_adjustment as jba
from slamtpu.odometry.camera import CameraIntrinsics as JCam
from slamtpu_torch.mapping import bundle_adjustment as tba
from slamtpu_torch.odometry.camera import CameraIntrinsics as TCam
from slamtpu_torch.ops.lie import so3_exp

torch.set_num_threads(1)

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
JC, TC = JCam(FX, FY, CX, CY), TCam(FX, FY, CX, CY)


def _rot(w):
    return so3_exp(torch.as_tensor(w, dtype=torch.float64)).numpy()


def _problem(seed, n_poses=6, n_points=40, outliers=6):
    """Noisy poses and points seen by a band of consecutive poses; a few
    masked observations, gross (Huber) outliers, a landmark seen once and
    one never seen."""
    rng = np.random.default_rng(seed)
    gt = np.stack([rng.uniform(-2, 2 + 0.4 * n_poses, n_points), rng.uniform(-1.5, 1.5, n_points),
                   rng.uniform(6, 12, n_points)], 1)
    rots = np.stack([_rot(rng.normal(scale=0.02, size=3)) for _ in range(n_poses)])
    trans = np.stack([[-0.4 * i, 0.0, 0.0] for i in range(n_poses)]) + rng.normal(scale=0.02, size=(n_poses, 3))
    kf, pt = [], []
    for j in range(n_points - 1):  # the last landmark is never observed
        first = rng.integers(0, n_poses)
        span = 1 if j == 0 else rng.integers(3, 7)
        for i in range(first, min(first + span, n_poses)):
            kf.append(i)
            pt.append(j)
    kf, pt = np.array(kf), np.array(pt)
    pc = np.einsum("mij,mj->mi", rots[kf], gt[pt]) + trans[kf]
    px = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1)
    px += rng.normal(scale=0.5, size=px.shape)
    px[rng.choice(len(px), outliers, replace=False)] += rng.normal(scale=30.0, size=(outliers, 2))
    mask = rng.uniform(size=len(px)) > 0.05
    noisy_rot = np.stack([_rot(rng.normal(scale=0.003, size=3)) @ r for r in rots])
    noisy_trans = trans + rng.normal(scale=0.01, size=trans.shape)
    noisy_pts = gt + rng.normal(scale=0.05, size=gt.shape)
    return noisy_rot, noisy_trans, noisy_pts, (kf, pt, px, mask)


def _jax_obs(o):
    kf, pt, px, mask = o
    return jba.ObservationBatch(jnp.asarray(kf, jnp.int32), jnp.asarray(pt, jnp.int32), jnp.asarray(px), jnp.asarray(mask))


def _torch_obs(o):
    kf, pt, px, mask = o
    return tba.ObservationBatch(torch.from_numpy(kf), torch.from_numpy(pt), torch.from_numpy(px), torch.from_numpy(mask))


def _assert_solve_matches(ours, ref, tol=5e-8):
    for a, b in zip(ours[:3], ref[:3]):
        a, b = a.numpy(), np.asarray(b)
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(float(ours[3]), float(ref[3]), rtol=2.5e-7)
    assert ours[4] == int(ref[4])


def _solve_both(prob, kw_ours, kw_ref, **common):
    rot, trans, pts, o = prob
    ours = tba.ba_solve(TC, torch.from_numpy(rot), torch.from_numpy(trans), torch.from_numpy(pts), _torch_obs(o),
                        **common, **kw_ours)
    ref = jba.ba_solve(JC, jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(pts), _jax_obs(o), **common, **kw_ref)
    return ours, ref


MODES = [
    # (segment_method, schur_method, landmark_chunk, coobs_k)
    ("scatter", "dense", 2048, 16),
    ("scatter", "dense", 7, 16),
    ("onehot", "dense", 2048, 16),  # one-hot segment sums and the one-hot single-chunk Schur
    ("onehot", "dense", 7, 16),  # one-hot segment sums, chunked scatter Schur
    ("gather", "dense", 2048, 16),
    ("gather", "dense", 7, 16),
    ("auto", "dense", 7, 16),  # CPU tensors: the scatter path
    ("scatter", "coobs", 2048, 16),
    ("gather", "coobs", 2048, 16),
    ("scatter", "coobs", 2048, 2),  # overflow: observers beyond 2 per landmark dropped
    ("gather", "coobs", 2048, 2),
]


def _gauge_kw(gauge, n_poses):
    if gauge == "fix_first":
        return dict(fix_first_pose=True, pose_mask=None)
    mask = np.ones(n_poses, bool)
    mask[:2] = False
    return dict(fix_first_pose=False, pose_mask=mask)


@functools.lru_cache(maxsize=None)
def _jax_reference(schur, chunk, coobs_k, gauge):
    """The JAX scatter-path solve of _problem(5), shared by the port's
    segment methods."""
    rot, trans, pts, o = _problem(5)
    out = jba.ba_solve(JC, jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(pts), _jax_obs(o),
                       segment_method="scatter", landmark_chunk=chunk, schur_method=schur, coobs_k=coobs_k,
                       **_gauge_kw(gauge, rot.shape[0]))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("segment,schur,chunk,coobs_k", MODES)
@pytest.mark.parametrize("gauge", ["fix_first", "frozen_anchors"])
def test_ba_solve_matches_jax(segment, schur, chunk, coobs_k, gauge):
    prob = _problem(5)
    rot, trans, pts, o = prob
    ours = tba.ba_solve(TC, torch.from_numpy(rot), torch.from_numpy(trans), torch.from_numpy(pts), _torch_obs(o),
                        segment_method=segment, gather_k_pt=6 if segment == "gather" else None,
                        landmark_chunk=chunk, schur_method=schur, coobs_k=coobs_k, **_gauge_kw(gauge, rot.shape[0]))
    _assert_solve_matches(ours, _jax_reference(schur, chunk, coobs_k, gauge))
    assert ours[4] >= 2 and float(ours[3]) < float(tba.compute_total_error(TC, *map(torch.from_numpy, prob[:3]),
                                                                          _torch_obs(prob[3])))
    if gauge == "frozen_anchors":
        np.testing.assert_array_equal(ours[0][:2].numpy(), prob[0][:2])
    else:
        np.testing.assert_array_equal(ours[1][0].numpy(), prob[1][0])
    assert np.array_equal(ours[2][-1].numpy(), prob[2][-1])  # an unobserved landmark does not move


def test_gather_pose_table_above_the_onehot_cap(monkeypatch):
    """Past ONEHOT_CAP elements the gather mode sums per pose through a
    table instead of the [P, M] one-hot, and the one-hot mode falls back to
    scatter-adds; forced here with a tiny cap."""
    rot, trans, pts, o = _problem(5)
    ref = _jax_reference("dense", 2048, 16, "fix_first")
    monkeypatch.setattr(tba, "ONEHOT_CAP", 10)
    for kw in (dict(segment_method="gather", gather_k_pt=6), dict(segment_method="onehot")):
        ours = tba.ba_solve(TC, torch.from_numpy(rot), torch.from_numpy(trans), torch.from_numpy(pts), _torch_obs(o),
                            **kw)
        _assert_solve_matches(ours, ref)


def test_gather_mode_needs_its_bound():
    prob = _problem(3)
    with pytest.raises(ValueError):
        tba.ba_solve(TC, *map(torch.from_numpy, prob[:3]), _torch_obs(prob[3]), segment_method="gather")


def test_compute_total_error_cases():
    rot, trans, pts, o = _problem(5)
    args = (torch.from_numpy(rot), torch.from_numpy(trans), torch.from_numpy(pts))
    ours = float(tba.compute_total_error(TC, *args, _torch_obs(o), 2.0))
    ref = float(jba.compute_total_error(JC, jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(pts), _jax_obs(o), 2.0))
    np.testing.assert_allclose(ours, ref, rtol=1e-15)  # measured bit-identical; a few ulps of summation order
    # Every landmark behind the camera: +inf, in both packages.
    behind = pts * np.array([1.0, 1.0, -1.0])
    ours = tba.compute_total_error(TC, args[0], args[1], torch.from_numpy(behind), _torch_obs(o))
    ref = jba.compute_total_error(JC, jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(behind), _jax_obs(o))
    assert np.isinf(float(ours)) and np.isinf(float(ref))
    # No masked observation: 0, and a solve with no observations is a no-op.
    empty = (o[0], o[1], o[2], np.zeros_like(o[3]))
    assert float(tba.compute_total_error(TC, *args, _torch_obs(empty))) == 0.0
    none = tba.ObservationBatch.from_list([])
    out = tba.ba_solve(TC, *args, none)
    assert out[0] is args[0] and float(out[3]) == 0.0 and out[4] == 0


def test_divergent_step_is_rolled_back():
    """On this problem the first LM step scores worse than 1.5x the start
    (the JAX package's solve, same draws, also stops after one iteration):
    it is rolled back and the loop stops, returning the input state and
    error."""
    prob = _problem(2)
    ours = tba.ba_solve(TC, *map(torch.from_numpy, prob[:3]), _torch_obs(prob[3]))
    assert ours[4] == 1
    for a, b in zip(ours[:3], prob[:3]):
        np.testing.assert_array_equal(a.numpy(), b)
    start = tba.compute_total_error(TC, *map(torch.from_numpy, prob[:3]), _torch_obs(prob[3]))
    assert float(ours[3]) == float(start)


def test_singular_reduced_system_is_rolled_back_as_in_jax():
    """A free pose that no observation sees, with no damping, makes the
    reduced pose system singular (12 poses: the LU solve above the 64-row
    pivoted path). The JAX package's solve gives a non-finite step, and so
    does the port's: both roll it back and return the input state."""
    rot, trans, pts, (kf, pt, px, mask) = _problem(3, n_poses=12)
    # Pose 7 unobserved; every landmark left seen at least twice, so each
    # landmark block is invertible without damping and the only zero pivot
    # is pose 7's.
    keep = (kf != 7) & mask
    keep &= np.bincount(pt[keep], minlength=len(pts))[pt] >= 2
    used, pt_new = np.unique(pt[keep], return_inverse=True)
    prob = (rot, trans, pts[used], (kf[keep], pt_new, px[keep], mask[keep]))
    ours, ref = _solve_both(prob, dict(config=tba.BaConfig(lam=0.0)), dict(config=jba.BaConfig(lam=0.0)),
                            fix_first_pose=False)
    assert ours[4] == int(ref[4]) == 1
    for a, b, start in zip(ours[:3], ref[:3], prob[:3]):
        np.testing.assert_array_equal(a.numpy(), start)
        np.testing.assert_array_equal(np.asarray(b), start)
    assert float(ours[3]) == pytest.approx(float(ref[3]), rel=1e-12)


def test_jacobians_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(5):
        r, t, x = _rot(rng.normal(scale=0.3, size=3)), rng.normal(size=3), rng.normal(size=3) + [0, 0, 8]
        ours = tba.pose_point_jacobians(TC, torch.from_numpy(r), torch.from_numpy(t), torch.from_numpy(x))
        ref = jba.pose_point_jacobians(JC, r, t, x)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-15, atol=0)


def test_bundle_adjuster_matches_jax():
    """The eager API: optimize against the JAX package's, on 12 poses (the
    72-unknown reduced system goes to linalg.solve instead of the pivoted
    Gauss-Jordan); the local window solve (frozen older poses) against a
    masked ba_solve of the port."""
    rot, trans, pts, (kf, pt, px, mask) = _problem(8, n_poses=12, n_points=60, outliers=0)
    poses = [(rot[i], trans[i]) for i in range(len(rot))]
    points = [pts[j] for j in range(len(pts))]
    t_obs = [tba.Observation(int(a), int(b), c) for a, b, c, m in zip(kf, pt, px, mask) if m]
    j_obs = [jba.Observation(int(a), int(b), c) for a, b, c, m in zip(kf, pt, px, mask) if m]
    ours, ref = tba.BundleAdjuster(TC, device="cpu").with_max_iterations(15), jba.BundleAdjuster(JC).with_max_iterations(15)
    np.testing.assert_allclose(ours.compute_total_error(poses, points, t_obs),
                               ref.compute_total_error(poses, points, j_obs), rtol=5e-15)
    o_poses, o_pts, o_err = ours.optimize(poses, points, t_obs, True)
    r_poses, r_pts, r_err = ref.optimize(poses, points, j_obs, True)
    np.testing.assert_allclose(o_err, r_err, rtol=1e-13)
    np.testing.assert_allclose(np.stack([p[0] for p in o_poses]), np.stack([p[0] for p in r_poses]), atol=2e-12)
    np.testing.assert_allclose(np.stack(o_pts), np.stack(r_pts), atol=1e-9 * np.abs(pts).max())
    # local_bundle_adjustment(3): observations of the last 3 poses only, the
    # others frozen, the gauge fixed only if the window reached pose 0.
    l_poses, l_pts, l_err = ours.local_bundle_adjustment(poses, points, t_obs, 3)
    keep = [o for o in t_obs if o.keyframe_idx >= 9]
    free = torch.arange(12) >= 9
    want = tba.ba_solve(TC, *map(torch.from_numpy, (rot, trans, pts)), tba.ObservationBatch.from_list(keep),
                        ours.config, fix_first_pose=False, pose_mask=free)
    np.testing.assert_array_equal(np.stack([p[0] for p in l_poses]), want[0].numpy())
    np.testing.assert_array_equal(np.stack(l_pts), want[2].numpy())
    assert l_err == float(want[3])
    assert ours.optimize(poses, points, [], True) == (poses, points, 0.0)
    assert ours.with_lambda(1e-2).with_huber_delta(3.0).config == tba.BaConfig(15, 1e-2, 1e-6, 3.0)
