"""The port's homography ops (slamtpu_torch/ops/homography.py) and the pose
fallback against the JAX package, on the cases of tests/test_homography.py.

Everything runs at f64 on the same seeded numpy inputs, and RANSAC gets
the JAX package's own draws: `jax.random.uniform(key, (iters, N))` for a
homography RANSAC, and for the fallback the two streams of
`split(key)` (essential, homography). Tolerances: RANSAC inlier sets,
counts and cheirality votes exact; matrices within 1e-9 (the closed-form
eigensolvers and the DLT agree to ~1e-12 at f64); transfer errors within
rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from slamtpu.odometry.camera import CameraIntrinsics as JCam
from slamtpu.odometry.pose import estimate_relative_pose as j_pose
from slamtpu.ops import homography as jh
from slamtpu.ops.ransac import RansacConfig as JRansacConfig
from slamtpu_torch import convert
from slamtpu_torch.odometry.camera import CameraIntrinsics
from slamtpu_torch.odometry.pose import estimate_relative_pose
from slamtpu_torch.ops import homography as th
from slamtpu_torch.ops.ransac import PairDraws, RansacConfig

torch.set_num_threads(1)

CAM = CameraIntrinsics.webcam_vga()


def planar_scene(rng, n=150, rotvec=(0.03, -0.02, 0.01), tvec=(0.4, 0.05, 0.1), normal=(0.1, -0.2, 1.0), d=6.0,
                 noise=0.0):
    """tests/test_homography.py's plane n.x = d seen from two calibrated
    views (p2 = R p1 + t): normalized points, R, t, n, H."""
    nrm = np.asarray(normal, float)
    nrm = nrm / np.linalg.norm(nrm)
    xy = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n)], 1)
    z = (d - xy @ nrm[:2]) / nrm[2]
    pts = np.concatenate([xy, z[:, None]], 1)
    r = Rotation.from_rotvec(rotvec).as_matrix()
    t = np.asarray(tvec, float)
    p2 = pts @ r.T + t
    n1, n2 = pts[:, :2] / pts[:, 2:3], p2[:, :2] / p2[:, 2:3]
    if noise:
        n1 = n1 + rng.normal(scale=noise / CAM.fx, size=n1.shape)
        n2 = n2 + rng.normal(scale=noise / CAM.fx, size=n2.shape)
    return n1, n2, r, t, nrm, r + np.outer(t, nrm) / d


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _unit(h):
    h = np.asarray(h) / np.linalg.norm(h)
    return -h if h.ravel()[np.argmax(np.abs(h))] < 0 else h


def test_four_point_and_transfer_error_match_jax(rng):
    n1, n2, _, _, _, h_true = planar_scene(rng, n=20)
    ours = th.four_point_homography(_t(n1), _t(n2)).numpy()
    ref = np.asarray(jh.four_point_homography(jnp.asarray(n1), jnp.asarray(n2)))
    np.testing.assert_allclose(_unit(ours), _unit(ref), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_unit(ours), _unit(h_true), rtol=0, atol=1e-7)
    w = rng.uniform(0.0, 1.0, 20)
    np.testing.assert_allclose(_unit(th.four_point_homography(_t(n1), _t(n2), _t(w)).numpy()),
                               _unit(np.asarray(jh.four_point_homography(jnp.asarray(n1), jnp.asarray(n2),
                                                                         jnp.asarray(w)))), rtol=0, atol=1e-9)
    noisy = n2 + rng.normal(scale=1e-3, size=n2.shape)
    err = th.homography_transfer_error(_t(h_true), _t(n1), _t(noisy)).numpy()
    np.testing.assert_allclose(err, np.asarray(jh.homography_transfer_error(
        jnp.asarray(h_true), jnp.asarray(n1), jnp.asarray(noisy))), rtol=1e-9, atol=0)
    assert th.homography_transfer_error(_t(h_true), _t(n1), _t(n2)).max() < 1e-12


def test_eig3_full_and_decompose_match_jax(rng):
    _, _, r, t, nrm, h_true = planar_scene(rng)
    s = h_true.T @ h_true
    vals, vecs = th._eig3_full(_t(s))
    vals_j, vecs_j = (np.asarray(v) for v in jh._eig3_full(jnp.asarray(s)))
    np.testing.assert_allclose(vals.numpy(), vals_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vecs.numpy(), vecs_j, rtol=0, atol=1e-9)
    rs, ts, ns = (x.numpy() for x in th.decompose_homography(_t(h_true)))
    for ours, ref in zip((rs, ts, ns), jh.decompose_homography(jnp.asarray(h_true))):
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-9)
    errs = [np.degrees(np.linalg.norm(Rotation.from_matrix(rs[i] @ r.T).as_rotvec())) for i in range(4)]
    i = int(np.argmin(errs))
    assert errs[i] < 0.01
    assert np.dot(ts[i], t) / (np.linalg.norm(ts[i]) * np.linalg.norm(t)) > 0.9999
    assert abs(np.dot(ns[i], nrm)) > 0.9999


def test_recover_pose_cheirality_matches_jax(rng):
    n1, n2, r, t, _, h_true = planar_scene(rng)
    r_best, t_best, votes = th.recover_pose_from_homography(_t(h_true), _t(n1), _t(n2))
    rj, tj, vj = jh.recover_pose_from_homography(jnp.asarray(h_true), jnp.asarray(n1), jnp.asarray(n2))
    np.testing.assert_array_equal(votes.numpy(), np.asarray(vj))
    np.testing.assert_allclose(r_best.numpy(), np.asarray(rj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t_best.numpy(), np.asarray(tj), rtol=0, atol=1e-9)
    assert np.degrees(np.linalg.norm(Rotation.from_matrix(r_best.numpy() @ r.T).as_rotvec())) < 0.01
    assert np.dot(t_best.numpy(), t) / np.linalg.norm(t) > 0.999


def test_ransac_homography_with_outliers_matches_jax(rng):
    n1, n2, _, _, _, _ = planar_scene(rng, n=200, noise=0.3)
    n2[:50] = rng.uniform(-0.5, 0.5, size=(50, 2))
    mask = np.ones(200, bool)
    mask[60:70] = False
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, (256, 200), dtype=jnp.float32))
    sigma = 1.2 ** rng.integers(0, 3, 200)
    for sig in (None, sigma):
        hj, inl_j, cnt_j = jh.ransac_homography(key, jnp.asarray(n1), jnp.asarray(n2), mask=jnp.asarray(mask),
                                                threshold_norm=1.5 / 500.0,
                                                sigma=None if sig is None else jnp.asarray(sig))
        h, inl, cnt = th.ransac_homography(_t(n1), _t(n2), mask=torch.from_numpy(mask), threshold_norm=1.5 / 500.0,
                                           sigma=None if sig is None else _t(sig), uniforms=torch.from_numpy(u))
        np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
        assert int(cnt) == int(cnt_j)
        np.testing.assert_allclose(_unit(h.numpy()), _unit(np.asarray(hj)), rtol=0, atol=1e-9)
        assert inl.numpy()[50:][mask[50:]].mean() > 0.9 and inl.numpy()[:50].mean() < 0.1
    # Batched: two problems in one call equal each alone (inliers exact;
    # batched and single matmuls may round differently in the last bit).
    hb, inl_b, cnt_b = th.ransac_homography(torch.stack([_t(n1), _t(n2)]), torch.stack([_t(n2), _t(n1)]),
                                            threshold_norm=1.5 / 500.0,
                                            uniforms=torch.from_numpy(np.stack([u, u[::-1].copy()])))
    h1, inl_1, _ = th.ransac_homography(_t(n2), _t(n1), threshold_norm=1.5 / 500.0,
                                        uniforms=torch.from_numpy(u[::-1].copy()))
    np.testing.assert_array_equal(inl_b[1].numpy(), inl_1.numpy())
    np.testing.assert_allclose(hb[1].numpy(), h1.numpy(), rtol=0, atol=1e-12)


def _pixels(n1, n2):
    pix = [CAM.project(torch.cat([_t(n), torch.ones((len(n), 1), dtype=torch.float64)], 1) * 5.0) for n in (n1, n2)]
    return pix[0], pix[1]


def _fallback_pair(key, pix1, pix2, cfg_j):
    """Both packages' fallback poses on the same points and the JAX draws."""
    jcam = JCam(CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    ref = j_pose(key, jcam, jnp.asarray(pix1.numpy()), jnp.asarray(pix2.numpy()), config=cfg_j)
    k_e, k_h = jax.random.split(key)
    n = pix1.shape[0]
    draws = PairDraws(torch.from_numpy(np.asarray(jax.random.uniform(k_e, (cfg_j.iters, n), dtype=jnp.float32))),
                      torch.from_numpy(np.asarray(jax.random.uniform(k_h, (cfg_j.homography_iters, n),
                                                                     dtype=jnp.float32))))
    cfg = RansacConfig(**{f: getattr(cfg_j, f) for f in RansacConfig.__dataclass_fields__})
    return ref, estimate_relative_pose(CAM, pix1, pix2, config=cfg, uniforms=draws)


def test_planar_scene_rescued_by_fallback_as_in_jax(rng):
    """On a pure plane the 8-point path is degenerate; the fallback takes
    the homography's pose, in both packages alike."""
    n1, n2, r, t, _, _ = planar_scene(rng, n=200, noise=0.3)
    pix1, pix2 = _pixels(n1, n2)
    ref, pose = _fallback_pair(jax.random.PRNGKey(1), pix1, pix2, JRansacConfig(iters=300, homography_fallback=True))
    assert bool(pose.valid) and bool(ref.valid)
    assert int(pose.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(pose.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(pose.rotation.numpy(), np.asarray(ref.rotation), rtol=0, atol=1e-9)
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(ref.translation), rtol=0, atol=1e-9)
    rot_err = np.degrees(np.linalg.norm(Rotation.from_matrix(pose.rotation.numpy() @ r.T).as_rotvec()))
    assert rot_err < 1.0 and abs(np.dot(pose.translation.numpy(), t)) / np.linalg.norm(t) > 0.95


@pytest.mark.parametrize("min_solver", ["8pt", "5pt"])
def test_nonplanar_scene_keeps_essential_as_in_jax(rng, min_solver):
    """A general 3D scene routes through the essential path in both."""
    pts = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(4, 12, 200)], 1)
    r = Rotation.from_rotvec((0.02, -0.03, 0.01)).as_matrix()
    t = np.array([0.5, 0.05, 0.1])
    p2 = pts @ r.T + t
    n1 = pts[:, :2] / pts[:, 2:3] + rng.normal(scale=0.3 / CAM.fx, size=(200, 2))
    n2 = p2[:, :2] / p2[:, 2:3] + rng.normal(scale=0.3 / CAM.fx, size=(200, 2))
    pix1, pix2 = _pixels(n1, n2)
    cfg_j = JRansacConfig(iters=300, homography_fallback=True, min_solver=min_solver)
    ref, pose = _fallback_pair(jax.random.PRNGKey(2), pix1, pix2, cfg_j)
    assert bool(pose.valid) and bool(ref.valid)
    assert int(pose.num_inliers) == int(ref.num_inliers)
    assert np.degrees(np.linalg.norm(Rotation.from_matrix(pose.rotation.numpy() @ r.T).as_rotvec())) < 0.5
    np.testing.assert_allclose(pose.rotation.numpy(), np.asarray(ref.rotation), rtol=0, atol=1e-8)


def test_config_carries_the_homography_fields():
    j = JRansacConfig(homography_fallback=True, homography_ratio=0.3, homography_iters=64)
    ours = convert._convert(RansacConfig, j)
    assert (ours.homography_fallback, ours.homography_ratio, ours.homography_iters) == (True, 0.3, 64)
    assert convert._convert(RansacConfig, JRansacConfig()) == RansacConfig()
