"""The port's two-view geometry against the JAX package, at fp64 with the
same RANSAC draws: epipolar helpers, the five-point solver, RANSAC and the
relative pose.

At fp64 both sides compute the same arithmetic up to summation order, so
inlier sets must be identical and poses agree to 1e-5. (At fp32 the
five-point solver's root finding is sensitive enough to rounding that the
two can elect different RANSAC winners; the fp32 path is held to the JAX
package end to end in tests/test_torch_vo.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from slamtpu.odometry import camera as jcam
from slamtpu.odometry import pose as jpose
from slamtpu.ops import epipolar as jepi
from slamtpu.ops import five_point as jfive
from slamtpu.ops import ransac as jransac
from slamtpu_torch.odometry import camera as tcam
from slamtpu_torch.odometry import pose as tpose
from slamtpu_torch.ops import epipolar as tepi
from slamtpu_torch.ops import five_point as tfive
from slamtpu_torch.ops import ransac as transac

torch.set_num_threads(1)


def two_view(rng, n, noise=0.0, outliers=0.0):
    """Normalized correspondences of a random scene and its true (R, t)."""
    x = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    r = Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
    t = np.array([0.3, 0.05, 0.9]) + rng.normal(0, 0.05, 3)
    x2 = x @ r.T + t
    p1 = x[:, :2] / x[:, 2:] + rng.normal(0, noise, (n, 2))
    p2 = x2[:, :2] / x2[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    p2[bad] = rng.uniform(-0.5, 0.5, (bad.sum(), 2))
    return p1, p2, r, t / np.linalg.norm(t)


def _same_up_to_sign(a, b, atol):
    sign = np.sign(np.sum(a * b, axis=(-2, -1), keepdims=True))
    np.testing.assert_allclose(a * sign, b, rtol=0, atol=atol)


def test_epipolar_helpers_match_jax(rng):
    p1, p2, r, t = two_view(rng, 60, noise=1e-3)
    e_true = np.cross(np.eye(3), t) @ r  # [t]x R
    es = e_true + rng.normal(0, 1e-2, (5, 3, 3))
    tp1, tp2 = torch.from_numpy(p1), torch.from_numpy(p2)
    jp1, jp2 = jnp.asarray(p1), jnp.asarray(p2)
    np.testing.assert_allclose(tepi.sampson_error(torch.from_numpy(es), tp1[None], tp2[None]).numpy(),
                               np.asarray(jepi.sampson_error(jnp.asarray(es), jp1[None], jp2[None])), rtol=1e-10)
    rank2 = tepi.enforce_rank2(torch.from_numpy(es)).numpy()
    np.testing.assert_allclose(rank2, np.asarray(jepi.enforce_rank2(jnp.asarray(es))), atol=1e-12)
    rs, ts = tepi.decompose_essential(torch.from_numpy(rank2))
    jrs, jts = jepi.decompose_essential(jnp.asarray(rank2))
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), atol=1e-10)
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), atol=1e-10)
    r_o, t_o, v_o = tepi.recover_pose_from_essential(torch.from_numpy(e_true), tp1, tp2)
    r_j, t_j, v_j = jepi.recover_pose_from_essential(jnp.asarray(e_true), jp1, jp2)
    np.testing.assert_array_equal(v_o.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(r_o.numpy(), np.asarray(r_j), atol=1e-10)
    np.testing.assert_allclose(r_o.numpy(), r, atol=1e-3)
    for method in ("chol", "eigh"):
        e8 = tepi.eight_point(tp1, tp2, method=method).numpy()
        _same_up_to_sign(e8, np.asarray(jepi.eight_point(jp1, jp2, method=method)), 1e-8)


def test_five_point_matches_jax_slot_by_slot(rng):
    """Slot by slot at fp64, up to sign. A handful of slots sit on
    near-double roots of the degree-10 polynomial, where the 1e-15 rounding
    difference of the two QR bases is amplified; those may differ, but
    never the candidate that solves the sample (closest to the true E)."""
    n = 48
    samples = [two_view(rng, 5) for _ in range(n)]
    p1 = np.stack([s[0] for s in samples])
    p2 = np.stack([s[1] for s in samples])
    e_j, v_j = (np.asarray(x) for x in jfive.five_point_candidates(jnp.asarray(p1), jnp.asarray(p2)))
    e_t, v_t = (x.numpy() for x in tfive.five_point_candidates(torch.from_numpy(p1), torch.from_numpy(p2)))
    assert e_t.shape == e_j.shape == (n, tfive.N_ROOT_SLOTS, 3, 3)
    assert (v_t == v_j).mean() > 0.99  # a Newton residual may sit on its 1e-4 validity bar
    sign = np.sign(np.sum(e_t * e_j, axis=(-2, -1), keepdims=True))
    diff = np.abs(e_t * sign - e_j).max((-1, -2))
    assert (diff[v_j & v_t] < 1e-8).mean() > 0.9
    for i, (_, _, r, t) in enumerate(samples):
        e_true = np.cross(np.eye(3), t) @ r
        e_true /= np.linalg.norm(e_true)
        dist = np.minimum(np.abs(e_j[i] - e_true).max((-1, -2)), np.abs(e_j[i] + e_true).max((-1, -2)))
        dist[~v_j[i]] = np.inf
        best = int(np.argmin(dist))
        assert dist[best] < 1e-6
        assert v_t[i, best] and diff[i, best] < 1e-6


@pytest.mark.parametrize("solver,refit", [("5pt", "gn"), ("5pt", "none"), ("8pt", "gn")])
def test_ransac_matches_jax_with_shared_draws(rng, solver, refit):
    n, iters = 120, 24
    p1, p2, _, _ = two_view(rng, n, noise=1.5e-3, outliers=0.2)
    mask = rng.uniform(size=n) < 0.95
    sigma = 1.2 ** rng.integers(0, 3, n).astype(np.float64)
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (iters, n), dtype=jnp.float32))
    cfg = dict(iters=iters, min_solver=solver, refit_method=refit)
    ref = jransac.ransac_essential(key, jnp.asarray(p1), jnp.asarray(p2), mask=jnp.asarray(mask),
                                   threshold_norm=2e-3, config=jransac.RansacConfig(**cfg), sigma=jnp.asarray(sigma))
    ours = transac.ransac_essential(torch.from_numpy(p1), torch.from_numpy(p2), mask=torch.from_numpy(mask),
                                    threshold_norm=2e-3, config=transac.RansacConfig(**cfg),
                                    sigma=torch.from_numpy(sigma), uniforms=torch.from_numpy(u))
    assert int(ours.best_iter_inliers) == int(ref.best_iter_inliers)
    assert int(ours.num_inliers) == int(ref.num_inliers) > 60
    np.testing.assert_array_equal(ours.inliers.numpy(), np.asarray(ref.inliers))
    _same_up_to_sign(ours.essential.numpy(), np.asarray(ref.essential), 1e-5)


def test_relative_pose_matches_jax_with_shared_draws(rng):
    """Pixel correspondences through both estimate_relative_pose (batched in
    the port: two pairs at once, each against its own JAX call)."""
    n, iters = 150, 32
    cam_j, cam_t = jcam.CameraIntrinsics.kitti(), tcam.CameraIntrinsics.kitti()
    cfg_j = jransac.RansacConfig(iters=iters, min_solver="5pt")
    cfg_t = transac.RansacConfig(iters=iters, min_solver="5pt")
    pairs, refs, draws = [], [], []
    for k in range(2):
        p1, p2, r, t = two_view(rng, n, noise=0.5 / 718.856, outliers=0.15)
        px1 = p1 * cam_t.fx + [cam_t.cx, cam_t.cy]
        px2 = p2 * cam_t.fx + [cam_t.cx, cam_t.cy]
        mask = rng.uniform(size=n) < 0.9
        key = jax.random.PRNGKey(20 + k)
        draws.append(np.array(jax.random.uniform(key, (iters, n), dtype=jnp.float32)))
        refs.append(jpose.estimate_relative_pose(key, cam_j, jnp.asarray(px1), jnp.asarray(px2),
                                                 mask=jnp.asarray(mask), config=cfg_j))
        pairs.append((px1, px2, mask, r, t))
    stack = lambda i: torch.from_numpy(np.stack([p[i] for p in pairs]))  # noqa: E731
    ours = tpose.estimate_relative_pose(cam_t, stack(0), stack(1), mask=stack(2), config=cfg_t,
                                        uniforms=torch.from_numpy(np.stack(draws)))
    for k, ref in enumerate(refs):
        assert bool(ours.valid[k]) and bool(ref.valid)
        assert int(ours.num_inliers[k]) == int(ref.num_inliers)
        np.testing.assert_array_equal(ours.inliers[k].numpy(), np.asarray(ref.inliers))
        np.testing.assert_allclose(ours.rotation[k].numpy(), np.asarray(ref.rotation), atol=1e-5)
        np.testing.assert_allclose(ours.translation[k].numpy(), np.asarray(ref.translation), atol=1e-5)
        np.testing.assert_allclose(ours.rotation[k].numpy(), pairs[k][3], atol=5e-3)


def test_relative_pose_failure_is_identity():
    cam = tcam.CameraIntrinsics.kitti()
    p = torch.zeros((20, 2), dtype=torch.float64)
    res = tpose.estimate_relative_pose(cam, p, p, mask=torch.zeros(20, dtype=torch.bool),
                                       config=transac.RansacConfig(iters=4, min_solver="5pt"))
    assert not bool(res.valid)
    np.testing.assert_array_equal(res.rotation.numpy(), np.eye(3))
    np.testing.assert_array_equal(res.translation.numpy(), np.zeros(3))
    # With the homography fallback (once unported, now run) a failure is
    # still the identity.
    res = tpose.estimate_relative_pose(cam, p, p, mask=torch.zeros(20, dtype=torch.bool),
                                       config=transac.RansacConfig(iters=4, homography_fallback=True,
                                                                   homography_iters=4))
    assert not bool(res.valid)
    np.testing.assert_array_equal(res.rotation.numpy(), np.eye(3))
    np.testing.assert_array_equal(res.translation.numpy(), np.zeros(3))


def test_draws_from_an_explicit_generator_are_reproducible(rng):
    p1, p2, r, _ = two_view(rng, 80, noise=1e-3)
    pts = [torch.from_numpy(p * 718.856 + 300.0) for p in (p1, p2)]
    cam = tcam.CameraIntrinsics(718.856, 718.856, 300.0, 300.0)
    cfg = transac.RansacConfig(iters=16, min_solver="5pt")
    runs = [tpose.estimate_relative_pose(cam, *pts, config=cfg, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0].rotation, runs[1].rotation) and bool(runs[0].valid)
    np.testing.assert_allclose(runs[0].rotation.numpy(), r, atol=5e-3)
