"""The port's geometry core against the JAX package: camera, Lie group,
trajectory composition and JSON, keyframe selection.

Same numpy inputs through both; f64 where the functions are pure algebra
(tolerance 1e-12: only summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.mapping import keyframe as jkf
from slamtpu.odometry import camera as jcam
from slamtpu.odometry import trajectory as jtraj
from slamtpu.ops import lie as jlie
from slamtpu_torch.mapping import keyframe as tkf
from slamtpu_torch.odometry import camera as tcam
from slamtpu_torch.odometry import trajectory as ttraj
from slamtpu_torch.ops import lie as tlie

torch.set_num_threads(1)


def _rotvecs(rng, n):
    """Generic, tiny (< 1e-8: the identity branch) and near-pi angles."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.0, 3.0, n - 6), [1e-10, 3e-9, 0.0, np.pi - 1e-6, np.pi - 5e-5, np.pi]])
    return axes * angles[:, None]


def test_camera_matches_jax(rng):
    pix = rng.uniform(0, 1241, (50, 2))
    pts = rng.uniform(-5, 5, (50, 3)) + [0, 0, 10]
    for j, t in ((jcam.CameraIntrinsics.kitti(), tcam.CameraIntrinsics.kitti()),
                 (jcam.CameraIntrinsics.webcam_vga(), tcam.CameraIntrinsics.webcam_vga())):
        np.testing.assert_array_equal(np.asarray(j.normalize(jnp.asarray(pix))), t.normalize(torch.from_numpy(pix)).numpy())
        np.testing.assert_allclose(np.asarray(j.project(jnp.asarray(pts))), t.project(torch.from_numpy(pts)).numpy(), rtol=1e-14)
        np.testing.assert_array_equal(np.asarray(j.to_matrix(jnp.float64)), t.to_matrix(torch.float64).numpy())


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "so3_log", "rotation_angle"])
def test_lie_matches_jax(rng, fn):
    w = _rotvecs(rng, 40)
    if fn in ("so3_log", "rotation_angle"):
        x = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    else:
        x = w
    ours = getattr(tlie, fn)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jlie, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_se3_matrix_matches_jax(rng):
    r = np.asarray(jlie.so3_exp(jnp.asarray(_rotvecs(rng, 12))))
    t = rng.normal(size=(12, 3))
    np.testing.assert_array_equal(tlie.se3_matrix(torch.from_numpy(r), torch.from_numpy(t)).numpy(),
                                  np.asarray(jlie.se3_matrix(jnp.asarray(r), jnp.asarray(t))))


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_compose_relative_transforms_matches_jax(rng, n):
    r = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.1, (n, 3)))))
    t = rng.normal(size=(n, 3))
    rel = np.asarray(jlie.se3_matrix(jnp.asarray(r), jnp.asarray(t)))
    ours = ttraj.compose_relative_transforms(torch.from_numpy(rel)).numpy()
    ref = np.asarray(jtraj.compose_relative_transforms(jnp.asarray(rel)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_trajectory_json_byte_identical(rng):
    jt, tt = jtraj.Trajectory(), ttraj.Trajectory()
    for i in range(9):
        r = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.05, 3))))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        jt.update(r, t, i + 2, (i + 1) / 30.0)
        tt.update(r, t, i + 2, (i + 1) / 30.0)
    assert tt.to_json() == jt.to_json()
    assert tt.total_distance() == jt.total_distance()
    assert len(tt) == len(jt) == 10


def test_keyframe_scan_matches_jax(rng):
    n = 40
    rot = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.06, (n, 3)))), np.float32)
    trans = (rng.normal(0, 0.06, (n, 3))).astype(np.float32)
    matches = rng.integers(0, 200, n).astype(np.int32)
    cfg_j = jkf.KeyframeConfig()
    cfg_t = tkf.KeyframeConfig(**vars(cfg_j))
    (jf, jl), jis = jkf.select_keyframes(cfg_j, jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(matches))
    state = tkf.KeyframeState.initial()
    ours = []
    for i in range(n):
        state, kf = tkf.keyframe_step(cfg_t, state, torch.from_numpy(rot[i]), torch.from_numpy(trans[i]),
                                      torch.tensor(matches[i]))
        ours.append(bool(kf))
    np.testing.assert_array_equal(np.array(ours), np.asarray(jis))
    assert 0 < sum(ours) < n  # both outcomes exercised
    assert int(state.frames_since_last) == int(jf) and int(state.last_keyframe_matches) == int(jl)
