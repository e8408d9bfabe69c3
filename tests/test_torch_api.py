"""The port's flat public API and its eager wrappers against the JAX
package: the 15 root names, a cheap `import slamtpu_torch`, `OrbDetector`,
`PoseEstimator`, `KeyframeSelector` / `select_keyframes`, the Hamming
functions, `se3_inverse` / `rt_from_matrix`, `positions_from_relative` and
`extract_matched_points`.

Tolerances: integer results (distances, indices, inlier sets, keyframe
flags) exact; poses from the same draws at f64 within 1e-8 (the RANSAC
regime of tests/test_torch_two_view.py); pure products of the same f64
inputs within 1e-12; detector fields at tests/test_torch_detector.py's bar.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import slamtpu
import slamtpu_torch
from slamtpu import KeyframeConfig as JKeyframeConfig
from slamtpu import KeyframeSelector as JKeyframeSelector
from slamtpu import OrbDetector as JOrbDetector
from slamtpu import PoseEstimator as JPoseEstimator
from slamtpu.feature import detector as jdet
from slamtpu.mapping.keyframe import select_keyframes as j_select
from slamtpu.odometry.pose import extract_matched_points as j_extract
from slamtpu.odometry.trajectory import positions_from_relative as j_positions
from slamtpu.ops import hamming as jham
from slamtpu.ops import lie as jlie
from slamtpu_torch.feature import detector as tdet
from slamtpu_torch.feature.matcher import Matches
from slamtpu_torch.mapping.keyframe import KeyframeConfig, KeyframeSelector, select_keyframes
from slamtpu_torch.odometry.camera import CameraIntrinsics
from slamtpu_torch.odometry.pose import PoseEstimator, extract_matched_points
from slamtpu_torch.odometry.trajectory import positions_from_relative
from slamtpu_torch.ops import hamming as tham
from slamtpu_torch.ops import lie as tlie

from test_pose import make_scene
from test_torch_detector import texture

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_every_root_name_resolves():
    assert set(slamtpu.__all__) <= set(slamtpu_torch.__all__)
    assert set(slamtpu.__all__) <= set(dir(slamtpu_torch))
    for name in slamtpu.__all__:
        obj = getattr(slamtpu_torch, name)
        assert obj.__module__.startswith("slamtpu_torch.") and obj.__name__ == name
    with pytest.raises(AttributeError):
        slamtpu_torch.NoSuchName  # noqa: B018


def test_import_is_cheap_and_loads_a_name_on_use():
    code = ("import sys, slamtpu_torch\n"
            "before = sorted(m for m in sys.modules if m.startswith('slamtpu_torch.'))\n"
            "slamtpu_torch.OrbDetector\n"
            "heavy = [m for m in sys.modules if m.startswith(('slamtpu_torch.pipeline', 'slamtpu_torch.mapping', "
            "'slamtpu_torch.depth', 'slamtpu_torch.models'))]\n"
            "print(before, 'slamtpu_torch.feature.detector' in sys.modules, heavy, "
            "sys.modules['torch'].backends.cuda.matmul.allow_tf32, sys.modules['torch'].backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True [] False False"


def test_orb_detector_matches_jax():
    """One image through both eager detectors, on the first image and the
    configuration of tests/test_torch_detector.py::test_detector_matches_jax
    (on other images a corner can hinge on a FAST threshold tie that the
    two pyramids' last-bit rounding decides; that file says why), and the
    wrapper equal to the batched detector it wraps."""
    image = texture(np.random.default_rng(0), 120, 200)
    ref = JOrbDetector(max_features=64, config=jdet.OrbConfig(n_levels=4)).detect_and_compute(image)
    det = slamtpu_torch.OrbDetector(max_features=64, config=tdet.OrbConfig(n_levels=4), device="cpu")
    ours = det.detect_and_compute(image)
    assert ours.xy.shape == (64, 2) and ours.descriptors.shape == (64, 32)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(ours.xy.numpy(), np.asarray(ref.xy), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours.octave.numpy(), np.asarray(ref.octave))
    np.testing.assert_allclose(ours.angle.numpy(), np.asarray(ref.angle), atol=1e-4)
    batch = det.detect(np.stack([image, image]))
    direct = tdet.detect_and_compute(torch.from_numpy(image)[None], det.config)
    assert batch.xy.shape == (2, 64, 2) and det.config.max_features == 64
    for field, single, batched, plain in zip(ours._fields, ours, batch, direct):
        torch.testing.assert_close(batched[1], single, rtol=0, atol=0, msg=field)
        torch.testing.assert_close(plain[0], single, rtol=0, atol=0, msg=field)


def test_pose_estimator_matches_jax(rng):
    jcam, pix1, pix2, r, _ = make_scene(rng, n=100)
    cam = CameraIntrinsics(jcam.fx, jcam.fy, jcam.cx, jcam.cy)
    ref_est = JPoseEstimator(jcam)
    ref = ref_est.compute_essential_matrix(pix1, pix2)
    # The JAX estimator draws from split(PRNGKey(0))[1] on its first call.
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (1000, 100), dtype=jnp.float32)))
    est = slamtpu_torch.PoseEstimator(cam, device="cpu")
    assert est.min_matches == 8
    with pytest.raises(ValueError, match="Insufficient points"):
        est.compute_essential_matrix(pix1[:5], pix2[:5])
    res = est.compute_essential_matrix(pix1, pix2, uniforms=u)
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(ref.inliers))
    sign = np.sign(np.sum(res.essential.numpy() * np.asarray(ref.essential)))
    np.testing.assert_allclose(sign * res.essential.numpy(), np.asarray(ref.essential), rtol=0, atol=1e-8)
    r_est, t_est = est.recover_pose(res, pix1, pix2)
    r_ref, t_ref = ref_est.recover_pose(ref, pix1, pix2)
    np.testing.assert_allclose(r_est, r_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(t_est, t_ref, rtol=0, atol=1e-8)
    assert np.degrees(np.linalg.norm(Rotation.from_matrix(r_est @ r.T).as_rotvec())) < 0.1
    # A bare E: inliers from the 1 px Sampson band, in both packages.
    r_bare, _ = est.recover_pose(ref.essential, pix1, pix2)
    np.testing.assert_allclose(r_bare, ref_est.recover_pose(np.asarray(ref.essential), pix1, pix2)[0], atol=1e-8)
    # Seeded draws: the same seed gives the same result; calls advance it.
    a = PoseEstimator(cam, seed=3, device="cpu")
    b = PoseEstimator(cam, seed=3, device="cpu")
    first = a.compute_essential_matrix(pix1, pix2)
    torch.testing.assert_close(first.essential, b.compute_essential_matrix(pix1, pix2).essential)
    assert int(a.compute_essential_matrix(pix1, pix2).num_inliers) > 80
    with pytest.raises(ValueError, match="Too few inliers"):
        est.recover_pose(ref.essential, pix1[:7], pix2[:7])
    # Matched points from a Matches.
    kp1, kp2 = rng.uniform(0, 100, (6, 2)), rng.uniform(0, 100, (4, 2))
    m = Matches(torch.tensor([3, 0, 1, 1, 2, 0]), torch.zeros(6, dtype=torch.int32),
                torch.tensor([True, False, True, True, False, True]))
    p1, p2 = est.extract_matched_points(kp1, kp2, m)
    np.testing.assert_array_equal(p1, kp1[[0, 2, 3, 5]])
    np.testing.assert_array_equal(p2, kp2[[3, 1, 1, 0]])


def test_extract_matched_points_matches_jax(rng):
    kp1, kp2 = rng.uniform(0, 100, (8, 2)), rng.uniform(0, 100, (5, 2))
    idx, mask = rng.integers(0, 5, 8), rng.uniform(size=8) > 0.4
    ours = extract_matched_points(torch.from_numpy(kp1), torch.from_numpy(kp2), torch.from_numpy(idx),
                                  torch.from_numpy(mask))
    ref = j_extract(jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(idx), jnp.asarray(mask))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _motions(rng, n):
    rots = np.stack([Rotation.from_rotvec(rng.normal(0, 0.08, 3)).as_matrix() for _ in range(n)])
    trans = rng.normal(0, 0.1, (n, 3))
    trans[::3] *= 0.1
    return rots, trans


def test_keyframe_selector_and_scan_match_jax(rng):
    rots, trans = _motions(rng, 40)
    matches = rng.integers(40, 200, 40)
    for cfg_kw in ({}, dict(max_frames=4, min_translation=0.05, min_rotation=0.1, min_match_ratio=0.9)):
        jsel, sel = JKeyframeSelector(JKeyframeConfig(**cfg_kw)), KeyframeSelector(KeyframeConfig(**cfg_kw),
                                                                                   device="cpu")
        flags = [sel.should_be_keyframe(r, t, int(n)) for r, t, n in zip(rots, trans, matches)]
        assert flags == [jsel.should_be_keyframe(r, t, int(n)) for r, t, n in zip(rots, trans, matches)]
        assert sel.frames_since_last == jsel.frames_since_last
        sel.mark_as_keyframe(120)
        jsel.mark_as_keyframe(120)
        assert sel.should_be_keyframe(np.eye(3), np.zeros(3), 90) == jsel.should_be_keyframe(np.eye(3), np.zeros(3), 90)
        sel.reset()
        assert sel.frames_since_last == 0
        state, is_kf = select_keyframes(KeyframeConfig(**cfg_kw), torch.from_numpy(rots), torch.from_numpy(trans),
                                        torch.from_numpy(matches))
        j_state, j_kf = j_select(JKeyframeConfig(**cfg_kw), jnp.asarray(rots), jnp.asarray(trans),
                                 jnp.asarray(matches))
        np.testing.assert_array_equal(is_kf.numpy(), np.asarray(j_kf))
        assert is_kf.any() and not is_kf.all()
        assert [int(x) for x in state] == [int(x) for x in j_state]


def test_keyframe_selector_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (KeyframeSelector, lambda: slamtpu_torch.OrbDetector(),
                 lambda: PoseEstimator(CameraIntrinsics.kitti())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_hamming_functions_match_jax(rng):
    q = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    t = rng.integers(0, 256, (30, 32), dtype=np.uint8)
    t[5] = t[7]  # a tie for the top-2 order
    q[3] = t[5]
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    ref = np.asarray(jham.hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
    np.testing.assert_array_equal(tham.hamming_matrix(tq, tt).numpy(), ref)
    np.testing.assert_array_equal(tham.hamming_matrix_popcount(tq, tt).numpy(),
                                  np.asarray(jham.hamming_matrix_popcount(jnp.asarray(q), jnp.asarray(t))))
    np.testing.assert_array_equal(tham.hamming_matrix_popcount(tq, tt).numpy(), ref)
    for ours, theirs in zip(tham.match_best(tq, tt), jham.match_best(jnp.asarray(q), jnp.asarray(t))):
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    for ours, theirs in zip(tham.match_top2(tq, tt), jham.match_top2(jnp.asarray(q), jnp.asarray(t))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    idx, dist = tham.match_best(tq, tt[:0])
    j_idx, j_dist = jham.match_best(jnp.asarray(q), jnp.asarray(t[:0]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(j_dist))


def test_lie_and_positions_match_jax(rng):
    rots, trans = _motions(rng, 12)
    r_inv, t_inv = tlie.se3_inverse(torch.from_numpy(rots), torch.from_numpy(trans))
    j_r, j_t = jlie.se3_inverse(jnp.asarray(rots), jnp.asarray(trans))
    np.testing.assert_allclose(r_inv.numpy(), np.asarray(j_r), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(j_t), rtol=0, atol=1e-12)
    mats = tlie.se3_matrix(torch.from_numpy(rots), torch.from_numpy(trans))
    for ours, theirs in zip(tlie.rt_from_matrix(mats), jlie.rt_from_matrix(jnp.asarray(mats.numpy()))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    pos = positions_from_relative(torch.from_numpy(rots), torch.from_numpy(trans))
    assert pos.shape == (13, 3) and not pos[0].any()
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_positions(jnp.asarray(rots), jnp.asarray(trans))),
                               rtol=0, atol=1e-12)
