"""The depth-mapping pipeline in the port against the JAX package.

The geometry helpers on the same inputs: disp_to_depth and
backproject_depth at rtol 1e-5, with an absolute floor of 1e-5 of the
cloud's extent for coordinates that cancel to near zero (both packages
back-project in f32 and round in different orders; measured 5.4e-8 of the
extent), align_depth_scale exact (both are the same numpy code).
run_depth_mapping in both packages with the VO run replaced by one and the
same result (five-point RANSAC winners differ between the packages, ROADMAP
Queue 3) and ground-truth depth: the keyframe chain to 1e-12 and the cloud
point for point at the same bars, with and without scale alignment and the
max_points subsample (measured 7.3e-8 of the extent). Then the JAX
package's end-to-end ground-truth test (tests/test_depth_mapping.py) on the
port at its bar (median relative error < 0.15), load_frames, and a CPU
smoke of the depth CLI with --fuse-vo.
"""

import types

import numpy as np
import pytest
import torch

import slamtpu.pipeline.vo as jvo
from slamtpu.io.synthetic import render_sequence as j_render
from slamtpu.io.video import load_frames as j_load_frames
from slamtpu.odometry.camera import CameraIntrinsics as JCam
from slamtpu.pipeline import depth_mapping as jdm
from slamtpu_torch.feature.detector import OrbConfig
from slamtpu_torch.io.synthetic import render_sequence as t_render
from slamtpu_torch.io.video import load_frames
from slamtpu_torch.odometry.camera import CameraIntrinsics
from slamtpu_torch.ops.ransac import RansacConfig
from slamtpu_torch.pipeline import depth_mapping as tdm
from slamtpu_torch.pipeline.vo import VoConfig

torch.set_num_threads(1)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1.0))


def test_disp_to_depth_matches_jax():
    import jax.numpy as jnp

    disp = np.random.default_rng(0).uniform(0, 1, (17, 23)).astype(np.float32)
    _close(tdm.disp_to_depth(torch.from_numpy(disp)).numpy(), np.asarray(jdm.disp_to_depth(jnp.asarray(disp))))
    assert abs(float(tdm.disp_to_depth(torch.tensor(1.0))) - 0.1) < 1e-6
    assert abs(float(tdm.disp_to_depth(torch.tensor(0.0))) - 100.0) < 1e-4


@pytest.mark.parametrize("stride", [1, 3])
def test_backproject_matches_jax(stride):
    rng = np.random.default_rng(stride)
    cam = (610.0, 605.0, 160.5, 118.25)
    depth = rng.uniform(2.0, 40.0, (120, 161)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    angle = 0.3
    rot = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]])
    trans = np.array([0.4, -0.2, 3.0])
    pts_j, valid_j = jdm.backproject_depth(JCam(*cam), depth, rot.astype(np.float32), trans.astype(np.float32),
                                           stride=stride)
    pts_t, valid_t = tdm.backproject_depth(CameraIntrinsics(*cam), torch.from_numpy(depth), rot, trans, stride=stride)
    assert pts_t.dtype == torch.float32
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    _close(pts_t.numpy(), np.asarray(pts_j))


def test_align_depth_scale_matches_jax():
    cam = (500.0, 500.0, 320.0, 240.0)
    rng = np.random.default_rng(0)
    pts_cam = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-0.5, 0.5, 50), rng.uniform(0.2, 9, 50)], 1)
    depth = rng.uniform(0.0, 5.0, (480, 640)).astype(np.float32)
    s_t = tdm.align_depth_scale(depth, pts_cam, CameraIntrinsics(*cam))
    assert s_t == jdm.align_depth_scale(depth, pts_cam, JCam(*cam))
    assert tdm.align_depth_scale(depth, pts_cam[:0], CameraIntrinsics(*cam)) == 1.0


@pytest.fixture(scope="module")
def scene():
    return j_render(n_frames=12, height=192, width=256, n_points=500, step=1.0, seed=6, render_depth=True)


def _gt_depth(scene):
    def fn(frame):
        for i in range(scene.frames.shape[0]):
            if np.array_equal(np.asarray(frame), scene.frames[i]):
                return scene.depths[i]
        raise AssertionError("unknown frame")

    return fn


@pytest.mark.parametrize("case", ["plain", "scale_align", "max_points"])
def test_run_depth_mapping_matches_jax_on_one_vo_run(scene, monkeypatch, case):
    """Both packages read the same VO result: the scene's true relative
    poses (unit translations, as VO gives), every pair but the 4th a
    keyframe."""
    t = np.linalg.norm(scene.rel_translations, axis=1, keepdims=True)
    run = types.SimpleNamespace(
        is_keyframe=np.arange(len(t)) != 3, rotations=scene.rel_rotations, translations=scene.rel_translations / t)
    calls = []

    def fake_run_vo(frames, intrinsics, config=None, chunk_size=None, seed=0, device=None):
        calls.append((chunk_size, seed))
        return run

    monkeypatch.setattr(jvo, "run_vo", fake_run_vo)
    monkeypatch.setattr(tdm, "run_vo", fake_run_vo)
    kw = dict(stride=5, keyframe_stride=2)
    if case == "scale_align":
        kw.update(scale_align=True, landmarks_world=scene.points[:200])
    if case == "max_points":
        kw.update(max_points=700)
    cam = scene.intrinsics
    res_j = jdm.run_depth_mapping(scene.frames, cam, _gt_depth(scene), **kw)
    res_t = tdm.run_depth_mapping(scene.frames, CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy), _gt_depth(scene),
                                  device="cpu", **kw)
    assert calls == [(32, 0), (32, 0)]
    np.testing.assert_array_equal(res_t.keyframe_frame_idx, res_j.keyframe_frame_idx)
    np.testing.assert_allclose(res_t.keyframe_rotations, res_j.keyframe_rotations, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res_t.keyframe_translations, res_j.keyframe_translations, rtol=0, atol=1e-12)
    assert res_t.points.shape == res_j.points.shape and len(res_t.points) > 300
    if case == "max_points":
        assert len(res_t.points) == 700
    _close(res_t.points, res_j.points)


def test_semi_dense_cloud_matches_scene(tmp_path):
    """tests/test_depth_mapping.py's end-to-end check, on the port's VO."""
    scene = t_render(n_frames=12, height=192, width=256, n_points=500, step=1.0, seed=6, render_depth=True)
    cfg = VoConfig(orb=OrbConfig(max_features=250), ransac=RansacConfig(iters=200))
    res = tdm.run_depth_mapping(scene.frames, scene.intrinsics, _gt_depth(scene), vo_config=cfg, stride=6,
                                keyframe_stride=2, device="cpu")
    assert len(res.points) > 300
    assert res.vo_run.total_frames == 12
    d = np.linalg.norm(res.points[:, None, :] - scene.points[None, :, :], axis=-1)
    rel = d.min(axis=1) / np.maximum(np.linalg.norm(res.points, axis=1), 1.0)
    assert np.median(rel) < 0.15, f"median relative error {np.median(rel):.3f}"
    res.save_ply(str(tmp_path / "semi.ply"))
    with open(tmp_path / "semi.ply") as f:
        assert f.read(100).startswith("ply")


def test_load_frames(tmp_path):
    frames, cam, fps = load_frames("synthetic:5x64x96", max_frames=2, skip_frames=1)
    want, jcam, _ = j_load_frames("synthetic:5x64x96", max_frames=2, skip_frames=1)
    np.testing.assert_array_equal(frames, want)
    assert (cam.fx, cam.cy, fps) == (jcam.fx, jcam.cy, 30.0)
    np.save(tmp_path / "clip.npy", want)
    np.testing.assert_array_equal(load_frames(str(tmp_path / "clip.npy"))[0], want)
    with pytest.raises(ValueError, match="no image files"):
        load_frames(str(tmp_path))


def test_depth_cli_smoke_with_fuse_vo(tmp_path, capsys):
    from slamtpu_torch.cli.depth_estimation import main

    ply = tmp_path / "cloud.ply"
    main(["synthetic:6x96x128", "--random-init", "--width", "96", "--height", "64", "--device", "cpu",
          "--fuse-vo", str(ply)])
    out = capsys.readouterr().out
    assert "Frames processed: 6" in out
    ms = float(out.split("Average inference:")[1].split()[0])
    assert np.isfinite(ms) and ms > 0
    n = int(out.split("Semi-dense cloud:")[1].split()[0])
    with open(ply) as f:
        header = f.read(200)
    assert n > 0 and f"element vertex {n}\n" in header
    # Without the rerun package --rerun prints a notice and runs on.
    main(["synthetic:2x64x96", "--random-init", "--device", "cpu", "--rerun"])
    out = capsys.readouterr().out
    assert "rerun package not available; --rerun ignored" in out and "Frames processed: 2" in out
