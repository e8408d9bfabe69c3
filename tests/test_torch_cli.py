"""The port's CLIs, driven in-process with --device cpu on the clips of
tests/test_cli.py: every test there has a counterpart here. The VO CLI's
trajectory equals a direct run_vo's; its --gt ATE is evaluate.ate_rmse's;
a KITTI-layout directory written by chip_smoke.py's stdlib PNG writer
reads back byte-equal and drives the VO CLI; every CLI defaults to CUDA."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slamtpu_torch.feature.detector import OrbConfig
from slamtpu_torch.io.video import load_frames
from slamtpu_torch.pipeline.vo import VoConfig, run_vo

torch.set_num_threads(1)
CLIP = "synthetic:10x120x160"
REPO = Path(__file__).resolve().parents[1]


def test_main_smoke(capsys):
    from slamtpu_torch.cli.main import main

    main(["synthetic:8x120x160", "--max-features", "128", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Opened synthetic:8x120x160: 8 frames 120x160" in out
    mean = float(out.rsplit("mean features/frame:", 1)[1])
    assert mean > 16, out


def test_visualize_features_smoke(tmp_path, monkeypatch, capsys):
    cv2 = pytest.importorskip("cv2")
    from slamtpu_torch.cli.visualize_features import main

    monkeypatch.chdir(tmp_path)
    main(["synthetic:6x120x160", "--max-features", "128", "--max-frames", "6", "--device", "cpu",
          "--save-overlays", str(tmp_path / "overlays")])
    out = capsys.readouterr().out
    assert "Mean good matches/pair:" in out
    assert float(out.split("Mean good matches/pair:")[1]) > 8
    pngs = sorted((tmp_path / "overlays").glob("matches_*.png"))
    assert len(pngs) == 5
    assert cv2.imread(str(pngs[0])).shape == (120, 2 * 160, 3)


def test_visual_odometry_smoke(tmp_path, monkeypatch, capsys):
    pytest.importorskip("cv2")  # --plot renders through cv2
    from slamtpu_torch.cli.visual_odometry import main

    monkeypatch.chdir(tmp_path)
    main([CLIP, "--max-features", "128", "--chunk", "8", "--device", "cpu", "--output", str(tmp_path / "traj.json"),
          "--plot", str(tmp_path / "traj.png")])
    out = capsys.readouterr().out
    for line in ("Total frames:", "Successful poses:", "Keyframes selected:", "Average FPS:"):
        assert line in out
    traj = json.loads((tmp_path / "traj.json").read_text())
    assert set(traj[0]) == {"frame", "position", "timestamp"}
    assert (tmp_path / "traj.png").exists()
    # The CLI's trajectory is run_vo's on the same frames and settings.
    frames, cam, fps = load_frames(CLIP)
    run = run_vo(frames, cam, VoConfig(orb=OrbConfig(max_features=128), fps=fps), chunk_size=8, device="cpu")
    assert (tmp_path / "traj.json").read_text() == run.trajectory.to_json()
    assert f"Successful poses: {run.successful_frames}\n" in out and len(traj) == run.keyframe_count + 1 > 5


def test_visual_odometry_config_file(tmp_path, monkeypatch, capsys):
    """--config loads a SlamConfig JSON written by the JAX package."""
    from slamtpu.feature.detector import OrbConfig as JOrbConfig
    from slamtpu.ops.ransac import RansacConfig as JRansacConfig
    from slamtpu.utils.config import SlamConfig, save_config
    from slamtpu_torch.cli.visual_odometry import main

    save_config(SlamConfig(orb=JOrbConfig(max_features=128, n_levels=4), ransac=JRansacConfig(iters=128)),
                str(tmp_path / "slam.json"))
    monkeypatch.chdir(tmp_path)
    main([CLIP, "--chunk", "8", "--device", "cpu", "--output", str(tmp_path / "t.json"),
          "--config", str(tmp_path / "slam.json")])
    out = capsys.readouterr().out
    assert "Successful poses:" in out
    assert (tmp_path / "t.json").exists()


def test_visual_odometry_gt_eval(tmp_path, monkeypatch, capsys):
    from slamtpu_torch.cli.visual_odometry import main
    from slamtpu_torch.utils.evaluate import ate_rmse

    rows = [np.hstack([np.eye(3), [[0.0], [0.0], [float(i)]]]).reshape(-1) for i in range(10)]
    np.savetxt(tmp_path / "poses.txt", np.asarray(rows))
    monkeypatch.chdir(tmp_path)
    main([CLIP, "--max-features", "128", "--chunk", "8", "--device", "cpu", "--output", str(tmp_path / "t.json"),
          "--gt", str(tmp_path / "poses.txt")])
    out = capsys.readouterr().out
    ate = float(out.split("keyframes):")[1].split("m")[0])
    assert np.isfinite(ate) and ate < 1.0, out
    traj = json.loads((tmp_path / "t.json").read_text())
    est = np.asarray([p["position"] for p in traj])
    gt = np.asarray([[0.0, 0.0, float(max(p["frame"] - 1, 0))] for p in traj])
    assert f"{ate_rmse(est, gt):.3f}" == f"{ate:.3f}"


def test_visual_odometry_on_a_kitti_directory(tmp_path, monkeypatch, capsys):
    """A KITTI-layout sequence as chip_smoke.py writes it (stdlib PNGs,
    calib.txt, times.txt at 10 Hz, camera-to-world poses.txt) reads back
    byte-equal, with its intrinsics and fps, and drives the VO CLI."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import write_kitti_sequence
    from slamtpu_torch.cli.visual_odometry import main
    from slamtpu_torch.io.synthetic import render_sequence

    scene = render_sequence(n_frames=9, height=120, width=160, n_points=500, step=0.3, seed=2)
    seq, poses = write_kitti_sequence(str(tmp_path / "00"), scene)
    frames, cam, fps = load_frames(seq)
    np.testing.assert_array_equal(frames, scene.frames)
    assert cam == scene.intrinsics and abs(fps - 10.0) < 1e-9
    c2w = np.loadtxt(poses).reshape(-1, 3, 4)
    np.testing.assert_allclose(np.einsum("tij,tjk->tik", c2w[:, :, :3], scene.rotations), np.tile(np.eye(3), (9, 1, 1)),
                               atol=1e-12)
    np.testing.assert_allclose(c2w[:, :, 3], -np.einsum("tji,tj->ti", scene.rotations, scene.translations), atol=1e-12)
    monkeypatch.chdir(tmp_path)
    main([seq, "--max-features", "128", "--chunk", "4", "--device", "cpu", "--gt", poses])
    out = capsys.readouterr().out
    assert "Loaded 9 frames 120x160" in out and f"fx={scene.intrinsics.fx}" in out
    assert np.isfinite(float(out.split("keyframes):")[1].split("m")[0]))


def test_draw_trajectory_semantics():
    pytest.importorskip("cv2")
    from slamtpu_torch.odometry.trajectory import Trajectory
    from slamtpu_torch.utils.viz import draw_trajectory

    traj = Trajectory()
    img = draw_trajectory(traj, 200, 150)
    assert img.shape == (150, 200, 3) and (img == 255).all()
    for i in range(1, 11):
        traj.update(np.eye(3), np.array([0.0, 0.0, 1.0]), i, float(i))
    img = draw_trajectory(traj, 200, 150)
    assert tuple(img[150 - 20, 20]) == (0, 255, 0)
    assert tuple(img[150 - 20 - int(10 * (150 - 40) / 10.0), 20]) == (255, 0, 0)
    col = img[:, 20:23].reshape(-1, 3)
    line_px = col[(col != 255).any(axis=1)]
    assert (line_px[:, 2] > 0).any() and (line_px[:, 0] > 0).any()


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_point_cloud_smoke(tmp_path, monkeypatch, capsys, fused):
    from slamtpu_torch.cli.point_cloud import main

    monkeypatch.chdir(tmp_path)
    main([CLIP, "--max-features", "128", "--chunk", "8", "--map-capacity", "2048", "--device", "cpu",
          "--checkpoint", str(tmp_path / "ckpt")] + (["--fused"] if fused else ["--global-ba"]))
    out = capsys.readouterr().out
    for line in ("Keyframes:", "3D map points:", "Bundle Adjustment runs:"):
        assert line in out
    for artifact in ("point_cloud.ply", "point_cloud.json", "trajectory_output.json"):
        assert (tmp_path / artifact).exists(), artifact
    header = (tmp_path / "point_cloud.ply").read_text().splitlines()
    assert header[0] == "ply" and "format ascii 1.0" in header[1]
    assert os.listdir(tmp_path / "ckpt")
    assert int(out.split("Bundle Adjustment runs:")[1].split()[0]) > 0
    if not fused:
        assert "Global BA: reprojection error" in out
        main([CLIP, "--max-features", "128", "--chunk", "8", "--map-capacity", "2048", "--device", "cpu",
              "--resume", str(tmp_path / "ckpt")])
        assert int(capsys.readouterr().out.split("Keyframes:")[1].split()[0]) > int(out.split("Keyframes:")[1].split()[0])


def test_point_cloud_fused_rejects_rerun():
    from slamtpu_torch.cli.point_cloud import main

    with pytest.raises(SystemExit):
        main([CLIP, "--fused", "--rerun", "--device", "cpu"])


def test_bundle_adjustment_smoke(capsys):
    from slamtpu_torch.cli.bundle_adjustment import main

    main(["--poses", "4", "--points", "4", "--iterations", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    initial = float(out.split("Initial reprojection error:")[1].split()[0])
    final = float(out.split("Final reprojection error:")[1].split()[0])
    assert final < 0.5 * initial, out
    assert "Local BA (window=2)" in out


def test_depth_estimation_smoke(capsys):
    from slamtpu_torch.cli.depth_estimation import main

    main(["synthetic:4x120x160", "--random-init", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Frames processed: 4" in out
    ms = float(out.split("Average inference:")[1].split()[0])
    assert np.isfinite(ms) and ms > 0


@pytest.mark.parametrize("name,argv", [
    ("main", ["synthetic:2x64x64"]), ("visual_odometry", ["synthetic:2x64x64"]),
    ("point_cloud", ["synthetic:2x64x64"]), ("visualize_features", ["synthetic:2x64x64"]),
    ("bundle_adjustment", []), ("depth_estimation", ["synthetic:2x64x64", "--random-init"]),
])
def test_clis_default_to_cuda(monkeypatch, name, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"slamtpu_torch.cli.{name}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
