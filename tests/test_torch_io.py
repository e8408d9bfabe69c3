"""The port's I/O, evaluation and configuration modules against the JAX
package's: utils/evaluate.py to 1e-12 on seeded random trajectories;
utils/config.py (a JSON written by the JAX package loads, the six JAX-only
fields are dropped, any other unknown key raises, to_json round-trips);
io/kitti.py, io/video.py and io/native_loader.py byte-equal on KITTI, PNG,
PGM, JPG and video inputs written with cv2 (as tests/test_kitti.py and
tests/test_video_io.py write them), and two processes that build the
native library at once; io/synthetic.py::render_sequence_cached; io/real.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from slamtpu.feature.detector import OrbConfig as JOrbConfig
from slamtpu.io import kitti as jkitti
from slamtpu.io import native_loader as jnative
from slamtpu.io import real as jreal
from slamtpu.io import video as jvideo
from slamtpu.ops.ransac import RansacConfig as JRansacConfig
from slamtpu.utils import config as jconfig
from slamtpu.utils import evaluate as jeval
from slamtpu_torch import convert
from slamtpu_torch.io import kitti, native_loader, real, video
from slamtpu_torch.io.synthetic import render_sequence, render_sequence_cached
from slamtpu_torch.ops.ransac import RansacConfig
from slamtpu_torch.utils import config, evaluate

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _poses(rng, n):
    """[n, 4, 4] camera-to-world poses along a wandering path."""
    from scipy.spatial.transform import Rotation

    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = Rotation.from_rotvec(np.cumsum(rng.normal(scale=0.02, size=(n, 3)), 0)).as_matrix()
    out[:, :3, 3] = np.cumsum(rng.normal(loc=(0, 0, 8.0), size=(n, 3)), 0)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt = _poses(rng, 160)
    est = gt.copy()
    est[:, :3, 3] = 0.5 * gt[:, :3, 3] + rng.normal(scale=0.5, size=(160, 3))
    for with_scale in (True, False):
        for a, b in zip(evaluate.align_umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale),
                        jeval.align_umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for align in ("sim3", "se3", "none"):
        ours = evaluate.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align)
        assert abs(ours - jeval.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align)) <= 1e-12 * max(ours, 1.0)
    with pytest.raises(ValueError):
        evaluate.ate_rmse(est[:, :3, 3], gt[:, :3, 3], "affine")
    ours = evaluate.kitti_relative_errors(est[:, :3], gt, step=5)
    ref = jeval.kitti_relative_errors(est[:, :3], gt, step=5)
    assert ours.n_segments == ref.n_segments > 0
    for name in ("t_rel", "r_rel", "t_rel_percent", "r_rel_deg_per_100m"):
        assert abs(getattr(ours, name) - getattr(ref, name)) <= 1e-12 * max(abs(getattr(ref, name)), 1.0)
    short = evaluate.kitti_relative_errors(gt[:3], gt[:3])
    assert short.n_segments == 0 and np.isnan(short.t_rel)


def test_config_written_by_jax_loads(tmp_path):
    jcfg = jconfig.SlamConfig(orb=JOrbConfig(max_features=128, n_levels=4, exact_topk=True),
                              ransac=JRansacConfig(iters=96, min_solver="5pt", homography_iters=64),
                              fps=10.0, map_capacity=2048, ba_interval=3)
    jconfig.save_config(jcfg, str(tmp_path / "slam.json"))
    cfg = config.load_config(str(tmp_path / "slam.json"))
    assert cfg.orb.max_features == 128 and cfg.ransac.iters == 96 and cfg.map_capacity == 2048
    assert cfg.vo() == convert.config_from_jax(jcfg.vo())
    assert cfg.point_cloud() == convert.point_cloud_config_from_jax(jcfg.point_cloud())
    assert config.from_json(config.to_json(cfg)) == cfg
    config.save_config(cfg, str(tmp_path / "port.json"))
    assert config.load_config(str(tmp_path / "port.json")) == cfg
    # The port's JSON loads in the JAX package too, with the JAX defaults
    # for the fields the port drops.
    assert convert.config_from_jax(jconfig.load_config(str(tmp_path / "port.json")).vo()) == cfg.vo()


def test_config_unknown_keys_raise():
    assert config.from_json('{"orb": {"max_features": 99}, "fps": 5.0}') == config.SlamConfig(
        orb=dataclasses.replace(config.SlamConfig().orb, max_features=99), fps=5.0)
    with pytest.raises(ValueError, match="unknown config keys"):
        config.from_json('{"orb": {"max_feature": 99}}')
    with pytest.raises(ValueError, match="unknown config keys"):
        config.from_json('{"frames_per_second": 5.0}')


def test_config_unported_switch_raises_where_it_raises_today():
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.pipeline.vo import run_vo

    cfg = config.from_json('{"ransac": {"homography_fallback": true, "homography_ratio": 0.5}}')
    assert cfg.ransac == RansacConfig(homography_fallback=True)
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 96), dtype=np.uint8)
    with pytest.raises(NotImplementedError):
        run_vo(frames, CameraIntrinsics.kitti(), cfg.vo(), device="cpu")


def _kitti_dir(root, n=5, h=40, w=60):
    seq = root / "00"
    (seq / "image_0").mkdir(parents=True)
    frames = np.random.default_rng(0).integers(0, 256, size=(n, h, w), dtype=np.uint8)
    for i, f in enumerate(frames):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), f)
    cv2.imwrite(str(seq / "image_0" / "notes.jpg"), frames[0])  # not a PNG: not a frame
    (seq / "calib.txt").write_text("P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
                                   "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6e}\n" for i in range(n)))
    pose = np.hstack([np.eye(3), [[1.0], [2.0], [3.0]]])
    np.savetxt(seq / "poses.txt", np.stack([pose.ravel()] * n))
    return seq, frames


def test_kitti_sequence_matches_jax(tmp_path):
    seq, frames = _kitti_dir(tmp_path)
    ours, cam, times = kitti.load_sequence(str(seq), max_frames=4)
    ref, jcam, jtimes = jkitti.load_sequence(str(seq), max_frames=4)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, frames[:4])
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (jcam.fx, jcam.fy, jcam.cx, jcam.cy)
    np.testing.assert_array_equal(times, jtimes)
    assert kitti.load_calib(str(seq / "calib.txt"), 1) == kitti.load_calib(str(seq / "calib.txt"), 0)
    with pytest.raises(ValueError):
        kitti.load_calib(str(seq / "calib.txt"), 3)
    np.testing.assert_array_equal(kitti.load_poses(str(seq / "poses.txt")), jkitti.load_poses(str(seq / "poses.txt")))
    for skip in (0, 1):
        (a, acam, afps), (b, _, bfps) = (f(str(seq), max_frames=4, skip_frames=skip)
                                         for f in (video.load_frames, jvideo.load_frames))
        np.testing.assert_array_equal(a, b)
        assert afps == bfps and abs(afps - 10.0) < 1e-9 and acam == cam
    os.remove(seq / "times.txt")
    assert np.allclose(kitti.load_sequence(str(seq))[2], np.arange(5) / 10.0)


def _image_dir(root, exts):
    rng = np.random.default_rng(2)
    root.mkdir()
    for i, ext in enumerate(exts):
        img = rng.integers(0, 256, (40, 56), dtype=np.uint8)
        cv2.imwrite(str(root / f"{i:06d}.{ext}"), img)
    return str(root)


@pytest.mark.parametrize("exts", [("png", "pgm", "png", "pgm"), ("png", "pgm", "jpg", "png")],
                         ids=["native", "mixed"])
def test_image_directory_matches_jax(tmp_path, exts):
    d = _image_dir(tmp_path / "frames", exts)
    for kw in ({}, dict(max_frames=2, skip_frames=1)):
        (a, acam, afps), (b, bcam, bfps) = (f(d, **kw) for f in (video.load_frames, jvideo.load_frames))
        np.testing.assert_array_equal(a, b)
        assert acam is bcam is None and afps == bfps == 30.0
    assert a.shape == (2, 40, 56)
    with pytest.raises(ValueError, match="no image files"):
        video.load_frames(str(tmp_path))


def test_video_file_matches_jax(tmp_path):
    frames = (np.random.default_rng(1).uniform(0, 256, (8, 64, 80)).astype(np.uint8) // 16) * 16
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (80, 64), isColor=True)
    if not writer.isOpened():
        pytest.skip("no MJPG codec in this cv2")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    writer.release()
    for kw in ({}, dict(max_frames=3, skip_frames=1)):
        (a, acam, afps), (b, _, bfps) = (f(path, **kw) for f in (video.load_frames, jvideo.load_frames))
        np.testing.assert_array_equal(a, b)
        assert acam is None and afps == bfps and abs(afps - 10.0) < 0.5
    with pytest.raises(FileNotFoundError):
        video.load_frames(str(tmp_path / "missing.mp4"))


@pytest.fixture(scope="module")
def loader_dir(tmp_path_factory):
    """PGM, gray PNG and color PNG frames, as tests/test_native_loader.py
    writes them."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("frames")
    for i in range(12):
        img = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
        if i % 3 == 0:
            cv2.imwrite(str(d / f"f_{i:03d}.pgm"), img)
        elif i % 3 == 1:
            cv2.imwrite(str(d / f"f_{i:03d}.png"), img)
        else:
            cv2.imwrite(str(d / f"f_{i:03d}.png"), rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8))
    return str(d)


def test_native_loader_matches_jax(loader_dir, tmp_path):
    assert native_loader.native_available()
    np.testing.assert_array_equal(native_loader.load_frames_native(loader_dir),
                                  jnative.load_frames_native(loader_dir))
    paths = [os.path.join(loader_dir, n) for n in sorted(os.listdir(loader_dir))]
    with native_loader.NativeFrameLoader(paths, threads=3, prefetch=4) as a, \
            jnative.NativeFrameLoader(paths, threads=3, prefetch=4) as b:
        chunks = list(a.chunks(5))
        assert [c.shape[0] for c in chunks] == [5, 5, 2]
        np.testing.assert_array_equal(np.concatenate(chunks), np.concatenate(list(b.chunks(5))))
    with native_loader.NativeFrameLoader(paths, out_size=(24, 32), threads=2) as a, \
            jnative.NativeFrameLoader(paths, out_size=(24, 32), threads=2) as b:
        np.testing.assert_array_equal(a.read(12), b.read(12))
    with native_loader.NativeFrameLoader([paths[0], str(tmp_path / "missing.png")]) as a:
        assert a.read(2)[1].max() == 0
    lib = native_loader._lib_path()
    assert lib.parent == REPO / "build" / "slamtpu_torch" and lib.name.startswith("libframe_loader-")


def test_native_loader_builds_once_in_two_processes(tmp_path, loader_dir):
    """Two processes that build the library at once each load a whole
    library: each writes its own file and moves it into place."""
    code = (
        "import sys\nfrom pathlib import Path\nimport slamtpu_torch.io.native_loader as nl\n"
        f"nl.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        f"print(nl.load_frames_native({loader_dir!r}).sum())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    want = str(native_loader.load_frames_native(loader_dir).sum())
    assert [o[0].strip() for o in outs] == [want, want]
    assert [p.name for p in (tmp_path / "build").iterdir()] == [native_loader._lib_path().name]


def test_native_loader_raises_with_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "frame_loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_loader.NativeFrameLoader([str(bad)])
    assert not native_loader.native_available()
    assert list((tmp_path / "build").iterdir()) == []


def test_render_sequence_cached(tmp_path):
    kw = dict(n_frames=3, height=48, width=64, n_points=150, step=0.3, seed=1, render_depth=True)
    first = render_sequence_cached(cache_dir=str(tmp_path), **kw)
    (entry,) = os.listdir(tmp_path)
    assert entry.startswith("torch_scene_") and entry.endswith(".npz")
    second = render_sequence_cached(cache_dir=str(tmp_path), **kw)
    direct = render_sequence(**kw)
    for name in ("frames", "rotations", "translations", "rel_rotations", "rel_translations", "points", "depths"):
        np.testing.assert_array_equal(getattr(second, name), getattr(first, name))
        np.testing.assert_array_equal(getattr(second, name), getattr(direct, name))
    assert second.intrinsics == first.intrinsics == direct.intrinsics
    (tmp_path / entry).write_bytes(b"truncated")  # a corrupt entry renders again
    np.testing.assert_array_equal(render_sequence_cached(cache_dir=str(tmp_path), **kw).frames, direct.frames)


def test_real_image_matches_jax(tmp_path):
    try:
        ref = jreal.grace_hopper()
    except FileNotFoundError:
        pytest.skip("matplotlib's sample image is absent")
    np.testing.assert_array_equal(real.grace_hopper(), ref)
    path = str(tmp_path / "rgb.png")
    cv2.imwrite(path, np.random.default_rng(3).integers(0, 256, (20, 30, 3), dtype=np.uint8))
    np.testing.assert_array_equal(real.load_gray(path), jreal.load_gray(path))
