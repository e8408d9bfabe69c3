"""utils/metrics.py and utils/viz.py of the port against the JAX package's:
MetricsLog, StepTimer, draw_match_image and draw_trajectory give the same
records, numbers and pixels; force_sync and profile_trace on the CPU;
RerunLogger against a fake `rerun` module (the fixture of
tests/test_rerun.py), unit by unit and wired through the port's
run_point_cloud, whose sequence of logged events must equal the JAX host
loop's on the same clip and RANSAC draws; the depth CLI's --rerun."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.io.synthetic import render_sequence as j_render
from slamtpu.odometry.trajectory import Trajectory as JTrajectory
from slamtpu.pipeline import point_cloud as jpc
from slamtpu.utils import metrics as jmetrics
from slamtpu.utils import viz as jviz
from slamtpu_torch import convert
from slamtpu_torch.io.synthetic import render_sequence as t_render
from slamtpu_torch.odometry.trajectory import Trajectory
from slamtpu_torch.pipeline import point_cloud as tpc
from slamtpu_torch.utils import metrics, viz
from test_rerun import _events, fake_rerun  # noqa: F401  (the fixture)
from test_torch_point_cloud import CHUNK, FEATURES, ITERS, SCENE, _jax_config

torch.set_num_threads(1)


def test_metrics_log_matches_jax(capsys):
    ours, ref = metrics.MetricsLog(print_every=2), jmetrics.MetricsLog(print_every=2)
    for log in (ours, ref):
        for step in range(5):
            log.log(step, fps=10.0 + step, matches=step * 3, note="x")
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[: len(lines) // 2] == lines[len(lines) // 2 :] and "Step     2 | fps: 12.0" in out
    assert ours.records == ref.records
    assert ours.summary() == ref.summary() == {"fps": 12.0, "matches": 6.0}
    assert metrics.MetricsLog().summary() == {}


def test_step_timer_matches_jax(monkeypatch):
    ticks = [1.0, 1.5, 2.0, 2.25, 3.0, 4.0]
    monkeypatch.setattr(metrics.time, "perf_counter", iter(ticks).__next__)
    monkeypatch.setattr(jmetrics.time, "time", iter(ticks).__next__)
    ours, ref = metrics.StepTimer(), jmetrics.StepTimer()
    for timer in (ours, ref):
        for items in (1, 2, 4):
            timer.start()
            timer.stop(items=items)
    assert ours.times == ref.times
    assert ours.fps() == ref.fps() and ours.ms() == ref.ms() and ours.ms(skip=0) == ref.ms(skip=0)
    assert metrics.StepTimer().fps() == 0.0


def test_force_sync_walks_results_on_the_cpu():
    tree = {"a": torch.zeros(2), "b": [torch.ones(1), (np.zeros(1), None)], "c": 3}
    assert metrics.force_sync(tree) is tree
    assert len(list(metrics._tensors(tree))) == 2
    timer = metrics.StepTimer()
    timer.start()
    assert timer.stop(tree) >= 0.0


def test_draw_match_image_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (30, 40), dtype=np.uint8)
    b = rng.integers(0, 256, (34, 44, 3), dtype=np.uint8)
    p1 = rng.uniform(-5, 45, (250, 2))
    p2 = rng.uniform(-5, 45, (240, 2))
    ours = metrics.draw_match_image(torch.from_numpy(a), b, p1, p2)
    np.testing.assert_array_equal(ours, jmetrics.draw_match_image(a, b, p1, p2))
    np.testing.assert_array_equal(metrics._depth_colors(np.linspace(-5, 60, 50)),
                                  jmetrics._depth_colors(np.linspace(-5, 60, 50)))


def _trajectories(n):
    ours, ref = Trajectory(), JTrajectory()
    rng = np.random.default_rng(n)
    for i in range(1, n):
        r = np.linalg.qr(rng.normal(size=(3, 3)))[0] if i % 3 == 0 else np.eye(3)
        t = rng.normal(size=3)
        ours.update(r, t, i, 0.1 * i)
        ref.update(r, t, i, 0.1 * i)
    return ours, ref


@pytest.mark.parametrize("n", [1, 2, 12])
def test_draw_trajectory_matches_jax(n, tmp_path):
    cv2 = pytest.importorskip("cv2")
    ours, ref = _trajectories(n)
    np.testing.assert_array_equal(viz.draw_trajectory(ours, 200, 150), jviz.draw_trajectory(ref, 200, 150))
    viz.save_trajectory_plot(ours, str(tmp_path / "t.png"), 200, 150)
    jviz.save_trajectory_plot(ref, str(tmp_path / "j.png"), 200, 150)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")), cv2.imread(str(tmp_path / "j.png")))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    assert json.load(open(path))["traceEvents"]


def _replay(fake, logger):
    """Call every logger method once, in a fixed order; return the events."""
    logger.set_frame(7)
    logger.log_frame(np.zeros((4, 6), np.uint8))
    logger.log_camera(np.eye(3), np.array([1.0, 2.0, 3.0]))
    logger.log_matches_2d(np.zeros((150, 2)), np.ones((150, 2)))
    logger.log_matches_image(np.zeros((8, 10), np.uint8), np.zeros((8, 12), np.uint8),
                             np.array([[2.0, 3.0]]), np.array([[4.0, 5.0]]))
    logger.log_points(np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 50.0]]))
    logger.log_trajectory(np.zeros((1, 3)))
    logger.log_trajectory(np.zeros((5, 3)))
    logger.log_depth(np.zeros((4, 6), np.uint8), np.zeros((2, 3, 3), np.uint8), 3)
    return list(fake.events), list(fake.times)


def _same_payload(a, b):
    assert a.kind == b.kind and len(a.args) == len(b.args) and set(a.kwargs) == set(b.kwargs)
    for x, y in list(zip(a.args, b.args)) + [(a.kwargs[k], b.kwargs[k]) for k in a.kwargs]:
        np.testing.assert_array_equal(np.asarray(x, dtype=object if isinstance(x, str) else None),
                                      np.asarray(y, dtype=object if isinstance(y, str) else None))


def test_logger_unit_surface_matches_jax(fake_rerun):  # noqa: F811
    ours = _replay(fake_rerun, metrics.RerunLogger(save_path="fake.rrd"))
    fake_rerun.events.clear()
    fake_rerun.times.clear()
    ref = _replay(fake_rerun, jmetrics.RerunLogger(save_path="fake.rrd"))
    assert fake_rerun.inits == ["slamtpu", "slamtpu"] and fake_rerun.saves == ["fake.rrd"] * 2
    assert ours[1] == ref[1] == [("frame", 7)]
    assert ours[0][0] == ref[0][0] == ("world", "RUB", True)  # static view coordinates
    assert [(e, p.kind, s) for e, p, s in ours[0][1:]] == [(e, p.kind, s) for e, p, s in ref[0][1:]]
    for (_, p, _), (_, q, _) in zip(ours[0][1:], ref[0][1:]):
        _same_payload(p, q)
    # The payload parameters the reference viewer uses.
    ((_, green),) = [(e, p) for e, p, _ in ours[0] if e == "world/camera/image/kp_prev"]
    assert green.args[0].shape == (100, 2) and green.kwargs["colors"] == [[0, 255, 0]]


def test_logger_inactive_without_rerun():
    assert "rerun" not in sys.modules
    logger = metrics.RerunLogger()
    assert not logger.active and not metrics.RerunLogger(enabled=False).active
    logger.set_frame(1)
    logger.log_frame(np.zeros((2, 2)))
    logger.log_camera(np.eye(3), np.zeros(3))
    logger.log_matches_2d(np.zeros((1, 2)), np.zeros((1, 2)))
    logger.log_matches_image(np.zeros((2, 2)), np.zeros((2, 2)), [], [])
    logger.log_points(np.zeros((1, 3)))
    logger.log_trajectory(np.zeros((3, 3)))
    logger.log_depth(np.zeros((2, 2)), np.zeros((2, 2, 3)), 0)


def test_logger_wired_through_run_point_cloud_matches_jax(fake_rerun):  # noqa: F811
    """The port's host loop logs the same events, in the same order and at
    the same frames, as the JAX host loop on the same clip and draws (the
    clip of tests/test_torch_point_cloud.py, where both elect the same
    RANSAC winners)."""
    scene, jscene = t_render(**SCENE), j_render(**SCENE)
    keys = jax.random.split(jax.random.PRNGKey(0), SCENE["n_frames"] - 1)
    draws = np.array(jax.vmap(lambda k: jax.random.uniform(k, (ITERS, FEATURES), dtype=jnp.float32))(keys))
    ours = tpc.run_point_cloud(scene.frames, scene.intrinsics, convert.point_cloud_config_from_jax(_jax_config(5)),
                               chunk_size=CHUNK, device="cpu", uniforms=draws, pose_dtype=torch.float64,
                               rerun_logger=metrics.RerunLogger(save_path="x.rrd"))
    ours_events, ours_times = list(fake_rerun.events), list(fake_rerun.times)
    fake_rerun.events.clear()
    fake_rerun.times.clear()
    ref = jpc.run_point_cloud(jscene.frames, jscene.intrinsics, _jax_config(5), chunk_size=CHUNK,
                              rerun_logger=jmetrics.RerunLogger(save_path="x.rrd"))
    np.testing.assert_array_equal(ours.keyframe_frame_idx, ref.keyframe_frame_idx)
    assert ours.ba_runs == ref.ba_runs > 0
    assert ours_times == fake_rerun.times
    assert ([(e, getattr(p, "kind", p)) for e, p, _ in ours_events]
            == [(e, getattr(p, "kind", p)) for e, p, _ in fake_rerun.events])
    n_kf = len(ours.keyframe_frame_idx) - 1
    assert len(_events(fake_rerun, "world/camera", "Transform3D")) == n_kf >= 3
    # The frame images are the clip's own, gray expanded to RGB.
    frames = [p.args[0] for e, p, _ in ours_events if e == "world/camera/image"]
    assert len(frames) == SCENE["n_frames"] - 1
    np.testing.assert_array_equal(frames[0][..., 0], scene.frames[1])
    cams = [(p, q) for (e, p, _), (_, q, _) in zip(ours_events, fake_rerun.events) if e == "world/camera"]
    for p, q in cams:
        np.testing.assert_allclose(p.kwargs["mat3x3"], q.kwargs["mat3x3"], atol=5e-3)


def test_depth_cli_rerun(fake_rerun, capsys):  # noqa: F811
    from slamtpu_torch.cli.depth_estimation import main

    main(["synthetic:2x96x128", "--random-init", "--batch", "2", "--width", "64", "--height", "64", "--rerun",
          "--device", "cpu"])
    rgb = _events(fake_rerun, "camera/rgb", "Image")
    depth = _events(fake_rerun, "camera/depth_colored", "Image")
    info = _events(fake_rerun, "info", "TextDocument")
    assert len(rgb) == len(depth) == len(info) == 2
    assert rgb[0][1].args[0].shape == (96, 128, 3)
    d = depth[0][1].args[0]
    assert d.shape == (64, 64, 3) and d.dtype == np.uint8  # the model's size
    assert info[1][1].args[0] == "Frame: 1"
    assert ("frame", 1) in fake_rerun.times
