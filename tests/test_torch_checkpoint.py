"""Checkpoints and resume in the port: map and pipeline-state round trips
(an empty observation log, a legacy log without landmark ids, no log),
split runs through a port checkpoint with both runners, and a JAX
package checkpoint carried across by `convert` and resumed by the port.

The runs use the flagship clip of tests/test_torch_point_cloud.py (17
textured frames of 200x160, seed 8, 96 features, 16 hypotheses, a 30-round
GN polish), split after frame 8: the second run starts at frame 8. The
keyframe chain is f64 in the fused runner, as in the JAX package under
x64. Bars: with BA off, the resumed fused run equals the resumed host loop
as the JAX package's own test holds them (rotations 1e-12, translations
1e-10, map and log exact); the port against the JAX package after a JAX
checkpoint: keyframes, BA runs and successes exact, the census within the
JAX package's fused-vs-host bars, poses within 5e-6 (rotations) and 1e-4
(translations); measured 580 vs 586 landmarks, 1206 vs 1217 observations,
9.4e-7 and 1.3e-5.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.io import checkpoint as jckpt
from slamtpu.io.synthetic import render_sequence as j_render
from slamtpu.pipeline import point_cloud as jpc
from slamtpu_torch import convert
from slamtpu_torch.io import checkpoint as tckpt
from slamtpu_torch.io.synthetic import render_sequence as t_render
from slamtpu_torch.mapping.map import Map
from slamtpu_torch.mapping.triangulation import MapPoint
from slamtpu_torch.odometry.camera import CameraIntrinsics
from slamtpu_torch.odometry.trajectory import Trajectory
from slamtpu_torch.pipeline import point_cloud as tpc
from test_torch_point_cloud import FEATURES, ITERS, SCENE, _jax_config  # the same clip, draws and config

torch.set_num_threads(1)

SPLIT = 8  # the first run ends at frame SPLIT, the resumed one starts there
RESUME_SEED = 5  # see test_jax_checkpoint_resumes_in_the_port
F64 = torch.float64


def _draws(seed, n_frames):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_frames - 1)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (ITERS, FEATURES), dtype=jnp.float32))(keys))


@pytest.fixture(scope="module")
def scene():
    return t_render(**SCENE)


def _map_state(n_points=5, capacity=16):
    m = Map(CameraIntrinsics.webcam_vga(), capacity=capacity, device="cpu")
    rng = np.random.default_rng(0)
    m.add_points([MapPoint(position=rng.normal(size=3) + [0, 0, 10],
                           descriptor=rng.integers(0, 256, 32).astype(np.uint8)) for _ in range(n_points)])
    m.update_observations([(1, 0), (3, 0)])
    return m.state


def _assert_maps_equal(a, b):
    for field in a._fields:
        assert torch.equal(torch.as_tensor(getattr(a, field)).cpu(), torch.as_tensor(getattr(b, field)).cpu()), field


def test_map_roundtrip(tmp_path):
    state = _map_state()
    tckpt.save_map(str(tmp_path / "map"), state)
    restored = tckpt.load_map(str(tmp_path / "map"), device="cpu")
    _assert_maps_equal(restored, state)
    assert restored.positions.dtype == torch.float32 and restored.ids.dtype == torch.int32


@pytest.mark.parametrize("log", ["full", "empty", "legacy", "none"])
def test_pipeline_state_roundtrip(tmp_path, log):
    state = _map_state()
    traj = Trajectory()
    traj.update(np.eye(3), [1.0, 0.0, 0.5], 1, 0.1)
    kf_r = np.stack([np.eye(3)] * 3)
    kf_t = np.random.default_rng(1).normal(size=(3, 3))
    px = np.array([[10.0, 20.0], [11.0, 21.0], [12.0, 22.0]], np.float32)
    observations = {
        "full": (np.array([1, 1, 2], np.int32), np.array([0, 3, 3], np.int32), px, np.array([0, 3, 7], np.int32)),
        "empty": (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 2), np.float32), np.zeros(0, np.int32)),
        "legacy": ([1, 2], [0, 3], list(px[:2])),
        "none": None,
    }[log]
    tckpt.save_pipeline_state(str(tmp_path / "ck"), state, kf_r, kf_t, [0, 5, 9], traj, observations)
    ms, r, t, frames, traj2, obs = tckpt.load_pipeline_state(str(tmp_path / "ck"), device="cpu")
    _assert_maps_equal(ms, state)
    np.testing.assert_array_equal(r, kf_r)
    np.testing.assert_array_equal(t, kf_t)
    assert frames.tolist() == [0, 5, 9]
    assert traj2.to_json() == traj.to_json()
    np.testing.assert_array_equal(traj2.global_pose, traj.global_pose)
    assert json.loads((tmp_path / "ck" / "trajectory.json").read_text())[1]["frame"] == 1
    if log == "none":
        assert obs is None
        return
    if log == "legacy":  # no ids saved: the ids the slots hold now
        observations = (*observations, state.ids.numpy()[[0, 3]])
    for got, want in zip(obs, observations):
        np.testing.assert_array_equal(got, np.asarray(want).reshape(got.shape))
    assert obs[2].shape == (len(obs[0]), 2)


def _cfg(ba_interval):
    return convert.point_cloud_config_from_jax(_jax_config(ba_interval))


def _split(scene, ba_interval, tmp_path, first_runner=tpc.run_point_cloud_fused):
    """The first part's run (seed 0), checkpointed."""
    kw = {"pose_dtype": F64} if first_runner is tpc.run_point_cloud_fused else {}
    first = first_runner(scene.frames[: SPLIT + 1], scene.intrinsics, _cfg(ba_interval), seed=0, device="cpu", **kw)
    first.save_checkpoint(str(tmp_path / "ck"))
    return first


def _resume(scene, ba_interval, tmp_path, runner, uniforms=None):
    kw = {"pose_dtype": F64} if runner is tpc.run_point_cloud_fused else {}
    return runner(scene.frames[SPLIT:], scene.intrinsics, _cfg(ba_interval), seed=1, device="cpu",
                  resume_from=str(tmp_path / "ck"), uniforms=uniforms, **kw)


def test_resumed_fused_equals_resumed_host_loop_without_ba(scene, tmp_path):
    first = _split(scene, 0, tmp_path)
    host = _resume(scene, 0, tmp_path, tpc.run_point_cloud)
    fused = _resume(scene, 0, tmp_path, tpc.run_point_cloud_fused)
    n_first = len(first.keyframe_frame_idx)
    assert len(fused.keyframe_frame_idx) > n_first and len(fused.points()) > len(first.points())
    np.testing.assert_array_equal(host.keyframe_frame_idx, fused.keyframe_frame_idx)
    np.testing.assert_array_equal(fused.keyframe_frame_idx[:n_first], first.keyframe_frame_idx)
    np.testing.assert_allclose(host.keyframe_rotations, fused.keyframe_rotations, rtol=0, atol=1e-12)
    np.testing.assert_allclose(host.keyframe_translations, fused.keyframe_translations, rtol=0, atol=1e-10)
    assert torch.equal(host.map_state.valid, fused.map_state.valid)
    assert torch.equal(host.map_state.ids, fused.map_state.ids)
    for a, b in zip(host.observations, fused.observations):
        np.testing.assert_array_equal(a, b)
    # The log continues the restored one; the trajectory continues too.
    for a, b in zip(fused.observations, first.observations):
        np.testing.assert_array_equal(a[: len(b)], b)
    assert len(fused.trajectory) == len(host.trajectory) == len(first.trajectory) + len(fused.keyframe_frame_idx) - n_first


def test_resume_with_ba(scene, tmp_path):
    """The fused runner's first window after a resume holds only keyframes
    created after it, so the restored chain stays as it was; BA fires after
    the resume in both runners."""
    first = _split(scene, 3, tmp_path)
    assert first.ba_runs >= 2
    n_first = len(first.keyframe_frame_idx)
    for runner in (tpc.run_point_cloud_fused, tpc.run_point_cloud):
        resumed = _resume(scene, 3, tmp_path, runner)
        assert len(resumed.keyframe_frame_idx) > n_first and resumed.ba_runs >= 1
        assert len(resumed.points()) > len(first.points())
        # The host loop's first window may reach back ba_window - 1
        # keyframes before the resume; the fused runner's never does.
        keep = n_first if runner is tpc.run_point_cloud_fused else n_first - 4
        np.testing.assert_array_equal(resumed.keyframe_rotations[:keep], first.keyframe_rotations[:keep])
        np.testing.assert_array_equal(resumed.keyframe_translations[:keep], first.keyframe_translations[:keep])


def test_resume_refuses_another_map_capacity(scene, tmp_path):
    _split(scene, 0, tmp_path, first_runner=tpc.run_point_cloud)
    cfg = dataclasses.replace(_cfg(0), map_capacity=1024)
    for runner in (tpc.run_point_cloud, tpc.run_point_cloud_fused):
        with pytest.raises(ValueError, match="capacity"):
            runner(scene.frames[SPLIT:], scene.intrinsics, cfg, device="cpu", resume_from=str(tmp_path / "ck"))


def test_jax_checkpoint_resumes_in_the_port(scene, tmp_path):
    """A JAX package checkpoint (orbax), loaded by the JAX package, carried
    across by convert, saved by the port and resumed by the port's fused
    runner, against the JAX package's fused resume from the same
    checkpoint, on the same RANSAC draws. The second part draws from seed
    5: of seeds 0-7 it is the one on which both packages' f32 RANSAC elect
    the same winner for every pair of that part (ROADMAP Queue 3; the
    others end with the same keyframes but poses up to a degree apart)."""
    jscene = j_render(**SCENE)
    jcfg = _jax_config(0)
    jfirst = jpc.run_point_cloud_fused(jscene.frames[: SPLIT + 1], jscene.intrinsics, jcfg, seed=0, chunk_size=SPLIT)
    jfirst.save_checkpoint(str(tmp_path / "jax_ck"))
    ref = jpc.run_point_cloud_fused(jscene.frames[SPLIT:], jscene.intrinsics, jcfg, seed=RESUME_SEED, chunk_size=SPLIT,
                                    resume_from=str(tmp_path / "jax_ck"))

    map_state, kf_r, kf_t, kf_frames, traj, obs = jckpt.load_pipeline_state(str(tmp_path / "jax_ck"))
    carried = convert.point_cloud_result_from_numpy(types.SimpleNamespace(
        map_state=map_state, trajectory=traj, keyframe_rotations=kf_r, keyframe_translations=kf_t,
        keyframe_frame_idx=np.asarray(kf_frames), ba_runs=0, total_frames=SPLIT + 1, successful_frames=0,
        observations=obs), device="cpu")
    carried.save_checkpoint(str(tmp_path / "ck"))
    _assert_maps_equal(tckpt.load_pipeline_state(str(tmp_path / "ck"), device="cpu")[0], map_state)

    ours = tpc.run_point_cloud_fused(scene.frames[SPLIT:], scene.intrinsics, _cfg(0), chunk_size=SPLIT, device="cpu",
                                     resume_from=str(tmp_path / "ck"), uniforms=_draws(RESUME_SEED, len(scene.frames) - SPLIT),
                                     pose_dtype=F64)
    np.testing.assert_array_equal(ours.keyframe_frame_idx, ref.keyframe_frame_idx)
    assert ours.ba_runs == ref.ba_runs and ours.successful_frames == ref.successful_frames
    assert len(ours.trajectory) == len(ref.trajectory)
    n_ours, n_ref = int(ours.map_state.valid.sum()), int(np.asarray(ref.map_state.valid).sum())
    assert abs(n_ours - n_ref) <= max(3, 0.02 * n_ref), (n_ours, n_ref)
    o_ours, o_ref = len(ours.observations[0]), len(ref.observations[0])
    assert abs(o_ours - o_ref) <= 0.05 * o_ref, (o_ours, o_ref)
    np.testing.assert_allclose(ours.keyframe_rotations, ref.keyframe_rotations, rtol=0, atol=5e-6)
    np.testing.assert_allclose(ours.keyframe_translations, ref.keyframe_translations, rtol=0, atol=1e-4)
