"""The port's multi-device layer (slamtpu_torch/parallel/) on four Gloo
ranks on the CPU, against its own serial runners and the JAX package's
sharded runners on 8 virtual CPU devices.

The ranks are spawned once for the module (tests/torch_parallel_worker.py,
mode "parallel") and pickle their results; while they run, this process
computes the references: the JAX sharded_vo_step and
run_point_cloud_sharded on test_sharding.py's scenes and configurations
(16 frames of 160x224, 500 points, step 0.5; 200 features, 150
hypotheses), and the port's run_vo and run_point_cloud_fused.

Tolerances. On the same draws the port's sharded VO equals its run_vo:
success, matches and keyframes exact, rotations within 1e-5 (the detector
and RANSAC see the same batches), positions at f64 within 1e-9 (the prefix
product is associated differently). Against the JAX package: success and
the state-dependent keyframe schedule exact; rotations within 0.1 degree
(tests/test_torch_vo.py's bar) except on pairs where f32 rounding elects
another five-point winner (ROADMAP A1), which are re-solved at f64 by both
packages and held to 1e-8. The flagship runners are held to
tests/test_sharding.py's bars.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.odometry.camera import CameraIntrinsics as JCam
from slamtpu.odometry.pose import estimate_relative_pose as j_pose
from slamtpu.parallel.flagship import run_point_cloud_sharded as j_run_point_cloud_sharded
from slamtpu.parallel.mesh import make_mesh as j_make_mesh
from slamtpu.parallel.sharded import sharded_vo_step as j_sharded_vo_step
from slamtpu.pipeline import point_cloud as jpc
from slamtpu.pipeline import vo as jvo
from slamtpu.feature.detector import OrbConfig as JOrbConfig
from slamtpu.mapping.keyframe import KeyframeConfig as JKeyframeConfig
from slamtpu.ops.ransac import RansacConfig as JRansacConfig
from slamtpu_torch import convert
from slamtpu_torch.feature import detector as tdet
from slamtpu_torch.feature.matcher import FeatureMatcher
from slamtpu_torch.io.synthetic import render_sequence
from slamtpu_torch.odometry.pose import estimate_relative_pose as t_pose
from slamtpu_torch.parallel.mesh import mesh_shape
from slamtpu_torch.pipeline.point_cloud import run_point_cloud_fused
from slamtpu_torch.pipeline.vo import VoConfig, run_vo

import torch_parallel_worker as worker
from torch_parallel_worker import collect, spawn

torch.set_num_threads(1)

SCENE = dict(n_frames=16, height=160, width=224, n_points=500, step=0.5)
N_RANKS = 4
J_VO = jvo.VoConfig(orb=JOrbConfig(max_features=200), ransac=JRansacConfig(iters=150))
J_KF = jvo.VoConfig(orb=JOrbConfig(max_features=200), ransac=JRansacConfig(iters=150),
                    keyframe=JKeyframeConfig(min_translation=5.0, min_rotation=10.0, max_frames=3))
J_FLAGSHIP = jpc.PointCloudConfig(
    vo=jvo.VoConfig(orb=JOrbConfig(max_features=200), ransac=JRansacConfig(iters=150),
                    keyframe=JKeyframeConfig(0.03, 0.03, 0.7, 3)),
    map_capacity=2048, max_obs_per_kf=256, max_ba_landmarks=512, max_ba_observations=1024,
)


def _angle_deg(a, b):
    tr = np.einsum("...ij,...ij->...", np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def _joined(ranks, name):
    """The ranks' blocks of one sharded_vo_step result, joined along time
    ([T, ...] of sequence 0)."""
    return {k: np.concatenate([r[name][k][0] for r in ranks]) for k in ranks[0][name]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("torch_parallel")
    scenes = {s: render_sequence(**SCENE, seed=s) for s in (7, 9, 11)}
    cam = scenes[7].intrinsics
    pair_keys = jax.random.split(jax.random.PRNGKey(0), SCENE["n_frames"] - 1)
    pair_draws = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (150, 200), dtype=jnp.float32))(pair_keys))
    slot_draws = np.concatenate([pair_draws[:1], pair_draws])  # slot t holds pair t-1's; slot 0 is masked
    np.savez(workdir / "inputs.npz", frames7=scenes[7].frames, frames9=scenes[9].frames,
             frames11=scenes[11].frames, camera=np.array([cam.fx, cam.fy, cam.cx, cam.cy]), pair_draws7=pair_draws,
             slot_draws9=slot_draws)
    procs = spawn("parallel", N_RANKS, workdir)
    try:
        # The references, while the ranks run.
        keys = np.concatenate([np.zeros((1, 2), pair_keys.dtype), np.asarray(pair_keys)])[None]
        jcam = JCam(cam.fx, cam.fy, cam.cx, cam.cy)
        mesh8 = j_make_mesh(8, data=1)
        tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
        draws = torch.from_numpy(pair_draws.copy())
        refs = dict(
            jax_kf=tree(j_sharded_vo_step(mesh8, scenes[9].frames[None].astype(np.float32), jnp.asarray(keys), jcam,
                                          J_KF)),
            jax_flagship=j_run_point_cloud_sharded(scenes[7].frames.astype(np.float32), jcam, mesh8, J_FLAGSHIP,
                                                   seed=0),
            own_f64=run_vo(scenes[7].frames, cam, worker.VO, chunk_size=2, seed=0, device="cpu",
                           pose_dtype=torch.float64),
            kf=run_vo(scenes[9].frames, cam, VoConfig(worker.VO.orb, worker.VO.ransac, worker.KF_STATE), chunk_size=4,
                      uniforms=draws, device="cpu"),
            refine=run_vo(scenes[7].frames, cam, VoConfig(worker.VO.orb, worker.VO.ransac, refine_matches=True),
                          chunk_size=4, seed=0, device="cpu"),
            fused=run_point_cloud_fused(scenes[7].frames, cam, worker.FLAGSHIP, uniforms=draws, device="cpu",
                                        pose_dtype=torch.float64),
            fused_clips=[run_point_cloud_fused(scenes[s].frames, cam, worker.FLAGSHIP, seed=b, device="cpu")
                         for b, s in enumerate((7, 11))],
        )
        ranks = collect(procs, "parallel", workdir, timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return dict(ranks=ranks, refs=refs, scenes=scenes, cam=cam, keys=keys[0], slot_draws=slot_draws)


def test_mesh_shape_rule():
    """tests/test_sharding.py::test_mesh_shapes's cases, and the rule's
    edges, without a process group."""
    assert mesh_shape(8) == (2, 4)
    assert mesh_shape(8, data=1) == (1, 8)
    assert mesh_shape(4) == (2, 2) and mesh_shape(6) == (2, 3)
    assert mesh_shape(1) == (1, 1) and mesh_shape(2) == (1, 2) and mesh_shape(3) == (1, 3)
    with pytest.raises(ValueError):
        mesh_shape(6, data=4)


def test_configs_are_the_jax_ones():
    assert convert.config_from_jax(J_VO) == worker.VO
    assert convert.config_from_jax(J_KF).keyframe == worker.KF_STATE
    assert convert.point_cloud_config_from_jax(J_FLAGSHIP) == worker.FLAGSHIP


def test_ranks_cover_the_clip_in_order(runs):
    ranks = runs["ranks"]
    assert [r["slice"] for r in ranks] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert [r["rank_world"] for r in ranks] == [(i, N_RANKS) for i in range(N_RANKS)]
    assert {r["backend"] for r in ranks} == {"gloo"}


def test_sharded_vo_equals_run_vo(runs):
    """(1, 4) mesh against run_vo on the port's own draws, pose chain at
    f64: the halo carries each block's first pair, the scan and the
    prefix product cross the blocks."""
    got, ref = _joined(runs["ranks"], "own_f64"), runs["refs"]["own_f64"]
    assert not got["success"][0]
    np.testing.assert_array_equal(got["success"][1:], ref.success)
    np.testing.assert_array_equal(got["num_matches"][1:], ref.num_matches)
    np.testing.assert_array_equal(got["is_keyframe"][1:], ref.is_keyframe)
    np.testing.assert_allclose(got["rotations"][1:], ref.rotations, rtol=0, atol=1e-5)
    serial_pos = np.array([p.position for p in ref.trajectory.points])[1:]
    np.testing.assert_allclose(got["positions"][1:][ref.is_keyframe], serial_pos, rtol=0, atol=1e-9)
    assert ref.success.sum() >= 12 and ref.is_keyframe.sum() >= 8


def test_state_dependent_keyframes_equal_serial_and_jax(runs):
    """tests/test_sharding.py's state-dependent KeyframeConfig: keyframes
    only from the max_frames counter, a schedule that a per-shard scan
    state cannot reproduce."""
    got, ref, jax_ref = _joined(runs["ranks"], "kf_state"), runs["refs"]["kf"], runs["refs"]["jax_kf"]
    np.testing.assert_array_equal(got["success"][1:], ref.success)
    np.testing.assert_array_equal(got["is_keyframe"][1:], ref.is_keyframe)
    np.testing.assert_array_equal(got["success"], jax_ref.success[0])
    np.testing.assert_array_equal(got["is_keyframe"], jax_ref.is_keyframe[0])
    assert got["is_keyframe"].sum() >= 3


def test_sharded_vo_matches_jax_sharded_vo_step(runs):
    """The same clip and draws through both packages' sharded steps (the
    state-dependent run above, so one JAX program serves both tests):
    success and matches exact, rotations at 0.1 degree, A1 pairs held at
    f64."""
    got, ref = _joined(runs["ranks"], "kf_state"), runs["refs"]["jax_kf"]
    np.testing.assert_array_equal(got["success"], ref.success[0])
    np.testing.assert_array_equal(got["num_matches"][1:], ref.num_matches[0][1:])
    ok = got["success"]
    differ = ok & (_angle_deg(got["rotations"], ref.rotations[0]) > 0.1)
    assert differ.sum() <= ok.sum() // 4, np.nonzero(differ)
    np.testing.assert_array_equal(got["is_keyframe"][~differ], ref.is_keyframe[0][~differ])
    frames, cam, cfg = runs["scenes"][9].frames, runs["cam"], worker.VO
    matcher = FeatureMatcher()
    for t in np.nonzero(differ)[0]:
        feats = tdet.detect_and_compute(torch.from_numpy(frames[t - 1:t + 1]), cfg.orb)
        good = matcher.filter_good_matches(matcher.match_descriptors(
            feats.descriptors[0], feats.descriptors[1], feats.mask[0], feats.mask[1]), cfg.match_ratio)
        p1, p2 = feats.xy[0].double(), feats.xy[1][good.train_idx].double()
        sigma = cfg.orb.scale_factor ** torch.maximum(feats.octave[0], feats.octave[1][good.train_idx]).double()
        j = j_pose(runs["keys"][t], JCam(cam.fx, cam.fy, cam.cx, cam.cy), jnp.asarray(p1.numpy()),
                   jnp.asarray(p2.numpy()), mask=jnp.asarray(good.mask.numpy()), config=J_VO.ransac,
                   sigma=jnp.asarray(sigma.numpy()))
        ours = t_pose(cam, p1, p2, mask=good.mask, config=cfg.ransac, sigma=sigma,
                      uniforms=torch.from_numpy(runs["slot_draws"][t]))
        assert (bool(ours.valid), int(ours.num_inliers)) == (bool(j.valid), int(j.num_inliers)), t
        np.testing.assert_allclose(ours.rotation.numpy(), np.asarray(j.rotation), rtol=0, atol=1e-8, err_msg=str(t))


def _assert_flagship_bars(got: dict, ref, what: str):
    """tests/test_sharding.py::test_sharded_flagship_matches_serial's bars."""
    assert got["kf_idx"].tolist() == np.asarray(ref.keyframe_frame_idx).tolist(), what
    assert got["ba_runs"] == ref.ba_runs, what
    assert len(got["kf_idx"]) >= 8, what
    angles = _angle_deg(got["kf_rot"], ref.keyframe_rotations)
    assert angles.max() < 1.5, f"{what}: max keyframe rotation gap {angles.max():.2f} deg"
    np.testing.assert_allclose(got["kf_trans"], ref.keyframe_translations, atol=0.4, err_msg=what)
    n_got, n_ref = int(got["valid"].sum()), int(np.asarray(ref.map_state.valid).sum())
    assert n_ref > 50, what
    assert abs(n_got - n_ref) <= max(15, 0.15 * n_ref), (what, n_got, n_ref)


def test_sharded_flagship_matches_fused_and_jax(runs):
    """run_point_cloud_sharded on the (1, 4) mesh, on the JAX draws with
    the chain at f64 (the JAX package's under x64), against the port's
    fused runner and the JAX sharded runner; every rank returns the map."""
    ranks = runs["ranks"]
    got = ranks[0]["sharded_flagship"]
    _assert_flagship_bars(got, runs["refs"]["fused"], "port fused")
    _assert_flagship_bars(got, runs["refs"]["jax_flagship"], "JAX sharded")
    assert got["successful"] == runs["refs"]["fused"].successful_frames
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["sharded_flagship"]["valid"], got["valid"])
        np.testing.assert_array_equal(r["sharded_flagship"]["kf_rot"], got["kf_rot"])


def test_batched_flagship_matches_fused_per_clip(runs):
    """run_point_cloud_batched on a (2, 2) mesh, two clips (seeds 7 and 11
    of the renderer) at seeds 0 and 1, against the fused runner per clip;
    the two maps differ (no cross-clip leakage) and every rank holds both."""
    ranks = runs["ranks"]
    batched = ranks[0]["batched"]
    assert len(batched) == 2
    for b, (got, ref) in enumerate(zip(batched, runs["refs"]["fused_clips"])):
        _assert_flagship_bars(got, ref, f"clip {b}")
        assert got["successful"] == ref.successful_frames
    assert not np.array_equal(batched[0]["valid"], batched[1]["valid"])
    for r in ranks[1:]:
        for got, mine in zip(r["batched"], batched):
            np.testing.assert_array_equal(got["valid"], mine["valid"])


def test_refine_matches_through_the_halo(runs):
    """With refine_matches the halo carries the previous rank's last frame
    as well: the refined run equals run_vo's."""
    got, ref = _joined(runs["ranks"], "refine"), runs["refs"]["refine"]
    np.testing.assert_array_equal(got["success"][1:], ref.success)
    np.testing.assert_array_equal(got["num_matches"][1:], ref.num_matches)
    np.testing.assert_array_equal(got["is_keyframe"][1:], ref.is_keyframe)
    np.testing.assert_allclose(got["rotations"][1:], ref.rotations, rtol=0, atol=1e-5)
    plain = _joined(runs["ranks"], "own_f64")
    assert np.abs(got["rotations"][1:] - plain["rotations"][1:]).max() > 0  # the refinement moved the poses
