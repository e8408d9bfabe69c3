"""The fused flagship runner: the port's run_point_cloud_fused against its
own host loop and against the JAX package's run_point_cloud_fused, on the
clip and RANSAC draws of tests/test_torch_point_cloud.py (17 textured frames
of 200x160, seed 8, chunks of 8, 16 hypotheses, 96 features, a 30-round GN
polish), with the keyframe chain in f64 as the JAX package runs under x64;
a step-by-step replay of phase 2 against the JAX package's; the edge cases.

Bars, with what this CPU measured:
- fused vs host loop, the port alone, BA off: keyframes, map validity and
  ids, the observation log exact; rotations within 1e-12, translations
  within 1e-10, the JAX package's own bars (measured 0 and 1.8e-15).
- fused vs the JAX package's fused runner: keyframes, BA runs and successes
  exact; the census within the JAX package's fused-vs-host bars, landmarks
  within max(3, 2 %) and observations within 5 % (measured 574 vs 575 and
  1195 vs 1200 without BA, 574 vs 574 and 1220 vs 1222 with it); poses
  within the bars of tests/test_torch_point_cloud.py: without BA rotations
  5e-6 and translations 1e-4 (measured 9.4e-7 and 4.2e-5), with BA 0.036
  Frobenius and 0.051 of the path (measured 0.0021 and 0.022). The map is
  not identical: the f32 DLT of near-parallel rays flips a cheirality mask
  now and then in either package (ROADMAP Queue 3).
- the replay (BA every 5 keyframes): every step's triangulation masks exact
  on rays with >= 0.5 degree of parallax (masks on shallower rays differed
  on 3 of 16 steps); with the JAX triangulation handed to the port's step,
  the whole new carry and the step's outputs exact, except f64 poses
  within 1e-15 of the largest entry (measured 2.2e-16: the chain's matmul
  rounds once differently) and, on the 3 BA steps, the solved poses within
  5e-8 (measured 4.3e-9) and f32 positions within 6e-8 (measured 1.2e-8,
  one f32 rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.feature.detector import OrbFeatures as JOrbFeatures
from slamtpu.io.synthetic import render_sequence as j_render
from slamtpu.mapping import triangulation as jtri
from slamtpu.pipeline import point_cloud as jpc
from slamtpu_torch import convert
from slamtpu_torch.feature.detector import OrbFeatures
from slamtpu_torch.mapping import bundle_adjustment as tba
from slamtpu_torch.io.synthetic import render_sequence as t_render
from slamtpu_torch.mapping.triangulation import triangulate_points
from slamtpu_torch.pipeline import point_cloud as tpc
from slamtpu_torch.pipeline.vo import vo_frontend
from slamtpu_torch.utils import graphs, metrics
from test_torch_point_cloud import (  # the same clip, draws and bars
    CHUNK,
    FEATURES,
    ITERS,
    SCENE,
    _assert_census_close,
    _assert_schedule_equal,
    _jax_config,
    _parallax_deg,
)
from test_torch_graphs import _counts, _FakeBackend  # the stubbed capture

torch.set_num_threads(1)

F64 = torch.float64


def _run(scene, ba_interval, draws, runner=tpc.run_point_cloud_fused, **kw):
    cfg = convert.point_cloud_config_from_jax(_jax_config(ba_interval))
    if runner is tpc.run_point_cloud_fused:
        kw.setdefault("pose_dtype", F64)
    return runner(scene.frames, scene.intrinsics, cfg, chunk_size=CHUNK, device="cpu", uniforms=draws, **kw)


@pytest.fixture(scope="module")
def fused():
    """The JAX package's fused runs (BA off and on), the port's fused and
    host-loop runs on the same draws."""
    scene = t_render(**SCENE)
    jscene = j_render(**SCENE)
    keys = jax.random.split(jax.random.PRNGKey(0), SCENE["n_frames"] - 1)
    draws = np.array(jax.vmap(lambda k: jax.random.uniform(k, (ITERS, FEATURES), dtype=jnp.float32))(keys))
    jax_runs = {bi: jpc.run_point_cloud_fused(jscene.frames, jscene.intrinsics, _jax_config(bi), chunk_size=CHUNK)
                for bi in (0, 5)}
    with metrics.tracing():
        metrics.records()
        ours = {bi: _run(scene, bi, draws) for bi in (0, 5)}
        counts = _counts(metrics.records())
    host = _run(scene, 0, draws, runner=tpc.run_point_cloud)
    return dict(scene=scene, jscene=jscene, draws=draws, jax=jax_runs, ours=ours, host=host, counts=counts)


def test_fused_equals_host_loop_without_ba(fused):
    """With BA off the two runners share every numerical path."""
    host, ours = fused["host"], fused["ours"][0]
    _assert_schedule_equal(ours, host)
    np.testing.assert_allclose(ours.keyframe_rotations, host.keyframe_rotations, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.keyframe_translations, host.keyframe_translations, rtol=0, atol=1e-10)
    assert torch.equal(ours.map_state.valid, host.map_state.valid)
    assert torch.equal(ours.map_state.ids, host.map_state.ids)
    assert len(ours.observations[0]) == len(host.observations[0])
    for a, b in zip(ours.observations, host.observations):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ba_interval", [0, 5])
def test_fused_matches_jax_fused(fused, ba_interval):
    ours, ref = fused["ours"][ba_interval], fused["jax"][ba_interval]
    _assert_schedule_equal(ours, ref)
    _assert_census_close(ours, ref)
    assert len(ref.keyframe_frame_idx) == 17 and ref.ba_runs == (3 if ba_interval else 0)
    if ba_interval:
        path = np.linalg.norm(np.diff(ref.keyframe_translations, axis=0), axis=1).sum()
        assert np.linalg.norm(ours.keyframe_rotations - ref.keyframe_rotations, axis=(1, 2)).max() < 0.036
        assert np.linalg.norm(ours.keyframe_translations - ref.keyframe_translations, axis=1).max() < 0.051 * path
    else:
        np.testing.assert_allclose(ours.keyframe_rotations, ref.keyframe_rotations, rtol=0, atol=5e-6)
        np.testing.assert_allclose(ours.keyframe_translations, ref.keyframe_translations, rtol=0, atol=1e-4)
    for r in ours.keyframe_rotations:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    # Map bookkeeping on the port's own run.
    ms = ours.map_state
    ids = ms.ids[ms.valid].numpy()
    assert len(np.unique(ids)) == len(ids) and ids.max() < int(ms.next_id)


_POSES = {"prev_rot", "prev_trans", "ring_rot", "ring_trans", "new_rot", "new_trans"}
_SOLVED = {"prev_rot", "prev_trans", "ring_rot", "ring_trans"}  # what a BA step writes, besides positions


def _assert_same(ours, ref, name, ba_step):
    """Exact, except f64 poses (1e-15 of the largest entry: the chain's
    matmul rounds once differently) and what a BA step solves (poses 5e-8,
    f32 positions 6e-8: one f32 rounding)."""
    ours = ours.float().numpy() if ours.dtype == torch.bfloat16 else ours.numpy()
    ref = np.asarray(ref, ours.dtype)
    bar = 0.0
    if ba_step and name == "positions":
        bar = 6e-8
    elif ba_step and name in _SOLVED:
        bar = 5e-8
    elif name in _POSES:
        bar = 1e-15
    np.testing.assert_allclose(ours, ref, rtol=0, atol=bar * max(np.abs(ref).max(), 1.0), err_msg=name)


def test_phase2_replays_jax_step_by_step(fused, monkeypatch):
    """The JAX package's _fused_phase2_chunk one step at a time (BA every 5
    keyframes) on the frontend outputs of the port's run; before each step
    its carry crosses over by convert.fused_carry_from_numpy and the port's
    step runs on the same inputs, with the JAX package's triangulation
    handed in (the f32 DLT's masks are checked on their own)."""
    jscene, scene = fused["jscene"], fused["scene"]
    jcfg = _jax_config(5)
    tcfg = convert.point_cloud_config_from_jax(jcfg)
    j_tri = jax.jit(jtri.triangulate_points)
    intr = scene.intrinsics
    tri = {}

    def triangulate(_, pose1, pose2, xy1, xy2):
        args = [x.numpy() for x in (*pose1, *pose2, xy1, xy2)]
        jxyz, jvalid = j_tri(jscene.intrinsics, tuple(args[:2]), tuple(args[2:4]), *args[4:])
        tri.update(args=args, ours=triangulate_points(intr, pose1, pose2, xy1, xy2)[1].numpy(),
                   ref=np.asarray(jvalid))
        return torch.tensor(np.asarray(jxyz)), torch.tensor(np.asarray(jvalid))

    monkeypatch.setattr(tpc, "triangulate_points", triangulate)
    feats0 = tpc._first_features(scene.frames, tcfg, "cpu")
    jcarry = jpc._fused_carry_init(jcfg, JOrbFeatures(*[jnp.asarray(x.numpy()) for x in feats0]), jnp.float64)
    carry1 = (feats0, tpc.KeyframeState.initial("cpu"), torch.eye(4, dtype=F64))
    steps = flipped = ba_steps = 0
    for start in range(0, SCENE["n_frames"] - 1, CHUNK):
        carry1, res, feats = vo_frontend(*carry1, torch.from_numpy(scene.frames[start + 1 : start + CHUNK + 1]), intr,
                                         tcfg.vo, uniforms=torch.from_numpy(fused["draws"][start : start + CHUNK]))
        is_kf = res.is_keyframe.numpy()
        for j in range(CHUNK):
            step = [x[j : j + 1] for x in (*feats, res.rotations, res.translations)]
            before = jax.tree_util.tree_map(np.asarray, jcarry)
            jcarry, jout = jpc._fused_phase2_chunk(jcarry, JOrbFeatures(*[jnp.asarray(x.numpy()) for x in step[:7]]),
                                                   *[jnp.asarray(x.numpy()) for x in step[7:]],
                                                   jnp.asarray(is_kf[j : j + 1]), jscene.intrinsics, jcfg)
            tcarry, tout = tpc._fused_phase2_chunk(convert.fused_carry_from_numpy(before), OrbFeatures(*step[:7]),
                                                   *step[7:], is_kf[j : j + 1], intr, tcfg)
            if is_kf[j]:
                steps += 1
                # The port's triangulation: masks exact on rays with >= 0.5
                # degree of parallax.
                a = tri["args"]
                steep = _parallax_deg(intr, a[0:2], a[2:4], a[4], a[5]) >= 0.5
                np.testing.assert_array_equal(tri["ours"][steep], tri["ref"][steep])
                flipped += bool((tri["ours"] != tri["ref"]).any())
            ba_step = bool(np.asarray(jout.ba_flag[0]))
            ba_steps += ba_step
            assert tcarry.kf_count == int(jcarry.kf_count)
            for name in tpc._FusedCarry._fields:
                if name == "map_state":
                    for field in tcarry.map_state._fields:
                        _assert_same(getattr(tcarry.map_state, field), getattr(jcarry.map_state, field), field,
                                     ba_step)
                elif name != "kf_count":
                    _assert_same(getattr(tcarry, name), getattr(jcarry, name), name, ba_step)
            for name in tpc._FusedStepOut._fields:
                _assert_same(getattr(tout, name), getattr(jout, name), name, ba_step)
    assert steps == 16 and ba_steps == 3 and flipped <= 8  # measured 3


def test_map_step_replays_one_graph_key(fused, monkeypatch):
    """The fused run (BA every 5 keyframes, two chunks) through a graph
    cache that takes CPU tensors, with the capture stubbed as in
    tests/test_torch_graphs.py: the map step asks for one key over every
    step of both chunks, the keyframe index reaches it as an int32 tensor
    (not a static or a host int), and the run equals the eager one bit for
    bit."""
    calls = []

    class Recording(graphs.GraphCache):
        def run(self, name, fn, tensors, static=(), eager=False):
            if name != "map.step":  # the pose stage runs plainly, as on any CPU
                return fn(*tensors)
            calls.append((self.key(name, static, tensors), static, tensors[5].clone()))
            return super().run(name, fn, tensors, static, eager)

    monkeypatch.setattr(graphs, "_CACHE", Recording(backend=_FakeBackend(), device_type="cpu"))
    scene, ref = fused["scene"], fused["ours"][5]
    with metrics.tracing():
        metrics.records()
        got = _run(scene, 5, fused["draws"])
        counts = _counts(metrics.records())
    assert len(calls) == 16 and len({key for key, _, _ in calls}) == 1
    cfg = convert.point_cloud_config_from_jax(_jax_config(5))
    assert all(static == (cfg, scene.intrinsics) for _, static, _ in calls)
    assert all(t.dtype == torch.int32 and t.shape == (1,) for _, _, t in calls)
    assert [int(t) for _, _, t in calls] == list(range(1, 17))
    assert [counts[f"map.graph_{k}"] for k in ("eager", "captures", "replays")] == [1, 1, 14]
    assert got.ba_runs == ref.ba_runs == 3 and got.successful_frames == ref.successful_frames
    for field in ref.map_state._fields:
        assert torch.equal(getattr(got.map_state, field), getattr(ref.map_state, field)), field
    for name in ("keyframe_rotations", "keyframe_translations", "keyframe_frame_idx"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    for a, b in zip(got.observations, ref.observations):
        np.testing.assert_array_equal(a, b)


def _recording(names, calls):
    """A graph cache that takes CPU tensors, the capture stubbed as in
    tests/test_torch_graphs.py, recording (name, key, static) of each call
    of the named regions; other regions run plainly, as on any CPU."""

    class Recording(graphs.GraphCache):
        def run(self, name, fn, tensors, static=(), eager=False):
            if name not in names:
                return fn(*tensors)
            calls.append((name, self.key(name, static, tensors), static))
            return super().run(name, fn, tensors, static, eager)

    return Recording(backend=_FakeBackend(), device_type="cpu")


def test_window_ba_replays_one_key_per_region(fused, monkeypatch):
    """The fused run (BA every 5 keyframes) through a recording cache: the
    window's set-up and its LM iterations ask for one key each over every
    solve, with the plan (and, for the set-up, the configuration) as their
    static; the counters follow the policy; the iterations are the eager
    run's; and the run equals the eager one bit for bit."""
    calls = []
    monkeypatch.setattr(graphs, "_CACHE", _recording(("ba.setup", "ba.step"), calls))
    scene, ref = fused["scene"], fused["ours"][5]
    with metrics.tracing():
        metrics.records()
        got = _run(scene, 5, fused["draws"])
        counts = _counts(metrics.records())
    cfg = convert.point_cloud_config_from_jax(_jax_config(5))
    plan = tba._Plan(scene.intrinsics, cfg.ba, False, "dense", 16, "scatter", None, "scatter", 0, 2048)
    setup = [c for c in calls if c[0] == "ba.setup"]
    step = [c for c in calls if c[0] == "ba.step"]
    assert len(setup) == ref.ba_runs == 3 and len({key for _, key, _ in setup}) == 1
    assert len({key for _, key, _ in step}) == 1
    assert all(static == (plan, cfg) for _, _, static in setup) and all(static == plan for _, _, static in step)
    iters = fused["counts"]["ba.lm_iterations"]
    assert counts["ba.lm_iterations"] == len(step) == iters >= 3 and counts["ba.solves"] == 3
    # One eager call and one capture per region; every other call replays.
    assert [counts[f"ba.graph_{k}"] for k in ("eager", "captures", "replays")] == [2, 2, 1 + iters - 2]
    assert got.ba_runs == ref.ba_runs and got.successful_frames == ref.successful_frames
    for field in ref.map_state._fields:
        assert torch.equal(getattr(got.map_state, field), getattr(ref.map_state, field)), field
    for name in ("keyframe_rotations", "keyframe_translations", "keyframe_frame_idx"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    for a, b in zip(got.observations, ref.observations):
        np.testing.assert_array_equal(a, b)


def _window_problem(seed=3):
    """A problem at the fused window's shapes: 5 poses, 2,048 landmarks and
    5 x 1,024 observation slots (each pose sees a landmark at most once,
    ~90 % of slots live), f32, the two oldest poses frozen; noisy start."""
    rng = np.random.default_rng(seed)
    cam = t_render(n_frames=1, height=120, width=160, n_points=8, seed=0).intrinsics
    n_poses, n_points, o_cap = 5, 2048, 1024
    pts = rng.uniform((-4, -2, 6), (4, 2, 20), (n_points, 3))
    trans = np.zeros((n_poses, 3))
    trans[:, 2] = -0.5 * np.arange(n_poses)
    rot = np.tile(np.eye(3), (n_poses, 1, 1))
    kf = np.repeat(np.arange(n_poses), o_cap)
    pt = np.concatenate([rng.choice(n_points, o_cap, replace=False) for _ in range(n_poses)])
    p_cam = pts[pt] + trans[kf]
    px = np.stack([cam.fx * p_cam[:, 0] / p_cam[:, 2] + cam.cx, cam.fy * p_cam[:, 1] / p_cam[:, 2] + cam.cy], -1)
    px += rng.normal(scale=0.5, size=px.shape)
    mask = rng.uniform(size=kf.size) < 0.9
    start = (rot, trans + rng.normal(scale=0.02, size=trans.shape), pts + rng.normal(scale=0.05, size=pts.shape))
    obs = tba.ObservationBatch(torch.from_numpy(kf), torch.from_numpy(pt), torch.from_numpy(px).float(),
                               torch.from_numpy(mask))
    free = torch.tensor([False, False, True, True, True])
    return cam, [torch.from_numpy(a).float() for a in start], obs, free


@pytest.mark.parametrize("stop_at_once", [False, True], ids=["runs", "stops-at-once"])
def test_ba_solve_at_window_shapes_replays_eager_bits(monkeypatch, stop_at_once):
    """ba_solve in gather mode at the window's shapes, three solves through
    a recording cache (set-up eager, captured, replayed; each iteration
    after the second replayed): every solve's outputs and iteration count
    are the eager call's. A stop on the first iteration (convergence
    declared at once) still returns after one iteration, replayed too."""
    cam, start, obs, free = _window_problem()
    cfg = tba.BaConfig(min_error_change=1e30) if stop_at_once else tba.BaConfig()
    kw = dict(config=cfg, fix_first_pose=False, pose_mask=free, segment_method="gather", gather_k_pt=5)
    ref = tba.ba_solve(cam, *start, obs, **kw)
    assert ref[4] == 1 if stop_at_once else ref[4] >= 3
    calls = []
    monkeypatch.setattr(graphs, "_CACHE", _recording(("ba.setup", "ba.step"), calls))
    with metrics.tracing():
        metrics.records()
        got = [tba.ba_solve(cam, *start, obs, **kw) for _ in range(3)]
        counts = _counts(metrics.records())
    for out in got:
        assert out[4] == ref[4]
        for a, b in zip(out[:4], ref[:4]):
            assert torch.equal(a, b)
    steps = [c for c in calls if c[0] == "ba.step"]
    assert len(steps) == 3 * ref[4] and len({key for _, key, _ in calls}) == 2
    assert counts["ba.lm_iterations"] == 3 * ref[4] and counts["ba.solves"] == 3
    assert [counts[f"ba.graph_{k}"] for k in ("eager", "captures", "replays")] == [2, 2, 1 + 3 * ref[4] - 2]


def test_single_frame_clip():
    """No pairs: keyframe 0 only, an empty map and log."""
    scene = t_render(n_frames=1, height=120, width=160, n_points=200, seed=0)
    cfg = tpc.PointCloudConfig(vo=dataclasses.replace(tpc.PointCloudConfig().vo, orb=dataclasses.replace(
        tpc.PointCloudConfig().vo.orb, max_features=64, n_levels=4)), map_capacity=256)
    res = tpc.run_point_cloud_fused(scene.frames, scene.intrinsics, cfg, device="cpu")
    assert res.total_frames == 1 and res.successful_frames == 0 and res.ba_runs == 0
    assert list(res.keyframe_frame_idx) == [0] and res.points() == []
    assert all(len(a) == 0 for a in res.observations)
    np.testing.assert_array_equal(res.keyframe_rotations, np.eye(3)[None])


def test_refine_matches_raises(fused):
    """refine_matches, once unported, now runs in the fused runner: each
    chunk's frontend gets the frame before the chunk, so with BA off the
    fused runner equals the host loop with refine_matches too, and the
    refinement moves the poses."""
    scene, draws = fused["scene"], fused["draws"]
    cfg = convert.point_cloud_config_from_jax(_jax_config(0))
    cfg = dataclasses.replace(cfg, vo=dataclasses.replace(cfg.vo, refine_matches=True))
    frames, draws = scene.frames[:9], draws[:8]
    ours = tpc.run_point_cloud_fused(frames, scene.intrinsics, cfg, chunk_size=4, device="cpu", uniforms=draws,
                                     pose_dtype=F64)
    host = tpc.run_point_cloud(frames, scene.intrinsics, cfg, chunk_size=4, device="cpu", uniforms=draws)
    _assert_schedule_equal(ours, host)
    np.testing.assert_allclose(ours.keyframe_rotations, host.keyframe_rotations, rtol=0, atol=1e-12)
    assert ours.successful_frames >= 5
    plain = tpc.run_point_cloud_fused(frames, scene.intrinsics, dataclasses.replace(
        cfg, vo=dataclasses.replace(cfg.vo, refine_matches=False)), chunk_size=4, device="cpu", uniforms=draws,
        pose_dtype=F64)
    assert plain.keyframe_rotations.shape != ours.keyframe_rotations.shape or np.abs(
        plain.keyframe_rotations - ours.keyframe_rotations).max() > 1e-6


def test_config_maps_max_obs_per_kf():
    assert convert.point_cloud_config_from_jax(dataclasses.replace(_jax_config(5), max_obs_per_kf=7)).max_obs_per_kf == 7
    assert tpc.PointCloudConfig().max_obs_per_kf == jpc.PointCloudConfig().max_obs_per_kf == 1024


def test_fused_defaults_to_cuda(monkeypatch, fused):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = fused["scene"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tpc.run_point_cloud_fused(scene.frames[:2], scene.intrinsics)
