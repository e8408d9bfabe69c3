"""CUDA graphs of the pose stage, of the fused flagship's map step and of
its window BA on the card: a replay is the eager call bit for bit. Marked `cuda`: each test
skips on a host without a CUDA device (decided inside the fixture). No JAX here, so on the GPU
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py`
runs them.

For each case, eager references come from calls that are each a first
sighting (the cache is reset before each); then one key is seen once,
captured with one draw block and replayed with another, so the static
buffers must be refreshed, and the outputs cloned at the capture must
survive the replay. The map step and window BA are held at the flagship
cell's size: whole runs through the cache against a run with every region
eager.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from slamtpu_torch.feature.detector import OrbFeatures
from slamtpu_torch.mapping.bundle_adjustment import BundleAdjuster, Observation
from slamtpu_torch.io.synthetic import render_sequence
from slamtpu_torch.odometry.pose import PoseEstimator
from slamtpu_torch.ops import five_point
from slamtpu_torch.ops.ransac import PairDraws, pair_draws
from slamtpu_torch.pipeline import point_cloud as pc
from slamtpu_torch.pipeline.vo import VoConfig, _detect, _pair_poses, seed_features, vo_frontend
from slamtpu_torch.utils import graphs, metrics
from test_torch_cuda import _ba_problem

pytestmark = pytest.mark.cuda

K, C = 500, 32  # the benchmark's features a frame and steps a chunk
STAGES = ("match", "hypotheses", "score", "polish", "recover")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def clip():
    """A KITTI-sized clip of 36 frames, as host uint8."""
    scene = render_sequence(n_frames=36, height=376, width=1241, n_points=4000, step=0.8, seed=12)
    return scene


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _counts(rec, by_span=False):
    """Counter totals, by (counter, span name) with by_span."""
    span_name = {s.id: s.name for s in rec.spans}
    out = {}
    for (name, span_id), n in rec.counts.items():
        key = (name, span_name.get(span_id)) if by_span else name
        out[key] = out.get(key, 0) + n
    return out


def _chunk(clip, cuda, b, c, first):
    """(prev_feats, feats_new, frames) of B sequences at frame offsets
    0..B-1: frames 1..c against frame 0, or, as run_vo's first chunk,
    frames 0..c-1 against the all-masked seed features."""
    cfg = VoConfig()
    frames = torch.stack([torch.as_tensor(clip.frames[i:i + c + 1]) for i in range(b)]).to(cuda)
    feats = _detect(frames, cfg)
    if first:
        seed = seed_features(cfg.orb, cuda)
        prev = OrbFeatures(*[x[None].expand(b, *x.shape).clone() for x in seed])
        return prev, OrbFeatures(*[x[:, :c] for x in feats]), frames[:, :c]
    return OrbFeatures(*[x[:, 0] for x in feats]), OrbFeatures(*[x[:, 1:] for x in feats]), frames[:, 1:]


def _draws(cuda, b, c, seed):
    cfg = VoConfig().ransac
    return PairDraws(*[None if p[0] is None else torch.stack(p) for p in
                       zip(*[pair_draws(seed + i, range(c), cfg, K, cuda) for i in range(b)])])


@pytest.mark.parametrize("b,c", [(1, C), (4, C), (1, 1)], ids=["vo-clip257", "vo-batch4", "tail"])
def test_pair_poses_replay_is_eager_bit_for_bit(cuda, clip, b, c):
    cfg = VoConfig()
    later = _chunk(clip, cuda, b, c, first=False)
    first = _chunk(clip, cuda, b, c, first=True)
    first_mask = torch.arange(0, c, device=cuda) >= 1
    cases = {"a": (*later, None, _draws(cuda, b, c, 7)), "b": (*later, None, _draws(cuda, b, c, 99)),
             "first": (*first, first_mask, _draws(cuda, b, c, 7))}

    def call(name):
        prev, new, frames, mask, draws = cases[name]
        return _pair_poses(prev, new, frames, clip.intrinsics, cfg, mask, draws, None)

    eager = {}
    for name in cases:
        graphs.reset()
        eager[name] = call(name)
    assert not _same(eager["a"], eager["b"])  # the draws matter
    graphs.reset()
    torch.cuda.synchronize()
    launches = five_point._nullspace4.launches
    with metrics.tracing():
        metrics.records()
        call("b")  # first sighting: eager
        got_a = call("a")  # second: captured, then replayed
        got_b = call("b")  # replayed with other draws
        got_first = call("first")  # the first chunk's form shares the graphs
        counts = _counts(metrics.records())
    assert _same(got_a, eager["a"]) and _same(got_b, eager["b"]) and _same(got_first, eager["first"])
    assert bool(got_first[4][:, 0].any()) is False  # the masked seed step
    assert counts["pose.graph_eager"] == counts["pose.graph_captures"] == len(STAGES)
    assert counts["pose.graph_replays"] == 2 * len(STAGES)
    assert five_point._nullspace4.launches - launches == 4


def test_pair_poses_makes_no_host_sync_eager_captured_or_replayed(cuda, clip):
    cfg = VoConfig()
    prev, new, frames = _chunk(clip, cuda, 1, C, first=False)
    draws = _draws(cuda, 1, C, 3)
    graphs.reset()
    _pair_poses(prev, new, frames, clip.intrinsics, cfg, None, draws, None)  # builds the kernels, warms caches
    graphs.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):  # eager, captured, replayed
            _pair_poses(prev, new, frames, clip.intrinsics, cfg, None, draws, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_pose_estimator_replay_is_eager_bit_for_bit(cuda, clip):
    """compute_essential_matrix twice and more at one point count, its draws
    from the estimator's seed: the second call is captured, the third
    replayed, each the eager call's bits, in every region of an unbatched
    pair's RANSAC (hypotheses, score, polish)."""
    rng = np.random.default_rng(4)
    p1 = rng.uniform((0, 0), (1241, 376), (300, 2)).astype(np.float32)
    p2 = (p1 + rng.normal(0, 1.0, p1.shape) + (3.0, 0.5)).astype(np.float32)
    cfg = VoConfig().ransac

    def calls():
        est = PoseEstimator(clip.intrinsics, seed=5, device=cuda)
        return lambda: est.compute_essential_matrix(p1, p2, cfg)

    ref_call, eager = calls(), []
    for _ in range(3):
        graphs.reset()
        eager.append(ref_call())
    graphs.reset()
    got_call = calls()
    launches = five_point._nullspace4.launches
    with metrics.tracing():
        metrics.records()
        got = [got_call() for _ in range(3)]
        rec = metrics.records()
    for g, e in zip(got, eager):
        assert _same(g, e)
    assert not _same(eager[1], eager[2])
    counts = _counts(rec, by_span=True)
    for stage in ("pose.hypotheses", "pose.score", "pose.polish"):
        assert [counts.get((f"pose.graph_{k}", stage), 0) for k in ("eager", "captures", "replays")] == [1, 1, 1]
    assert five_point._nullspace4.launches - launches == 3


def _cells_clip():
    """The flagship cell's clip: 257 frames of 1241x376 (KITTI intrinsics,
    4000 landmarks, step 0.8, seed 0, noise 2.0), rendered once into
    .scene_cache (tests/test_torch_cuda.py renders the same)."""
    from slamtpu_torch.io.synthetic import render_sequence_cached
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    return render_sequence_cached(n_frames=257, height=376, width=1241, n_points=4000, step=0.8,
                                  intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)


def _first_chunk(scene, cfg, cuda):
    """(feats0, the first chunk's frontend result and features) on the card."""
    feats0 = pc._first_features(scene.frames, cfg, cuda)
    carry1 = (feats0, pc.KeyframeState.initial(cuda), torch.eye(4, dtype=torch.float32, device=cuda))
    _, res, feats = vo_frontend(*carry1, torch.as_tensor(scene.frames[1:C + 1]).to(cuda), scene.intrinsics, cfg.vo,
                                first_step=1)
    return feats0, res, feats


def test_fused_map_step_replay_is_eager_bit_for_bit(cuda, monkeypatch):
    """run_point_cloud_fused at the flagship cell's size (PointCloudConfig(),
    chunks of 32) twice through the graph cache, the first run capturing the
    map step at its second keyframe: both equal a run in which every region
    runs eagerly, as with the cache reset before each step, in the map state,
    the free table, the unpacked descriptors, the ring, the keyframe chain,
    the observations and the BA runs; the second run replays the map step
    on at least 99 % of its calls."""
    scene, cfg = _cells_clip(), pc.PointCloudConfig()
    carries = []
    phase2 = pc._fused_phase2_chunk

    def recording(*args, **kwargs):
        carry, outs = phase2(*args, **kwargs)
        carries.append(carry)
        return carry, outs

    monkeypatch.setattr(pc, "_fused_phase2_chunk", recording)

    def run():
        carries.clear()
        res = pc.run_point_cloud_fused(scene.frames, scene.intrinsics, cfg, chunk_size=C, device=cuda)
        return res, carries[-1]

    cached = graphs.run
    monkeypatch.setattr(graphs, "run", lambda name, fn, tensors, static=(), eager=False: cached(
        name, fn, tensors, static, eager=True))
    eager = run()
    monkeypatch.setattr(graphs, "run", cached)
    graphs.reset()
    first = run()
    with metrics.tracing():
        metrics.records()
        second = run()
        counts = _counts(metrics.records())
    ref, ref_carry = eager
    assert ref.ba_runs > 0
    for got, carry in (first, second):
        assert got.ba_runs == ref.ba_runs and got.successful_frames == ref.successful_frames
        for field in ref.map_state._fields:
            assert torch.equal(getattr(got.map_state, field), getattr(ref.map_state, field)), field
        for name in ("keyframe_rotations", "keyframe_translations", "keyframe_frame_idx"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
        for a, b in zip(got.observations, ref.observations):
            np.testing.assert_array_equal(a, b)
        assert carry.kf_count == ref_carry.kf_count
        for name, a, b in zip(carry._fields, carry, ref_carry):
            if name not in ("map_state", "kf_count"):
                assert torch.equal(a, b), name
    calls = sum(counts.get(f"map.graph_{k}", 0) for k in ("replays", "captures", "eager"))
    assert calls == len(ref.keyframe_frame_idx) - 1 and counts["map.graph_replays"] >= 0.99 * calls


def test_map_step_makes_no_host_sync_eager_captured_or_replayed(cuda):
    """Three keyframe steps with BA and prune off, after a warm-up step
    that builds the constants: the first runs the map step eagerly, the
    second captures it, the third replays it, and none reads the card."""
    scene = _cells_clip()
    cfg = dataclasses.replace(pc.PointCloudConfig(), ba_interval=0, prune_interval=0)
    feats0, res, feats = _first_chunk(scene, cfg, cuda)

    def step(carry, i):
        return pc._kf_step(carry, feats.xy[i], feats.descriptors[i], feats.mask[i], res.rotations[i],
                           res.translations[i], scene.intrinsics, cfg)[0]

    carry = pc._fused_carry_init(cfg, feats0, torch.float32)
    graphs.reset()
    step(carry, 0)
    graphs.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            carry = step(carry, i)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert carry.kf_count == 4
    assert [k[0] for k, g in graphs._CACHE.graphs.items() if g is not None] == ["map.step"]


def test_map_step_bits_do_not_depend_on_where_its_inputs_lie(cuda):
    """The keyframe step hands the region copies at offset 0 of the chunk's
    rows and the ring's newest pose: the region's outputs on those equal
    its outputs on the views themselves, bit for bit, on every step of a
    chunk (the views' offsets differ from step to step)."""
    scene, cfg = _cells_clip(), pc.PointCloudConfig()
    feats0, res, feats = _first_chunk(scene, cfg, cuda)
    carry = pc._fused_carry_init(cfg, feats0, torch.float32)
    region = functools.partial(pc._map_step, intrinsics=scene.intrinsics, config=cfg)
    for i in range(C):
        views = (feats.xy[i], feats.descriptors[i], feats.mask[i], res.rotations[i], res.translations[i],
                 torch.full((1,), carry.kf_count, dtype=torch.int32, device=cuda), *pc._carry_tensors(carry))
        fresh = [pc._fresh(t) for t in views]
        assert i == 0 or any(v.storage_offset() for v in views)
        assert _same(region(*views), region(*fresh))
        carry = pc._kf_step(carry, *views[:5], scene.intrinsics, cfg)[0]


def test_fused_window_ba_replay_is_eager_bit_for_bit(cuda, monkeypatch):
    """run_point_cloud_fused at the flagship cell's size twice through the
    graph cache against a run with every region eager: the map state, the
    ring and the rest of the carry, the keyframe chain, the observations,
    the BA runs and the LM iterations of every window solve are equal; the
    second run replays at least 99 % of its `ba.step` calls and every
    `ba.setup` after the first run's two."""
    scene, cfg = _cells_clip(), pc.PointCloudConfig()
    carries, iters = [], []
    phase2, lm = pc._fused_phase2_chunk, pc._lm

    def recording(*args, **kwargs):
        carry, outs = phase2(*args, **kwargs)
        carries.append(carry)
        return carry, outs

    def counting(*args):
        out = lm(*args)
        iters.append(out[4])
        return out

    monkeypatch.setattr(pc, "_fused_phase2_chunk", recording)
    monkeypatch.setattr(pc, "_lm", counting)

    def run():
        carries.clear()
        iters.clear()
        res = pc.run_point_cloud_fused(scene.frames, scene.intrinsics, cfg, chunk_size=C, device=cuda)
        return res, carries[-1], list(iters)

    cached = graphs.run
    monkeypatch.setattr(graphs, "run", lambda name, fn, tensors, static=(), eager=False: cached(
        name, fn, tensors, static, eager=True))
    eager = run()
    monkeypatch.setattr(graphs, "run", cached)
    graphs.reset()
    first = run()
    with metrics.tracing():
        metrics.records()
        second = run()
        counts = _counts(metrics.records(), by_span=True)
    ref, ref_carry, ref_iters = eager
    assert ref.ba_runs > 0 and len(ref_iters) == ref.ba_runs
    for got, carry, got_iters in (first, second):
        assert got_iters == ref_iters
        assert got.ba_runs == ref.ba_runs and got.successful_frames == ref.successful_frames
        for field in ref.map_state._fields:
            assert torch.equal(getattr(got.map_state, field), getattr(ref.map_state, field)), field
        for name in ("keyframe_rotations", "keyframe_translations", "keyframe_frame_idx"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
        for a, b in zip(got.observations, ref.observations):
            np.testing.assert_array_equal(a, b)
        assert carry.kf_count == ref_carry.kf_count
        for name, a, b in zip(carry._fields, carry, ref_carry):
            if name not in ("map_state", "kf_count"):
                assert torch.equal(a, b), name
    steps = [counts.get((f"ba.graph_{k}", "ba.iteration"), 0) for k in ("replays", "captures", "eager")]
    setups = [counts.get((f"ba.graph_{k}", "map.window_ba"), 0) for k in ("replays", "captures", "eager")]
    assert sum(steps) == sum(ref_iters) and steps[0] >= 0.99 * sum(steps)
    assert setups == [ref.ba_runs, 0, 0]


def test_window_ba_makes_no_host_sync_inside_its_regions(cuda, monkeypatch):
    """Window BA on the ring of five keyframe steps, after a warm-up solve:
    three solves with sync debug mode "error" inside every region call
    (set-up eager, captured, replayed; iterations likewise), the stop read
    between them left outside, each solve equal to the first."""
    scene = _cells_clip()
    cfg = dataclasses.replace(pc.PointCloudConfig(), ba_interval=0, prune_interval=0)
    feats0, res, feats = _first_chunk(scene, cfg, cuda)
    carry = pc._fused_carry_init(cfg, feats0, torch.float32)
    for i in range(cfg.ba_window):
        carry = pc._kf_step(carry, feats.xy[i], feats.descriptors[i], feats.mask[i], res.rotations[i],
                            res.translations[i], scene.intrinsics, cfg)[0]
    args = (carry.map_state, carry.ring_rot, carry.ring_trans, carry.ring_kf, carry.ring_slots, carry.ring_ids,
            carry.ring_px, carry.ring_mask, scene.intrinsics, cfg)
    graphs.reset()
    pc._fused_window_ba(*args)
    graphs.reset()
    cached = graphs.run

    def strict(name, fn, tensors, static=(), eager=False):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return cached(name, fn, tensors, static, eager)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(graphs, "run", strict)
    torch.cuda.synchronize()
    with metrics.tracing():
        metrics.records()
        outs = [pc._fused_window_ba(*args) for _ in range(3)]
        counts = _counts(metrics.records())
    assert all(_same(o, outs[0]) for o in outs[1:])
    assert counts["ba.graph_captures"] == 2 and counts["ba.graph_replays"] >= 2
    assert sorted(k[0] for k, g in graphs._CACHE.graphs.items() if g is not None) == ["ba.setup", "ba.step"]


def test_large_bundle_adjuster_solve_stays_eager(cuda):
    """A BundleAdjuster solve of 12 poses, whose 72-row reduced system goes
    to torch.linalg.solve_ex: both regions run eagerly on every call by the
    shape rule and nothing is captured; three solves are equal bit for bit
    and within 1e-8 of the largest coordinate of the same solve on the CPU
    (the tolerance of tests/test_torch_cuda.py::test_ba_solve_cuda_matches_cpu)."""
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    cam = CameraIntrinsics(500.0, 500.0, 320.0, 240.0)
    (rot, trans, pts), obs = _ba_problem(12, 12, 300, torch.float64)
    poses = list(zip(rot.numpy(), trans.numpy()))
    points = list(pts.numpy())
    observations = [Observation(int(k), int(p), x) for k, p, x in zip(obs.kf_idx, obs.pt_idx, obs.pixels.numpy())]
    ref = BundleAdjuster(cam, device="cpu").optimize(poses, points, observations, fix_first_pose=True)
    graphs.reset()
    with metrics.tracing():
        metrics.records()
        got = [BundleAdjuster(cam, device=cuda).optimize(poses, points, observations, fix_first_pose=True)
               for _ in range(3)]
        counts = _counts(metrics.records())
    assert counts["ba.lm_iterations"] >= 6
    assert counts["ba.graph_eager"] == 3 + counts["ba.lm_iterations"]
    assert not counts.get("ba.graph_captures") and not counts.get("ba.graph_replays")
    assert not any(k[0].startswith("ba.") for k in [*graphs._CACHE.graphs, *graphs._CACHE.seen])

    def flat(out):
        return np.concatenate([np.concatenate([r.ravel(), t.ravel()]) for r, t in out[0]] + [np.ravel(out[1])])

    scale = max(np.abs(flat(ref)).max(), 1.0)
    for out in got:
        assert out[2] == got[0][2]
        np.testing.assert_array_equal(flat(out), flat(got[0]))
        np.testing.assert_allclose(flat(out), flat(ref), rtol=0, atol=1e-8 * scale)
        np.testing.assert_allclose(out[2], ref[2], rtol=1e-8)
