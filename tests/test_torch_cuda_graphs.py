"""CUDA graphs of the pose stage on the card: a replay is the eager call
bit for bit. Marked `cuda`: each test skips on a host without a CUDA device
(decided inside the fixture). No JAX here, so on the GPU
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py`
runs them.

For each case, eager references come from calls that are each a first
sighting (the cache is reset before each); then one key is seen once,
captured with one draw block and replayed with another, so the static
buffers must be refreshed, and the outputs cloned at the capture must
survive the replay."""

import numpy as np
import pytest
import torch

from slamtpu_torch.feature.detector import OrbFeatures
from slamtpu_torch.io.synthetic import render_sequence
from slamtpu_torch.odometry.pose import PoseEstimator
from slamtpu_torch.ops import five_point
from slamtpu_torch.ops.ransac import PairDraws, pair_draws
from slamtpu_torch.pipeline.vo import VoConfig, _detect, _pair_poses, seed_features
from slamtpu_torch.utils import graphs, metrics

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
