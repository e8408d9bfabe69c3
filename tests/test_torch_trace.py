"""The port's spans and counters (`utils/metrics.py`: span, count, enable,
disable, tracing, records) on small clips: with tracing off nothing is
recorded and a span is one shared no-op context; tracing changes no result
bit for bit; the span trees of `run_vo`, `run_vo_batched` and
`run_point_cloud_fused` (names, parents, one request id per run, each
`pose.*` stage once per chunk, the LM iteration counters); span times on
the `perf_counter_ns` clock; `disable` restores the sync debug mode and the
warning filters. One `cuda` test (skips without a card; no JAX here, so
`python -m pytest --noconftest -m cuda tests/test_torch_trace.py` runs it
on the GPU): every `.read` span of a flagship run counts a host sync."""

import collections
import time
import warnings

import numpy as np
import pytest
import torch

from slamtpu_torch.feature.detector import OrbConfig
from slamtpu_torch.io.synthetic import render_sequence
from slamtpu_torch.mapping import bundle_adjustment
from slamtpu_torch.ops.ransac import RansacConfig
from slamtpu_torch.pipeline import point_cloud
from slamtpu_torch.pipeline.point_cloud import PointCloudConfig, run_point_cloud_fused
from slamtpu_torch.pipeline.vo import VoConfig, run_vo, run_vo_batched
from slamtpu_torch.utils import metrics

torch.set_num_threads(1)

CHUNK = 4
VO = VoConfig(orb=OrbConfig(max_features=64, n_levels=3), ransac=RansacConfig(iters=16, min_solver="5pt"))
FLAGSHIP = PointCloudConfig(vo=VoConfig(orb=VO.orb, ransac=VO.ransac, keyframe=PointCloudConfig().vo.keyframe),
                            map_capacity=1024, max_obs_per_kf=64)
POSE_STAGES = ("pose.match", "pose.hypotheses", "pose.score", "pose.polish", "pose.recover")


@pytest.fixture(scope="module")
def scene():
    return render_sequence(n_frames=13, height=120, width=160, n_points=400, step=0.3, seed=8, textured=True)


def _pipelines(scene):
    frames = scene.frames
    batch = np.stack([frames[:9], frames[3:12]])
    return {
        "vo": lambda device: run_vo(frames, scene.intrinsics, VO, chunk_size=CHUNK, seed=5, device=device),
        "vo_batched": lambda device: run_vo_batched(batch, scene.intrinsics, VO, chunk_size=CHUNK, seed=5,
                                                    device=device),
        "flagship": lambda device: run_point_cloud_fused(frames, scene.intrinsics, FLAGSHIP, chunk_size=CHUNK,
                                                         seed=5, device=device),
    }


def _traced(run, device="cpu"):
    """(result, records, solve iterations, perf_counter_ns bracket) of one
    traced run; each solve's iteration count, as its LM loop (`_lm`, which
    ba_solve and the fused runner's window BA both end in) returns it, is
    kept."""
    iters = []
    loop = bundle_adjustment._lm

    def counted(*args, **kwargs):
        out = loop(*args, **kwargs)
        iters.append(out[4])
        return out

    metrics.records()
    with pytest.MonkeyPatch.context() as mp, metrics.tracing():
        mp.setattr(bundle_adjustment, "_lm", counted)
        mp.setattr(point_cloud, "_lm", counted)
        t0 = time.perf_counter_ns()
        result = run(device)
        t1 = time.perf_counter_ns()
    return result, metrics.records(), iters, (t0, t1)


@pytest.fixture(scope="module")
def runs(scene):
    """Each pipeline untraced (with what the tracer held after it) and
    traced."""
    out = {}
    for name, run in _pipelines(scene).items():
        metrics.records()
        plain = run("cpu")
        out[name] = dict(plain=plain, plain_records=metrics.records(), traced=_traced(run))
    return out


def _tree(rec):
    by_id = {s.id: s for s in rec.spans}
    return by_id, collections.Counter((s.name, by_id[s.parent].name if s.parent is not None else None)
                                      for s in rec.spans)


def _assert_same(a, b):
    if isinstance(a, (list, tuple)) and not hasattr(a, "_fields"):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    for field in vars(a) if hasattr(a, "__dict__") else a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), field
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=field)
        elif field == "trajectory":
            np.testing.assert_array_equal([p.position for p in x.points], [p.position for p in y.points])
        elif field == "map_state":
            _assert_same(x, y)
        elif isinstance(x, tuple):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v, err_msg=field)
        else:
            assert x == y, field


@pytest.mark.parametrize("name", ["vo", "vo_batched", "flagship"])
def test_tracing_off_records_nothing_and_on_changes_no_result(runs, name):
    r = runs[name]
    assert r["plain_records"].spans == [] and r["plain_records"].counts == {}
    result, rec, _, _ = r["traced"]
    assert rec.spans
    _assert_same(r["plain"], result)


def test_off_a_span_is_one_shared_no_op():
    assert not metrics._TRACER.on
    assert metrics.span("a.b") is metrics.span("c.d", root=True)
    with metrics.span("a.b"):
        metrics.count("x", 3)
    assert metrics.records() == metrics.TraceRecords([], {})


def test_counts_are_keyed_by_the_innermost_span_and_read_once():
    with metrics.tracing():
        metrics.count("outside")
        with metrics.span("t.root", root=True):
            with metrics.span("t.child"):
                metrics.count("n", 2)
                metrics.count("n")
            metrics.count("n", 5)
    rec = metrics.records()
    by_name = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["t.child", "t.root"]
    assert by_name["t.child"].parent == by_name["t.root"].id and by_name["t.root"].parent is None
    assert by_name["t.child"].request == by_name["t.root"].request is not None
    assert rec.counts == {("outside", None): 1, ("n", by_name["t.child"].id): 3, ("n", by_name["t.root"].id): 5}
    assert metrics.records() == metrics.TraceRecords([], {})


def test_span_tree_of_run_vo(runs, scene):
    _, rec, _, _ = runs["vo"]["traced"]
    _, tree = _tree(rec)
    chunks = -(-len(scene.frames) // CHUNK)
    expected = {("vo.run", None): 1, ("vo.read", "vo.run"): 1, ("vo.upload", "vo.run"): chunks,
                ("vo.chunk", "vo.run"): chunks, ("pose.nullspace", "pose.hypotheses"): chunks}
    expected.update({(n, "vo.chunk"): chunks for n in ("vo.draws", "vo.detect", "vo.pose", "vo.keyframe_scan",
                                                         "vo.trajectory")})
    expected.update({(n, "vo.pose"): chunks for n in POSE_STAGES})
    assert dict(tree) == expected
    assert len({s.request for s in rec.spans}) == 1 and rec.spans[0].request is not None
    assert rec.counts == {}


def test_span_tree_of_run_vo_batched(runs):
    _, rec, _, _ = runs["vo_batched"]["traced"]
    _, tree = _tree(rec)
    chunks = -(-9 // CHUNK)
    expected = {("vo.run_batched", None): 1, ("vo.read", "vo.run_batched"): 1,
                ("vo.upload", "vo.run_batched"): chunks, ("vo.chunk", "vo.run_batched"): chunks,
                ("pose.nullspace", "pose.hypotheses"): chunks}
    expected.update({(n, "vo.chunk"): chunks for n in ("vo.draws", "vo.detect", "vo.pose", "vo.keyframe_scan",
                                                         "vo.trajectory")})
    expected.update({(n, "vo.pose"): chunks for n in POSE_STAGES})
    assert dict(tree) == expected
    assert len({s.request for s in rec.spans}) == 1


def test_span_tree_of_run_point_cloud_fused(runs, scene):
    result, rec, iters, _ = runs["flagship"]["traced"]
    _, tree = _tree(rec)
    pairs = len(scene.frames) - 1
    chunks = -(-pairs // CHUNK)
    keyframes = int(result.keyframe_frame_idx.shape[0]) - 1
    solves = result.ba_runs
    assert keyframes >= FLAGSHIP.ba_interval and solves >= 1
    expected = {("flagship.run", None): 1, ("flagship.read", "flagship.run"): 1,
                ("vo.upload", "flagship.run"): 1, ("flagship.chunk", "flagship.run"): chunks,
                ("pose.nullspace", "pose.hypotheses"): chunks,
                ("map.kf_step", "map.phase2"): keyframes,
                # keyframe k of the run (k >= 1; keyframe 0 is frame 0) is number k + 1
                ("map.ba_due.read", "map.kf_step"): (keyframes + 1) // FLAGSHIP.ba_interval,
                ("map.window_ba", "map.kf_step"): solves,
                ("map.prune", "map.kf_step"): (keyframes + 1) // FLAGSHIP.prune_interval,
                ("ba.iteration", "map.window_ba"): sum(iters), ("ba.stop.read", "ba.iteration"): sum(iters)}
    expected.update({(n, "flagship.chunk"): chunks for n in ("vo.upload", "flagship.keyframes.read", "map.phase2",
                                                              "vo.draws", "vo.detect", "vo.pose", "vo.keyframe_scan",
                                                              "vo.trajectory")})
    expected.update({(n, "vo.pose"): chunks for n in POSE_STAGES})
    expected.update({(n, "map.kf_step"): keyframes for n in ("map.match", "map.triangulate", "map.reassociate",
                                                              "map.ring")})
    assert dict(tree) == expected
    assert len({s.request for s in rec.spans}) == 1
    assert len(iters) == solves
    window_ba = {s.id for s in rec.spans if s.name == "map.window_ba"}
    assert {key for key in rec.counts} == {(c, i) for c in ("ba.solves", "ba.lm_iterations") for i in window_ba}
    assert sum(n for (c, _), n in rec.counts.items() if c == "ba.lm_iterations") == sum(iters)
    assert sum(n for (c, _), n in rec.counts.items() if c == "ba.solves") == solves


@pytest.mark.parametrize("name", ["vo", "vo_batched", "flagship"])
def test_span_times_lie_inside_a_bracket_around_the_call(runs, name):
    _, rec, _, (t0, t1) = runs[name]["traced"]
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1, s
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)


def test_disable_restores_the_sync_debug_mode_and_the_warning_filters(monkeypatch):
    """With CUDA stood in for (this host has none): enable sets "warn" and
    counts every occurrence of its warning under the innermost span;
    disable restores the mode, the filters and showwarning."""
    mode = {"now": 0, "set": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])

    def set_mode(m):
        mode["set"].append(m)
        mode["now"] = {"default": 0, "warn": 1, "error": 2}.get(m, m)

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    shown = []
    with warnings.catch_warnings():
        warnings.simplefilter("default")
        warnings.showwarning = lambda message, *args, **kwargs: shown.append(str(message))
        filters, show = list(warnings.filters), warnings.showwarning
        metrics.enable()
        try:
            assert mode["now"] == 1
            with metrics.span("t.read", root=True) as sp:
                for _ in range(3):  # one source line, three occurrences
                    warnings.warn("called a synchronizing CUDA operation")
                warnings.warn("something else")
        finally:
            metrics.disable()
        assert mode["set"] == ["warn", 0] and mode["now"] == 0
        assert warnings.filters == filters and warnings.showwarning is show
    assert shown == ["something else"]
    assert metrics.records().counts == {("syncs", sp.frame[0]): 3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_every_read_span_of_a_flagship_run_counts_a_sync(scene, cuda):
    before = torch.cuda.get_sync_debug_mode()
    result, rec, _, _ = _traced(_pipelines(scene)["flagship"], cuda)
    assert torch.cuda.get_sync_debug_mode() == before and result.ba_runs >= 1
    syncs = collections.Counter()
    for (name, span_id), n in rec.counts.items():
        if name == "syncs":
            syncs[span_id] += n
    reads = [s for s in rec.spans if s.name.endswith(".read")]
    assert {s.name for s in reads} == {"flagship.keyframes.read", "map.ba_due.read", "ba.stop.read",
                                       "flagship.read"}
    assert all(syncs[s.id] >= 1 for s in reads), [(s.name, syncs[s.id]) for s in reads if not syncs[s.id]]
