"""The spans and the counter of the port's MonoDepth2 (its host side in
depth/predictor.py, through utils/metrics.py): each call of
`predict_raw`, `predict` or `predict_colored` is one root `depth.predict`
with `depth.upload`, `depth.preprocess`, `depth.encoder`, `depth.decoder`
and `depth.normalize` or `depth.colorize` inside it, in that order;
`depth.frames` counts the frames of each call; tracing changes no bit of
the disparity; with tracing off every depth span is the shared no-op of
the port's other spans, one flag test."""

import numpy as np
import pytest
import torch

from slamtpu_torch.depth import predictor
from slamtpu_torch.depth.monodepth2 import MonoDepth2
from slamtpu_torch.utils import metrics

torch.set_num_threads(1)

H, W = 64, 96
INNER = ["depth.upload", "depth.preprocess", "depth.encoder", "depth.decoder"]


@pytest.fixture(scope="module")
def model():
    return MonoDepth2(width=W, height=H, seed=3, device="cpu")


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(5).integers(0, 256, (3, 80, 120), dtype=np.uint8)


def _calls(model, clip):
    return [("predict_raw", lambda: model.predict_raw(clip), 3, []),
            ("predict", lambda: model.predict(clip[0]), 1, ["depth.normalize"]),
            ("predict_colored", lambda: model.predict_colored(clip[:2]), 2, ["depth.colorize"])]


def test_spans_nest_as_listed_and_frames_are_counted(model, clip):
    metrics.records()
    with metrics.tracing():
        for _, call, _, _ in _calls(model, clip):
            call()
    rec = metrics.records()
    roots = sorted((s for s in rec.spans if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in roots] == ["depth.predict"] * 3
    assert len({s.request for s in roots}) == 3
    for root, (_, _, frames, tail) in zip(roots, _calls(model, clip)):
        children = sorted((s for s in rec.spans if s.parent == root.id), key=lambda s: s.start_ns)
        assert [s.name for s in children] == INNER + tail
        assert all(s.request == root.request and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in children)
        assert rec.counts[("depth.frames", root.id)] == frames
    assert len(rec.spans) == 3 + 3 * len(INNER) + 2
    assert {key[0] for key in rec.counts} == {"depth.frames"}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_tracing_changes_no_bit(model, clip, dtype):
    md = model if dtype is None else MonoDepth2(encoder=model.encoder.state_dict(),
                                                decoder=model.decoder.state_dict(), width=W, height=H,
                                                compute_dtype=dtype, device="cpu")
    plain = md.predict_raw(clip)
    with metrics.tracing():
        traced = md.predict_raw(clip)
    assert metrics.records().spans
    assert torch.equal(plain, traced)


def test_off_every_depth_span_is_the_shared_no_op(model, clip, monkeypatch):
    assert predictor.span is metrics.span and predictor.count is metrics.count
    opened = []

    def recording(name, root=False):
        ctx = metrics.span(name, root)
        opened.append((name, ctx))
        return ctx

    monkeypatch.setattr(predictor, "span", recording)
    assert not metrics._TRACER.on
    for _, call, _, _ in _calls(model, clip):
        call()
    assert sorted({name for name, _ in opened}) == sorted(["depth.predict", *INNER, "depth.normalize",
                                                           "depth.colorize"])
    assert all(ctx is metrics._OFF for _, ctx in opened)
    assert metrics.records() == metrics.TraceRecords([], {})
