"""The CUDA-graph cache's policy (`utils/graphs.py`) on the CPU, with the
capture stubbed: a fake graph that recomputes its static outputs from its
static inputs stands in for a CUDA graph, so the real copy-in, replay and
clone-out run. Keys by shape, layout, dtype, device and static fields;
eager on a key's first sighting, captured on its second, replayed after;
a fixed bound with least-recently-used eviction; host effects recorded in
a capture and repeated on every replay; CPU tensors never graphed. The
card's side (real captures, bits equal to eager) is
tests/test_torch_cuda_graphs.py."""

import contextlib

import pytest
import torch

from slamtpu_torch.utils import graphs, metrics

torch.set_num_threads(1)


class _FakeGraph:
    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs, self.replays = fn, inputs, outputs, 0

    def replay(self):
        self.replays += 1
        with graphs._effects_mode(graphs._SKIP):
            for out, new in zip(self.outputs, self.fn(*self.inputs)):
                if out is not None:
                    out.copy_(new)


class _FakeBackend:
    """Captures by running fn once on static copies of the inputs."""

    def __init__(self, fail=False):
        self.captures, self.fail = 0, fail

    def capturing(self):
        return False

    def capture(self, fn, tensors):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.captures += 1
        inputs = tuple(None if t is None else graphs._buffer_like(t).copy_(t) for t in tensors)
        effects = []
        with graphs._effects_mode(effects):
            outputs = tuple(fn(*inputs))
        return graphs._Graph(_FakeGraph(fn, inputs, outputs), inputs, outputs, effects)


def _cache(capacity=graphs.CAPACITY, fail=False):
    return graphs.GraphCache(capacity, _FakeBackend(fail), device_type="cpu")


class _Calls:
    """fn(x, y) -> (x * 2 + y, x.sum()), counting its calls and ticking a
    host effect."""

    def __init__(self):
        self.calls = self.ticks = 0

    def __call__(self, x, y):
        self.calls += 1
        graphs.host_effect(self.tick)
        return x * 2 + y, x.sum()

    def tick(self):
        self.ticks += 1
        metrics.count("pose.ticks")


def _counts(rec):
    out = {}
    for (name, _), n in rec.counts.items():
        out[name] = out.get(name, 0) + n
    return out


@pytest.mark.parametrize("other", ["shape", "dtype", "device", "static", "strides", "offset"])
def test_key_tells_apart(other):
    cache = _cache()
    x = torch.arange(12.0).reshape(3, 4)
    base = cache.key("pose.a", ("cfg", 1), (x, None))
    variant = {
        "shape": lambda: cache.key("pose.a", ("cfg", 1), (x[:2], None)),
        "dtype": lambda: cache.key("pose.a", ("cfg", 1), (x.double(), None)),
        "device": lambda: cache.key("pose.a", ("cfg", 1), (x.to("meta"), None)),
        "static": lambda: cache.key("pose.a", ("cfg", 2), (x, None)),
        "strides": lambda: cache.key("pose.a", ("cfg", 1), (x.t().contiguous().t(), None)),
        "offset": lambda: cache.key("pose.a", ("cfg", 1), (torch.arange(13.0)[1:].reshape(3, 4), None)),
    }[other]()
    assert variant != base
    assert cache.key("pose.a", ("cfg", 1), (x.clone(), None)) == base


def test_eager_first_capture_second_replay_after():
    cache, fn = _cache(), _Calls()
    x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    with metrics.tracing():
        metrics.records()
        outs = [cache.run("pose.a", fn, (x + i, y), static="cfg") for i in range(4)]
        rec = metrics.records()
    for i, (a, s) in enumerate(outs):
        assert torch.equal(a, (x + i) * 2 + y) and torch.equal(s, (x + i).sum())
    assert cache.backend.captures == 1
    counts = _counts(rec)
    assert (counts["pose.graph_eager"], counts["pose.graph_captures"], counts["pose.graph_replays"]) == (1, 1, 2)
    # The host effect ticks once a call: at once when eager, from the
    # capture's record on each replay (the capture itself adds none).
    assert fn.ticks == counts["pose.ticks"] == 4


def test_replay_clones_its_outputs():
    cache, fn = _cache(), _Calls()
    x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    cache.run("pose.a", fn, (x, y))
    first = cache.run("pose.a", fn, (x, y))  # captured
    second = cache.run("pose.a", fn, (x + 10, y))  # replayed into the same static outputs
    assert torch.equal(first[0], x * 2 + y) and torch.equal(second[0], (x + 10) * 2 + y)
    entry = next(iter(cache.graphs.values()))
    assert all(o.data_ptr() != s.data_ptr() for o, s in zip(second, entry.outputs))


def test_inputs_land_in_buffers_of_their_layout():
    """The static buffer of a strided input at an offset has its strides
    and offset, so the captured kernels see the layout the eager call saw."""
    cache, seen = _cache(), []

    def fn(v):
        seen.append((v.stride(), v.storage_offset()))
        return (v * 1,)

    view = torch.arange(40.0).reshape(5, 8)[1:, 2:5]
    for _ in range(2):  # eager, then captured
        cache.run("pose.a", fn, (view,))
    assert len(seen) >= 2 and set(seen) == {(view.stride(), view.storage_offset())}
    shifted = (torch.arange(40.0).reshape(5, 8) + 1)[1:, 2:5]
    assert torch.equal(cache.run("pose.a", fn, (shifted,))[0], view + 1)


def test_bound_evicts_the_least_recently_used():
    cache, fn = _cache(capacity=2), _Calls()
    y = torch.ones(3)
    a, b, c = torch.zeros(3), torch.zeros(3, dtype=torch.float64), torch.zeros(3, dtype=torch.int64)
    for x in (a, a, b, b):  # capture a, then b
        cache.run("pose.a", fn, (x, y.to(x.dtype)))
    assert cache.backend.captures == 2 and len(cache.graphs) == 2
    cache.run("pose.a", fn, (a, y))  # a is now the most recently used
    for x in (c, c):  # capturing c drops b, not a
        cache.run("pose.a", fn, (x, y.to(x.dtype)))
    assert cache.backend.captures == 3 and len(cache.graphs) == 2
    keys = [k[2][3] for k in cache.graphs]  # the first input's dtype
    assert keys == [torch.float32, torch.int64]
    # b was dropped: its next call is a first sighting again (eager), the
    # one after captures it anew.
    with metrics.tracing():
        metrics.records()
        cache.run("pose.a", fn, (b, y.double()))
        cache.run("pose.a", fn, (b, y.double()))
        counts = _counts(metrics.records())
    assert counts["pose.graph_eager"] == 1 and counts["pose.graph_captures"] == 1
    assert cache.backend.captures == 4 and len(cache.graphs) == 2


@pytest.mark.parametrize("why", ["eager", "overlap", "failed"])
def test_calls_that_cannot_be_captured_run_eagerly(why):
    cache, fn = _cache(fail=why == "failed"), _Calls()
    x, y = torch.arange(3.0), torch.ones(3)
    if why == "overlap":
        x = torch.arange(3.0)[None].expand(2, 3)  # stride 0: its elements overlap
        y = torch.ones(2, 3)
    warned = pytest.warns(UserWarning, match="capture failed") if why == "failed" else contextlib.nullcontext()
    with metrics.tracing(), warned:
        metrics.records()
        outs = [cache.run("pose.a", fn, (x, y), eager=why == "eager") for _ in range(3)]
        counts = _counts(metrics.records())
    assert all(torch.equal(o[0], x * 2 + y) for o in outs)
    assert counts["pose.graph_eager"] == 3 and "pose.graph_replays" not in counts
    assert cache.backend.captures == 0 and fn.calls == 3


def test_cpu_tensors_are_never_graphed():
    """A CUDA cache (the process's own) runs CPU tensors as plain calls:
    no sighting, no capture, no counter."""
    fn = _Calls()
    cache = graphs.GraphCache()
    x, y = torch.arange(3.0), torch.ones(3)
    with metrics.tracing():
        metrics.records()
        for _ in range(3):
            assert torch.equal(cache.run("pose.a", fn, (x, y))[0], x * 2 + y)
            assert torch.equal(graphs.run("pose.a", fn, (x, y))[0], x * 2 + y)
        counts = _counts(metrics.records())
    assert not cache.graphs and not cache.seen and not graphs._CACHE.seen
    assert fn.calls == fn.ticks == 6 and not any(k.startswith("pose.graph_") for k in counts)


def test_device_constant_is_built_once():
    a = graphs.device_constant((1.5, -2.0), torch.float32, torch.device("cpu"))
    assert a is graphs.device_constant((1.5, -2.0), torch.float32, torch.device("cpu"))
    assert torch.equal(a, torch.tensor([1.5, -2.0]))
    assert graphs.device_constant(0.1, torch.float32, torch.device("cpu")).item() == torch.tensor(0.1).item()
