"""CUDA graphs of recurring regions: capture once a shape recurs, then replay.

`run(name, fn, tensors, static)` returns `fn(*tensors)`, a tuple of
tensors (or None), computed one of three ways:

  * eagerly: always for CPU tensors (uncounted, the code as it is); on the
    card for the first sighting of a key, and for a call that cannot be
    captured (`eager=True`, an input whose elements overlap, a key whose
    capture failed, a capture already under way);
  * by capture, at a key's second sighting: the inputs are copied into
    static buffers of the same layout, `fn` runs once on a side stream to
    warm up, once more under capture, and the graph replays;
  * by replay, after: the inputs are copied into the buffers, the graph
    replays, and the outputs are cloned out, so a later replay never
    overwrites what a caller holds.

The key is the name, `static` (everything besides the tensors that `fn`
reads, hashable) and each input's shape, strides, storage offset, dtype
and device. A replay launches the very kernels an eager call of that key
launches, in the same order and on inputs of the same layout, so its bits
are the eager call's. At most `CAPACITY` graphs are kept, the least
recently used dropped first; a dropped key is a first sighting again.

Host bookkeeping of the device work inside a region (a counter, a launch
count) goes through `host_effect`: it runs at once in an eager call, is
skipped in the warm-up, and is recorded in a capture and run again on
every replay. Spans inside a region open in eager calls and captures
only. Each call on the card counts `<layer>.graph_replays`,
`.graph_captures` or `.graph_eager`, the layer being the name's first part.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import warnings

import torch

from .metrics import count

__all__ = ["CAPACITY", "GraphCache", "device_constant", "host_effect", "reset", "run"]

CAPACITY = 16  # graphs kept; the VO pose stage holds 5 a chunk shape, the flagship's map step 1, window BA 2
_SEEN = 64  # keys seen once that are remembered

_SKIP = object()
_effects = None  # None: run host effects now; _SKIP: drop them; a list: record them


def host_effect(fn) -> None:
    """Run fn(), host bookkeeping of work just enqueued, now; inside a
    capture, on every replay of the graph instead."""
    if _effects is None:
        fn()
    elif _effects is not _SKIP:
        _effects.append(fn)


@contextlib.contextmanager
def _effects_mode(mode):
    global _effects
    before, _effects = _effects, mode
    try:
        yield
    finally:
        _effects = before


@functools.lru_cache(maxsize=256)
def device_constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`torch.tensor(value, dtype=dtype, device=device)` built once per
    (value, dtype, device), so a region that reads it copies nothing from
    the host; value is a number or nested tuples. Never written to. On
    CUDA it is copied from pinned memory without blocking, so building it
    costs no host synchronization."""
    host = torch.tensor(value, dtype=dtype)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _buffer_like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of t's shape, strides and storage offset."""
    extent = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())) if t.numel() else 0
    base = torch.empty(t.storage_offset() + extent, dtype=t.dtype, device=t.device)
    return base.as_strided(t.shape, t.stride(), t.storage_offset())


class _Graph:
    """A captured region: its graph, static inputs and outputs, and the host
    effects recorded in the capture."""

    def __init__(self, graph, inputs, outputs, effects):
        self.graph, self.inputs, self.outputs, self.effects = graph, inputs, outputs, effects

    def replay(self, tensors):
        for buf, t in zip(self.inputs, tensors):
            if buf is not None:
                buf.copy_(t)
        self.graph.replay()
        return tuple(None if o is None else o.clone() for o in self.outputs)


class _CudaGraphs:
    """Capture on a side stream per device, each graph with its own pool."""

    def __init__(self):
        self.streams = {}

    def capturing(self) -> bool:
        return torch.cuda.is_current_stream_capturing()

    def capture(self, fn, tensors) -> _Graph:
        device = next(t.device for t in tensors if t is not None)
        with torch.cuda.device(device):
            inputs = tuple(None if t is None else _buffer_like(t).copy_(t) for t in tensors)
            if device not in self.streams:
                self.streams[device] = torch.cuda.Stream(device)
            side = self.streams[device]
            side.wait_stream(torch.cuda.current_stream())
            graph, effects = torch.cuda.CUDAGraph(), []
            with torch.cuda.stream(side):
                with _effects_mode(_SKIP):
                    fn(*inputs)  # warm-up: lazy per-stream state is made outside the capture
                with _effects_mode(effects):
                    graph.capture_begin()
                    try:
                        outputs = tuple(fn(*inputs))
                    finally:
                        graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
        return _Graph(graph, inputs, outputs, effects)


class GraphCache:
    """The policy of `run`: keys, sightings, the bound and the counters.
    `backend` captures (a `_CudaGraphs` unless a test gives another) and
    `device_type` names the tensors it takes."""

    def __init__(self, capacity: int = CAPACITY, backend=None, device_type: str = "cuda"):
        self.capacity, self.device_type = capacity, device_type
        self.backend = _CudaGraphs() if backend is None else backend
        self.graphs = collections.OrderedDict()  # key -> _Graph, or None where the capture failed
        self.seen = collections.OrderedDict()  # keys seen once

    def key(self, name: str, static, tensors) -> tuple:
        return (name, static, *(None if t is None else (tuple(t.shape), t.stride(), t.storage_offset(), t.dtype,
                                                        t.device) for t in tensors))

    def run(self, name: str, fn, tensors, static=(), eager: bool = False):
        live = [t for t in tensors if t is not None]
        if not any(t.device.type == self.device_type for t in live):
            return fn(*tensors)
        layer = name.split(".")[0]
        if (eager or self.backend.capturing() or len({t.device for t in live}) > 1
                or any(s == 0 and n > 1 for t in live for n, s in zip(t.shape, t.stride()))):
            count(f"{layer}.graph_eager")
            return fn(*tensors)
        key = self.key(name, static, tensors)
        entry = None
        if key in self.graphs:
            self.graphs.move_to_end(key)
            entry = self.graphs[key]
        elif key in self.seen:
            del self.seen[key]
            try:
                entry = self.backend.capture(fn, tensors)
            except RuntimeError as err:
                warnings.warn(f"{name}: capture failed, runs eagerly ({err})")
            self.graphs[key] = entry
            if len(self.graphs) > self.capacity:
                self.graphs.popitem(last=False)
            if entry is not None:
                count(f"{layer}.graph_captures")
                return self._replay(entry, tensors)
        else:
            self.seen[key] = True
            if len(self.seen) > _SEEN:
                self.seen.popitem(last=False)
        if entry is None:
            count(f"{layer}.graph_eager")
            return fn(*tensors)
        count(f"{layer}.graph_replays")
        return self._replay(entry, tensors)

    @staticmethod
    def _replay(entry, tensors):
        out = entry.replay(tensors)
        for fx in entry.effects:
            fx()
        return out


_CACHE = GraphCache()


def run(name: str, fn, tensors, static=(), eager: bool = False):
    """fn(*tensors) -> tuple, eagerly or by a CUDA graph of the process's
    cache (see the module's docstring)."""
    return _CACHE.run(name, fn, tuple(tensors), static, eager)


def reset() -> None:
    """Drop every graph and sighting of the process's cache."""
    _CACHE.graphs.clear()
    _CACHE.seen.clear()
