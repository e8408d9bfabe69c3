"""The device side of a traced run: torch.profiler over the measured
window (CUDA activity only, so the host pays for no per-operator records),
reduced to arrays of device intervals on the host's clock."""

from __future__ import annotations

import time

import numpy as np
import torch

_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


class DeviceTrace:
    """Device operations of one window: names, kinds ("kernel", or "copy"
    for a copy or set), starts and ends in ns on `time.perf_counter_ns`'s
    clock."""

    def __init__(self, names, kinds, start_ns, end_ns):
        self.names, self.kinds = names, kinds
        self.start, self.end = np.asarray(start_ns, np.int64), np.asarray(end_ns, np.int64)

    def select(self, kind: str | None = None, contains: str | None = None) -> np.ndarray:
        mask = np.ones(len(self.names), bool)
        if kind is not None:
            mask &= np.array([k == kind for k in self.kinds], bool)
        if contains is not None:
            mask &= np.array([contains in n for n in self.names], bool)
        return mask

    def busy_ns(self) -> int:
        """Length of the union of all device intervals."""
        if not len(self.start):
            return 0
        order = np.argsort(self.start, kind="stable")
        s, e = self.start[order], self.end[order]
        reach = np.maximum.accumulate(e)
        new = np.concatenate([[True], s[1:] > reach[:-1]])
        first = np.nonzero(new)[0]
        ends = np.concatenate([reach[first[1:] - 1], [reach[-1]]])
        return int(np.sum(ends - s[first]))

    def gaps(self, t0: int, t1: int) -> list:
        """Idle intervals (start_ns, end_ns) of the window [t0, t1]."""
        if not len(self.start):
            return [(t0, t1)]
        order = np.argsort(self.start, kind="stable")
        s, e = self.start[order], self.end[order]
        reach = np.maximum.accumulate(e)
        out = []
        if s[0] > t0:
            out.append((t0, int(s[0])))
        idle = np.nonzero(s[1:] > reach[:-1])[0]
        out.extend((int(reach[i]), int(s[i + 1])) for i in idle)
        if reach[-1] < t1:
            out.append((int(reach[-1]), t1))
        return out

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the n device operations with most time."""
        total: dict[str, int] = {}
        for name, d in zip(self.names, (self.end - self.start).tolist()):
            total[name] = total.get(name, 0) + d
        return [[k, v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


class Profiler:
    """torch.profiler around the measured window."""

    def __init__(self):
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def collect(self) -> DeviceTrace:
        # Kineto stamps events on the wall clock; move them to perf_counter's.
        offset = time.perf_counter_ns() - time.time_ns()
        names, kinds, starts, ends = [], [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != cuda:
                continue
            name = ev.name()
            kind = "copy" if name.startswith(_COPY_PREFIXES) else "kernel"
            names.append(name)
            kinds.append(kind)
            t = ev.start_ns() + offset
            starts.append(t)
            ends.append(t + ev.duration_ns())
        return DeviceTrace(names, kinds, starts, ends)
