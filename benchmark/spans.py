"""Spans from the benchmark's own files: a traced run wraps module
attributes of the program (the layer entry points the per-layer metrics
name) in this process only, and records the host interval of every call.
A span may also keep a small record of each call's arguments."""

from __future__ import annotations

import functools
import importlib
import time


class Recorder:
    def __init__(self):
        self.spans: dict[str, list] = {}  # name -> [(start_ns, end_ns, kept)]
        self._undo = []

    def install(self, name: str, target: str, keep=None) -> None:
        """Wrap `module:attr`; `keep(*args, **kwargs)` picks what to record
        of each call's arguments (None: nothing)."""
        if name in self.spans:
            return
        module_name, attr = target.split(":")
        module = importlib.import_module(module_name)
        original = getattr(module, attr)
        calls = self.spans.setdefault(name, [])

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            kept = keep(*args, **kwargs) if keep is not None else None
            t0 = time.perf_counter_ns()
            try:
                return original(*args, **kwargs)
            finally:
                calls.append((t0, time.perf_counter_ns(), kept))

        setattr(module, attr, wrapper)
        self._undo.append((module, attr, original))

    def remove(self) -> None:
        for module, attr, original in reversed(self._undo):
            setattr(module, attr, original)
        self._undo.clear()

    def total_s(self, name: str) -> float:
        return sum(t1 - t0 for t0, t1, _ in self.spans.get(name, ())) / 1e9

    def count(self, name: str) -> int:
        return len(self.spans.get(name, ()))
