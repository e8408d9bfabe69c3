"""The readers of the port's own spans and counters (`program_spans.py` and
the metrics that import it), on the small cells on the CPU: the program's
`vo.detect`, `vo.pose`, `map.phase2` and `map.window_ba` cover what the
benchmark's wrappers `detect`, `pose`, `phase2` and `window_ba` cover;
merging the program's spans into the run's recorder adds no name it had
and moves no accepted metric; against a port without the tracer the new
readers report nothing and raise nothing."""

import time
import types

import pytest
import torch

from benchmark import harness, program_spans, settings
from benchmark.tests import small

NEW = ("hypotheses_host_ms_per_frame", "syncs_per_frame", "host_wait_ms_per_frame", "mapping_self_host_ms_per_frame",
       "ba_iterations_per_solve")
SAME_BOUNDARY = {"detect": "vo.detect", "pose": "vo.pose", "phase2": "map.phase2", "window_ba": "map.window_ba"}
CELLS = ("vo-clip257", "vo-batch4", "flagship-clip257")


def _accepted_readers(spec):
    return {m["name"]: settings.load_module("metrics", m["name"]) for m in spec["per_layer"] if m["name"] not in NEW}


def _traced_run(cell):
    """A traced small run; returns (its Context, the recorder's names and
    the accepted readers' readings just before and just after the merge)."""
    spec, config, traffic, limits = small.files(cell)
    seen = {}
    contexts = []

    class Context(harness.Context):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            contexts.append(self)

    merge = program_spans.merge
    readers = _accepted_readers(spec)

    def watched_merge(ctx, window):
        seen["names"] = set(ctx.spans.spans)
        seen["before"] = {name: r.read(ctx) for name, r in readers.items()}
        merge(ctx, window)
        seen["after"] = {name: r.read(ctx) for name, r in readers.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "Context", Context)
        mp.setattr(program_spans, "merge", watched_merge)
        result, _ = harness.run(cell, 2**31 + 41, 0.5, True, time.perf_counter(), device="cpu", spec=spec,
                                config=config, traffic=traffic, limits=limits)
    assert result["attempted"] >= 1 and result["failed"] == 0
    return contexts[0], seen, result


@pytest.fixture(scope="module")
def runs():
    return {cell: _traced_run(cell) for cell in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_program_spans_cover_what_the_wrappers_cover(runs, cell):
    ctx, _, _ = runs[cell]
    checked = 0
    for wrapper, program in SAME_BOUNDARY.items():
        if not ctx.spans.count(wrapper):
            continue
        outer, inner = ctx.spans.total_s(wrapper), ctx.spans.total_s(program)
        assert ctx.spans.count(program) == ctx.spans.count(wrapper), (wrapper, program)
        assert abs(outer - inner) <= 0.05 * outer + 0.5e-3, (wrapper, outer, program, inner)
        checked += 1
    assert checked == (4 if cell.startswith("flagship") else 2)


@pytest.mark.parametrize("cell", CELLS)
def test_merging_adds_no_name_it_had_and_moves_no_accepted_metric(runs, cell):
    ctx, seen, result = runs[cell]
    added = set(ctx.spans.spans) - seen["names"]
    assert added and all("." in name for name in added)
    assert not added & seen["names"]
    program = {s.name for s in ctx.program_window.spans}
    assert program == added  # every program span merged, none under a recorder name
    assert seen["before"] == seen["after"]
    reported = {k for k, v in seen["after"].items() if v is not None}
    assert reported <= set(result["metrics"])
    for name in reported:
        assert result["metrics"][name]["value"] == pytest.approx(seen["after"][name], rel=0, abs=0)


def test_new_readers_report_nothing_against_a_port_without_the_tracer(monkeypatch):
    import slamtpu_torch.utils.metrics as port_metrics

    monkeypatch.delattr(port_metrics, "records")
    assert program_spans._tracer() is None
    ctx = types.SimpleNamespace(t_start=0, t_end=1, frames=10, device=torch.device("cuda"), spans=None)
    for name in NEW:
        assert settings.load_module("metrics", name).read(ctx) is None, name
    spec, config, traffic, limits = small.files("flagship-clip257")
    result, _ = harness.run("flagship-clip257", 2**31 + 43, 0.5, True, time.perf_counter(), device="cpu",
                            spec=spec, config=config, traffic=traffic, limits=limits)
    assert result["failed"] == 0 and not set(NEW) & set(result["metrics"])
    assert "pose_host_ms_per_frame" in result["metrics"]
