"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (window, answers, check) at a small size on the CPU,
skipping its look for a card, with a fault planted in the port: a step
that returns its state unchanged, half of a batch left out, an answer
altered where it is produced. (One chip: there is no exchange between
chips to leave out.)"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import small


def _run(cell):
    spec, config, traffic, limits = small.files(cell)
    result, compared = harness.run(cell, 2**31 + 29, 0.5, False, time.perf_counter(), device="cpu", spec=spec,
                                   config=config, traffic=traffic, limits=limits)
    return result, compared


def _state_unchanged(monkeypatch):
    """The chunk step returns the carry it was given."""
    import slamtpu_torch.pipeline.vo as vo

    original = vo._frontend

    def frontend(prev_feats, kf_state, global_pose, *args, **kwargs):
        _, result, feats = original(prev_feats, kf_state, global_pose, *args, **kwargs)
        return (prev_feats, kf_state, global_pose), result._replace(
            global_poses=global_pose[:, None].expand_as(result.global_poses)), feats

    monkeypatch.setattr(vo, "_frontend", frontend)


def _answer_altered(monkeypatch):
    """The pose stage's rotations turned by one degree where they are made."""
    import slamtpu_torch.pipeline.vo as vo

    original = vo._pair_poses
    a = torch.deg2rad(torch.tensor(1.0))
    turn = torch.tensor([[torch.cos(a), 0, torch.sin(a)], [0, 1, 0], [-torch.sin(a), 0, torch.cos(a)]])

    def pair_poses(*args, **kwargs):
        rot, *rest = original(*args, **kwargs)
        return (turn.to(rot) @ rot, *rest)

    monkeypatch.setattr(vo, "_pair_poses", pair_poses)


def _tenth_altered(monkeypatch):
    """The rotations of every tenth pair turned by one degree where they are made."""
    import slamtpu_torch.pipeline.vo as vo

    original = vo._pair_poses
    a = torch.deg2rad(torch.tensor(1.0))
    turn = torch.tensor([[torch.cos(a), 0, torch.sin(a)], [0, 1, 0], [-torch.sin(a), 0, torch.cos(a)]])

    def pair_poses(*args, **kwargs):
        rot, *rest = original(*args, **kwargs)
        every_tenth = torch.zeros(rot.shape[:-2], dtype=torch.bool, device=rot.device)
        every_tenth[..., ::10] = True
        return (torch.where(every_tenth[..., None, None], turn.to(rot) @ rot, rot), *rest)

    monkeypatch.setattr(vo, "_pair_poses", pair_poses)


def _half_batch(monkeypatch):
    """The second half of the batch left out: it gets the first half's results."""
    import slamtpu_torch.pipeline.vo as vo

    original = vo._frontend

    def frontend(*args, **kwargs):
        carry, result, feats = original(*args, **kwargs)
        b = result.success.shape[0]
        if b > 1:
            half = lambda x: torch.cat([x[: b // 2], x[: b - b // 2]])  # noqa: E731
            result = type(result)(*[half(x) for x in result])
        return carry, result, feats

    monkeypatch.setattr(vo, "_frontend", frontend)


def _map_state_unchanged(monkeypatch):
    """The flagship's keyframe step returns the mapping state it was given."""
    import slamtpu_torch.pipeline.point_cloud as pc

    original = pc._kf_step

    def kf_step(carry, *args, **kwargs):
        _, out = original(carry, *args, **kwargs)
        return carry, out

    monkeypatch.setattr(pc, "_kf_step", kf_step)


def _landmarks_altered(monkeypatch):
    """Triangulated landmarks placed twice as far where they are made."""
    import slamtpu_torch.pipeline.point_cloud as pc

    original = pc.triangulate_points

    def triangulate(*args, **kwargs):
        xyz, valid = original(*args, **kwargs)
        return xyz * 2.0, valid

    monkeypatch.setattr(pc, "triangulate_points", triangulate)


FAULTS = [
    ("vo-clip257", _state_unchanged), ("vo-clip257", _answer_altered), ("vo-clip257", _tenth_altered),
    ("vo-batch4", _state_unchanged), ("vo-batch4", _answer_altered), ("vo-batch4", _tenth_altered),
    ("vo-batch4", _half_batch),
    ("flagship-clip257", _state_unchanged), ("flagship-clip257", _answer_altered),
    ("flagship-clip257", _map_state_unchanged), ("flagship-clip257", _landmarks_altered),
]


def test_the_small_runs_are_correct_unbroken():
    for cell in sorted({c for c, _ in FAULTS}):
        result, compared = _run(cell)
        assert result["correct"], (cell, compared)


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, compared = _run(cell)
    assert not result["correct"], compared
