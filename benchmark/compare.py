"""The numbers that compare a program's answers with the reference's.

Every function takes host arrays of the two sides and returns named
numbers, each of which is 0 where the two sides agree exactly; a cell's
limits file says which of them decide `correct` and their limits.
"""

from __future__ import annotations

import numpy as np


def rotation_gap_deg(ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """Angle between two rotations in degrees, [..., 3, 3] -> [...], from
    their chordal distance (exactly 0 for equal matrices, where arccos of
    the trace would read the rounding of a float32 rotation)."""
    d = np.linalg.norm(np.asarray(ra, np.float64) - np.asarray(rb, np.float64), axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def direction_gap_deg(ta: np.ndarray, tb: np.ndarray) -> np.ndarray:
    """Angle between two directions in degrees, [..., 3] -> [...]."""
    ta, tb = np.asarray(ta, np.float64), np.asarray(tb, np.float64)
    ua = ta / np.maximum(np.linalg.norm(ta, axis=-1, keepdims=True), 1e-300)
    ub = tb / np.maximum(np.linalg.norm(tb, axis=-1, keepdims=True), 1e-300)
    return np.degrees(2.0 * np.arcsin(np.clip(np.linalg.norm(ua - ub, axis=-1) / 2.0, 0.0, 1.0)))


OFF_ROT_DEG = 0.1  # a pair is off by more than this rotation, or
OFF_DIR_DEG = 1.0  # this translation direction (a float-rounding change moves neither)


def _median(x: np.ndarray) -> float:
    return float(np.median(x)) if x.size else 0.0


def pairs(port: dict, ref: dict) -> dict:
    """The pose layer, per frame pair. Each side: `success` [P] bool,
    `rotations` [P, 3, 3], `translations` [P, 3]. The medians over the
    pairs that succeed on both sides admit f32 RANSAC winners that differ
    on a few pairs and still move when most pairs do; `pose_off_share` is
    the share of all pairs on which the sides disagree: success on one side
    only, or a rotation more than OFF_ROT_DEG or a direction more than
    OFF_DIR_DEG apart, so a fault on a tenth of the pairs shows."""
    ok = port["success"] & ref["success"]
    rot = rotation_gap_deg(port["rotations"], ref["rotations"])
    dirs = direction_gap_deg(port["translations"], ref["translations"])
    off = (port["success"] != ref["success"]) | (ok & ((rot > OFF_ROT_DEG) | (dirs > OFF_DIR_DEG)))
    return {
        "rot_gap_p50_deg": _median(rot[ok]),
        "dir_gap_p50_deg": _median(dirs[ok]),
        "pose_off_share": float(off.mean()) if off.size else 0.0,
    }


def ground_truth(success, rotations, gt_rotations) -> dict:
    """The pose layer against the scene's ground truth, as the program's own
    smoke gates read it: the share of pairs that fail, and the median
    rotation error of the pairs that succeed (180 where none does)."""
    ok = np.asarray(success, bool)
    err = rotation_gap_deg(np.asarray(rotations)[ok], np.asarray(gt_rotations)[ok])
    return {"gt_fail_share": 1.0 - float(ok.mean()) if ok.size else 1.0,
            "gt_rot_err_p50_deg": _median(err) if err.size else 180.0}


def relative_rotations(rotations) -> np.ndarray:
    """[N, 3, 3] world-to-camera rotations -> [N-1, 3, 3] rotations from
    each camera to the next (p_next = R p_cur + t)."""
    r = np.asarray(rotations, np.float64)
    return r[1:] @ np.swapaxes(r[:-1], -1, -2)


def keyframe_ground_truth(kf_frames, kf_rotations, scene_rotations) -> dict:
    """A flagship run's keyframe poses against the ground truth: the median
    error of the rotation between consecutive keyframes (180 where there is
    no such pair)."""
    gt = np.asarray(scene_rotations, np.float64)[np.asarray(kf_frames)]
    err = rotation_gap_deg(relative_rotations(kf_rotations), relative_rotations(gt))
    return {"gt_kf_rot_err_p50_deg": _median(err) if err.size else 180.0}


def trajectory(port_frames, port_pos, ref_frames, ref_pos) -> dict:
    """The trajectory layer (and through it the keyframe layer): each side's
    position at every frame from the first reported to the last, held from
    the last frame it reports (a trajectory advances on keyframes only),
    each gap over the reference's path length up to that frame (at least
    one unit). A keyframe flag that differs moves the held position."""
    port_frames, ref_frames = np.asarray(port_frames), np.asarray(ref_frames)
    port_pos, ref_pos = np.asarray(port_pos, np.float64), np.asarray(ref_pos, np.float64)
    path = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(ref_pos, axis=0), axis=1))])
    grid = np.arange(min(port_frames[0], ref_frames[0]), max(port_frames[-1], ref_frames[-1]) + 1)
    pi = np.clip(np.searchsorted(port_frames, grid, side="right") - 1, 0, None)
    ri = np.clip(np.searchsorted(ref_frames, grid, side="right") - 1, 0, None)
    gap = np.linalg.norm(port_pos[pi] - ref_pos[ri], axis=1) / np.maximum(path[ri], 1.0)
    return {"traj_gap_max": float(gap.max()) if gap.size else 0.0}


def mapping(port: dict, ref: dict) -> dict:
    """The mapping layer of a flagship run. Each side: `kf_frames` [N],
    `kf_rotations` [N, 3, 3], `kf_translations` [N, 3] (world-to-camera),
    `ba_runs`, and the map: `valid` [S] bool, `ids` [S], `positions` [S, 3].
    Keyframes are matched by frame and landmarks by slot and id; gaps are
    over the reference's path length (keyframe centres) or the landmark's
    distance from the origin."""
    out = {"ba_run_diff": float(abs(int(port["ba_runs"]) - int(ref["ba_runs"])))}
    _, pi, ri = np.intersect1d(port["kf_frames"], ref["kf_frames"], return_indices=True)
    rot = rotation_gap_deg(port["kf_rotations"][pi], ref["kf_rotations"][ri])
    out["kf_rot_gap_p50_deg"] = _median(rot)
    # Camera centres c = -R^T t of the world-to-camera poses.
    centre = lambda r, t: -np.einsum("nji,nj->ni", np.asarray(r, np.float64), np.asarray(t, np.float64))  # noqa: E731
    cp, cr = centre(port["kf_rotations"][pi], port["kf_translations"][pi]), centre(
        ref["kf_rotations"][ri], ref["kf_translations"][ri])
    path = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(cr, axis=0), axis=1))])
    kf_gap = np.linalg.norm(cp - cr, axis=1) / np.maximum(path, 1.0)
    out["kf_pos_gap_max"] = float(kf_gap.max()) if kf_gap.size else 0.0
    pv, rv = np.asarray(port["valid"], bool), np.asarray(ref["valid"], bool)
    n_ref = max(int(rv.sum()), 1)
    same = pv & rv & (np.asarray(port["ids"]) == np.asarray(ref["ids"]))
    out["landmark_unmatched_share"] = 1.0 - float(same.sum()) / n_ref
    pp, rp = np.asarray(port["positions"], np.float64)[same], np.asarray(ref["positions"], np.float64)[same]
    gap = np.linalg.norm(pp - rp, axis=1) / np.maximum(np.linalg.norm(rp, axis=1), 1.0)
    out["landmark_pos_gap_p50"] = _median(gap)
    return out


def worst(numbers: list[dict]) -> dict:
    """The largest reading of each number over several compared answers."""
    keys = numbers[0].keys()
    return {k: max(n[k] for n in numbers) for k in keys}
