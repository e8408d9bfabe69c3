"""Flagship pipeline: VO + keyframe triangulation + global map + windowed
bundle adjustment + PLY/JSON export (counterpart of
slamtpu/pipeline/point_cloud.py: the host loop `run_point_cloud`, the fused
runner `run_point_cloud_fused`, `run_global_ba`, checkpoints and resume).

Phase 1, per chunk of C frame pairs: the VO frontend (features with kernels
K1 and K2, matching, RANSAC pose, keyframe flags). Frame 0 is detected on
its own first, so a run launches each kernel once more than it has chunks.

Phase 2, a host loop over the keyframes of the chunk, device work inside:
re-match the previous KEYFRAME against the current one, triangulate the
matches, insert them into the fixed-capacity map, re-associate the map's
landmarks with the current features (logging those observations), and
every `ba_interval` keyframes run bundle adjustment over the last
`ba_window` keyframes; every `prune_interval` keyframes prune landmarks seen
fewer than `min_observations` times.

As in the JAX package: keyframe poses are a correct world-to-camera chain
T_wc(k) = T_rel(k) @ T_wc(k-1), BA results are written back into the chain
and the map, and the reference-style trajectory (T_global @ T_rel, used
only for trajectory_output.json) is kept beside it. The chain lives on the
host in numpy, with the JAX package's arithmetic and dtypes; the map, the
features and the solves live on the run's device.

`run_point_cloud_fused` keeps all of phase 2 on the device instead (see the
section "Fused phase 2" below): the same schedule and map updates, the
chain in `pose_dtype`, a few host reads per chunk.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..feature.detector import OrbFeatures, detect_and_compute
from ..feature.matcher import FeatureMatcher
from ..mapping.bundle_adjustment import BaConfig, ObservationBatch, _lm, _lm_setup, _plan, ba_solve, compute_total_error
from ..mapping.keyframe import KeyframeConfig, KeyframeState
from ..mapping.map import (
    MapState,
    _set_rows,
    map_find_matches,
    map_insert,
    map_prune,
    map_update_observations,
)
from ..mapping.triangulation import MapPoint, triangulate_points
from ..odometry.camera import CameraIntrinsics
from ..odometry.trajectory import Trajectory
from ..ops.hamming import descriptor_bits
from ..utils import graphs
from ..utils.metrics import span
from .vo import VoConfig, require_orb, vo_frontend

__all__ = ["PointCloudConfig", "PointCloudResult", "run_point_cloud", "run_point_cloud_fused", "run_global_ba"]


@dataclasses.dataclass(frozen=True)
class PointCloudConfig:
    """The JAX package's PointCloudConfig, same defaults."""

    vo: VoConfig = VoConfig(keyframe=KeyframeConfig(min_translation=0.03, min_rotation=0.03,
                                                    min_match_ratio=0.7, max_frames=3))
    ba_interval: int = 5
    ba_window: int = 5
    prune_interval: int = 10
    map_capacity: int = 16384
    max_ba_observations: int = 4096
    max_ba_landmarks: int = 2048  # distinct landmarks per BA window
    max_obs_per_kf: int = 1024  # fused runner: observation slots per keyframe
    # BA observation gate: drop re-association matches whose landmark
    # reprojects more than this many pixels from the matched keypoint
    # (the loose descriptor-only match lets wrong associations with 100 px+
    # residuals through, and they poison the solve). 0 disables.
    obs_max_reproj_px: float = 8.0
    ba: BaConfig = BaConfig()
    min_observations: int = 2


@dataclasses.dataclass
class PointCloudResult:
    map_state: MapState
    trajectory: Trajectory  # reference-style composition, for the JSON artifact
    keyframe_rotations: np.ndarray  # [N_kf, 3, 3] world-to-camera
    keyframe_translations: np.ndarray  # [N_kf, 3]
    keyframe_frame_idx: np.ndarray  # [N_kf] frame index of each keyframe
    ba_runs: int
    total_frames: int
    successful_frames: int
    # Observation log (kf [N] int32, map slot [N] int32, pixel [N, 2] f32,
    # landmark id at logging time [N] int32).
    observations: tuple = None

    def points(self):
        valid = self.map_state.valid.cpu().numpy()
        pos = self.map_state.positions.cpu().numpy()
        desc = self.map_state.descriptors.cpu().numpy()
        obs = self.map_state.observations.cpu().numpy()
        ids = self.map_state.ids.cpu().numpy()
        return [MapPoint(position=pos[i], descriptor=desc[i], observations=int(obs[i]), id=int(ids[i]))
                for i in np.nonzero(valid)[0]]

    def stable_points(self, min_observations: int = 2):
        return [p for p in self.points() if p.observations >= min_observations]

    def save(self, ply="point_cloud.ply", pc_json="point_cloud.json", traj_json="trajectory_output.json"):
        from ..io.export import save_json, save_ply

        points = self.points()
        save_ply(points, ply)
        save_json(points, pc_json)
        self.trajectory.save_to_file(traj_json)

    def save_checkpoint(self, path: str) -> None:
        """Resumable pipeline state (io/checkpoint.py); pass the directory to
        run_point_cloud or run_point_cloud_fused as resume_from to continue
        on more frames."""
        from ..io.checkpoint import save_pipeline_state

        save_pipeline_state(path, self.map_state, self.keyframe_rotations, self.keyframe_translations,
                            self.keyframe_frame_idx, self.trajectory, self.observations)


def _match_keyframes(prev_desc, prev_mask, desc, mask):
    """Previous keyframe vs current frame, with the reference's ratio filter."""
    matcher = FeatureMatcher()
    return matcher.filter_good_matches(matcher.match_descriptors(prev_desc, desc, prev_mask, mask), 2.0)


def _triangulate_and_insert(state: MapState, intrinsics, pose1, pose2, xy1, xy2, desc2, good_mask):
    xyz, valid = triangulate_points(intrinsics, pose1, pose2, xy1, xy2)
    return map_insert(state, xyz, desc2, valid & good_mask)


def _reassociate(state: MapState, intrinsics, desc, mask, xy, pose, max_reproj_px: float, map_bits=None,
                 map_pops=None):
    """Match the map against one keyframe's features. Returns the new state
    (observation counts raised), the matched keypoint per slot and the
    slots whose match passes the reprojection gate (these are logged).
    map_bits/map_pops: the map's unpacked descriptors, when carried."""
    idx, good, dist = map_find_matches(state, intrinsics, desc, mask, pose[0], pose[1], map_bits=map_bits,
                                       map_pops=map_pops, frame_xy=xy)
    state = map_update_observations(state, good)
    if max_reproj_px:
        good = good & (dist < max_reproj_px)
    return state, idx, good


def _log_observations(state: MapState, feats: OrbFeatures, idx, good):
    """(slots, keypoint pixels, landmark ids) of the logged slots, in slot
    order, on the host."""
    slots = torch.nonzero(good)[:, 0]
    return (slots.to(torch.int32).cpu().numpy(), feats.xy[idx[slots]].cpu().numpy(),
            state.ids[slots].cpu().numpy())


def run_point_cloud(frames, intrinsics: CameraIntrinsics, config: PointCloudConfig = PointCloudConfig(),
                    chunk_size: int | None = None, seed: int = 0, resume_from: str | None = None,
                    rerun_logger=None, device=None, uniforms=None,
                    pose_dtype: torch.dtype = torch.float32) -> PointCloudResult:
    """Run the flagship over a clip [T, H, W] (uint8/float, numpy or tensor)
    on `device` ("cuda" when None; raises without one).

    chunk_size: frame pairs per frontend call (None = all). RANSAC draws
    come from `seed`, one generator per global pair index
    (ops/ransac.py::pair_uniforms), or from `uniforms` [T-1, iters, K].
    resume_from: a directory written by PointCloudResult.save_checkpoint;
    the map, keyframe chain, trajectory and observation log continue from
    it (frame indices of the new keyframes count from this clip's frame 0).
    rerun_logger: optional `utils.metrics.RerunLogger`; when active, the
    JAX host loop's viewer events are replayed at the same points: every
    frame's image, each keyframe's camera transform and match overlays, the
    map points and the trajectory strip after each keyframe's BA and prune.
    The host reads they need are made only for an active logger.
    pose_dtype: the dtype of the frontend's device pose chain (f32 as in
    the JAX package without x64); the keyframe chain is numpy f64.
    """
    require_orb(config.vo, "run_point_cloud")
    rr_log = rerun_logger if (rerun_logger is not None and rerun_logger.active) else None
    dev = resolve_device(device)
    t_total = frames.shape[0]
    n_pairs = t_total - 1
    chunk = chunk_size or max(n_pairs, 1)

    feats0 = _first_features(frames, config, dev)
    if resume_from:
        map_state, kf_rots, kf_trans, kf_frames, trajectory, observations = _load_resume(resume_from, config, dev)
        log = _log_by_keyframe(observations, len(kf_rots))
    else:
        map_state = MapState.empty(config.map_capacity, torch.float32, dev)
        trajectory = Trajectory()
        kf_rots = [np.eye(3)]
        kf_trans = [np.zeros(3)]
        kf_frames = [0]
        # Observation log, one entry per keyframe >= 1: (slots, pixels, ids).
        # Slots are recycled by prune and insert, so BA keeps an observation
        # only while its slot still holds the landmark id logged with it.
        log = []
    carry = (feats0, KeyframeState.initial(dev), torch.as_tensor(trajectory.global_pose, dtype=pose_dtype,
                                                                 device=dev))
    prev_feats = feats0
    n_logged = sum(len(entry[0]) for entry in log)
    ba_runs = 0
    successful = 0

    for start in range(0, n_pairs, chunk):
        stop = min(start + chunk, n_pairs)
        block = torch.as_tensor(frames[start + 1 : stop + 1]).to(dev)
        draws = None if uniforms is None else torch.as_tensor(uniforms[start:stop]).to(dev)
        prev_frame = torch.as_tensor(frames[start]).to(dev) if config.vo.refine_matches else None
        carry, res, feats_new = vo_frontend(*carry, block, intrinsics, config.vo, uniforms=draws, seed=seed,
                                            first_step=start + 1, prev_frame=prev_frame)
        success, is_kf, rotations, translations = (
            x.cpu().numpy() for x in (res.success, res.is_keyframe, res.rotations, res.translations))
        successful += int(success.sum())

        if rr_log:
            for i in range(start + 1, stop + 1):
                rr_log.set_frame(i)
                rr_log.log_frame(_host_frame(frames, i))

        for local_idx in np.nonzero(is_kf)[0]:
            frame_idx = start + int(local_idx) + 1
            rel_r, rel_t = rotations[local_idx], translations[local_idx]
            trajectory.update(rel_r, rel_t, frame_idx + 1, frame_idx / config.vo.fps)
            new_r = rel_r @ kf_rots[-1]
            new_t = rel_r @ kf_trans[-1] + rel_t
            cur_feats = OrbFeatures(*[x[local_idx] for x in feats_new])

            good = _match_keyframes(prev_feats.descriptors, prev_feats.mask, cur_feats.descriptors, cur_feats.mask)
            pose_prev = (_f32(kf_rots[-1], dev), _f32(kf_trans[-1], dev))
            pose_cur = (_f32(new_r, dev), _f32(new_t, dev))
            xy2 = cur_feats.xy[good.train_idx]
            map_state = _triangulate_and_insert(
                map_state, intrinsics, pose_prev, pose_cur, prev_feats.xy, xy2,
                cur_feats.descriptors[good.train_idx], good.mask)
            kf_rots.append(np.asarray(new_r))
            kf_trans.append(np.asarray(new_t))
            kf_frames.append(frame_idx)

            if rr_log:
                rr_log.set_frame(frame_idx)
                rr_log.log_camera(new_r, new_t)
                p_prev, p_cur = prev_feats.xy[good.mask].cpu().numpy(), xy2[good.mask].cpu().numpy()
                rr_log.log_matches_2d(p_prev, p_cur)
                rr_log.log_matches_image(_host_frame(frames, kf_frames[-2]), _host_frame(frames, frame_idx),
                                         p_prev, p_cur)
            prev_feats = cur_feats

            map_state, idx, good = _reassociate(map_state, intrinsics, cur_feats.descriptors, cur_feats.mask,
                                                cur_feats.xy, pose_cur, config.obs_max_reproj_px)
            log.append(_log_observations(map_state, cur_feats, idx, good))
            n_logged += len(log[-1][0])

            n_kf = len(kf_rots)
            if config.ba_interval and n_kf % config.ba_interval == 0 and n_logged:
                map_state, kf_rots, kf_trans, did_run = _run_window_ba(map_state, intrinsics, kf_rots, kf_trans,
                                                                       log, config)
                ba_runs += int(did_run)  # a window with no surviving observation runs no solve
            if config.prune_interval and n_kf % config.prune_interval == 0:
                map_state = map_prune(map_state, config.min_observations)

            if rr_log:
                rr_log.log_points(map_state.positions[map_state.valid].cpu().numpy())
                rr_log.log_trajectory(np.asarray([p.position for p in trajectory.points], np.float32))

    return PointCloudResult(
        map_state=map_state,
        trajectory=trajectory,
        keyframe_rotations=np.stack(kf_rots),
        keyframe_translations=np.stack(kf_trans),
        keyframe_frame_idx=np.asarray(kf_frames),
        ba_runs=ba_runs,
        total_frames=t_total,
        successful_frames=successful,
        observations=_flatten_log(log, 0),
    )


def _host_frame(frames, i: int) -> np.ndarray:
    """Frame i of a numpy or tensor clip, as a host array (for the viewer)."""
    frame = frames[i]
    return frame.cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _first_features(frames, config: PointCloudConfig, dev) -> OrbFeatures:
    """Frame 0's features (one launch of each kernel)."""
    with span("vo.upload"):
        frame0 = torch.as_tensor(frames[:1]).to(dev)
    feats0 = detect_and_compute(frame0, config.vo.orb)
    return OrbFeatures(*[x[0] for x in feats0])


def _load_resume(path: str, config: PointCloudConfig, dev):
    """A checkpoint as (map_state, kf_rots, kf_trans, kf_frames as lists,
    trajectory, observations)."""
    from ..io.checkpoint import load_pipeline_state

    map_state, kf_r, kf_t, kf_frames, trajectory, observations = load_pipeline_state(path, dev)
    if map_state.capacity != config.map_capacity:
        raise ValueError(f"checkpoint map capacity {map_state.capacity} != configured {config.map_capacity}")
    return (map_state, [np.asarray(r) for r in kf_r], [np.asarray(t) for t in kf_t], [int(f) for f in kf_frames],
            trajectory, observations)


def _log_by_keyframe(observations, n_kf: int) -> list:
    """A restored observation log as the host loop's entries, one per
    keyframe 1..n_kf-1 in order (keyframe 0 observes nothing)."""
    if observations is None:
        observations = (np.zeros(0, np.int32),) * 2 + (np.zeros((0, 2), np.float32), np.zeros(0, np.int32))
    kf, slot, px, oid = (np.asarray(a) for a in observations)
    if kf.size and (kf.min() < 1 or kf.max() >= n_kf):
        raise ValueError(f"checkpoint observations name keyframes outside 1..{n_kf - 1}")
    order = np.argsort(kf, kind="stable")
    bounds = np.searchsorted(kf[order], np.arange(1, n_kf + 1))
    px = np.asarray(px, np.float32).reshape(-1, 2)
    return [(slot[order[a:b]].astype(np.int32), px[order[a:b]], oid[order[a:b]].astype(np.int32))
            for a, b in zip(bounds[:-1], bounds[1:])]


def _flatten_log(log, first: int):
    """The log's entries from index `first` as (kf, slot, pixel, id) arrays;
    entry i belongs to keyframe i + 1."""
    entries = log[first:]
    if not entries:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 2), np.float32),
                np.zeros(0, np.int32))
    kf = [np.full(len(e[0]), first + i + 1, np.int32) for i, e in enumerate(entries)]
    return (np.concatenate(kf), np.concatenate([e[0] for e in entries]).astype(np.int32),
            np.concatenate([e[1] for e in entries]).astype(np.float32).reshape(-1, 2),
            np.concatenate([e[2] for e in entries]).astype(np.int32))


def _ba_window_solve(positions, rot_w, trans_w, pose_mask, slots, l_mask, kf_idx, pt_idx, pixels, obs_mask,
                     intrinsics, ba_config, fix_first_pose):
    """Windowed BA on compact shapes: the window's poses [P_w] and its
    observed landmarks [L_w] gathered from the map by slot; optimised
    landmarks are written back into the full positions.

    On CUDA the segment sums run in gather mode with the window size as the
    observer bound: a landmark is observed at most once per window keyframe
    (checked by the caller), so no observation is dropped. On the CPU they
    are the scatter-adds of the JAX package's CPU path.
    """
    obs = ObservationBatch(kf_idx, pt_idx, pixels, obs_mask)
    seg_kw = dict(segment_method="gather", gather_k_pt=rot_w.shape[0]) if rot_w.device.type == "cuda" else {}
    new_rot, new_trans, new_pts, _, _ = ba_solve(
        intrinsics, rot_w, trans_w, positions[slots].to(rot_w.dtype), obs, ba_config,
        fix_first_pose=fix_first_pose, pose_mask=pose_mask, **seg_kw)
    # Padding rows of `slots` are 0: route them to a dropped scratch row so
    # slot 0 is written once, with its optimised value.
    safe_slots = torch.where(l_mask, slots, positions.shape[0])
    return new_rot, new_trans, _set_rows(positions, safe_slots, new_pts.to(positions.dtype))


def _run_window_ba(map_state, intrinsics, kf_rots, kf_trans, log, config):
    """Windowed BA over the last ba_window keyframes, written back.

    Local BA drops observations of older keyframes. The observation log is
    walked newest first, skipping observations whose slot was pruned or
    recycled since, up to max_ba_observations observations of at most
    max_ba_landmarks distinct landmarks; the problem is padded to those
    sizes and ba_window poses.
    """
    n_kf = len(kf_rots)
    start_idx = max(n_kf - config.ba_window, 0)
    p_w, m_max, l_max = config.ba_window, config.max_ba_observations, config.max_ba_landmarks

    kf, slot, px, oid = (a[::-1] for a in _flatten_log(log, max(start_idx - 1, 0)))
    valid_np = map_state.valid.cpu().numpy()
    ids_np = map_state.ids.cpu().numpy()
    ok = valid_np[slot] & (ids_np[slot] == oid)
    kf, slot, px = kf[ok], slot[ok], px[ok]
    if not kf.size:
        return map_state, kf_rots, kf_trans, False
    # Compact landmark index = order of first appearance, newest first; a
    # landmark past l_max is skipped, and the walk stops after m_max.
    uniq, first, inverse = np.unique(slot, return_index=True, return_inverse=True)
    by_first = np.argsort(first, kind="stable")
    compact_of = np.empty(uniq.size, np.int64)
    compact_of[by_first] = np.arange(uniq.size)
    compact = compact_of[inverse]
    keep = np.nonzero(compact < l_max)[0][:m_max]
    kf_l, pt_l, px_l = kf[keep] - start_idx, compact[keep], px[keep]
    n_land = int(pt_l.max()) + 1
    if np.unique(kf_l * l_max + pt_l).size != kf_l.size:
        raise RuntimeError("a landmark is observed twice by one window keyframe: the gather-mode "
                           "observer bound (the window size) would drop observations")

    m = kf_l.size
    kf_arr = np.zeros(m_max, np.int64)
    pt_arr = np.zeros(m_max, np.int64)
    px_arr = np.zeros((m_max, 2), np.float32)
    obs_mask = np.zeros(m_max, bool)
    kf_arr[:m], pt_arr[:m], px_arr[:m], obs_mask[:m] = kf_l, pt_l, px_l, True
    slots = np.zeros(l_max, np.int64)
    l_mask = np.zeros(l_max, bool)
    slots[:n_land] = uniq[by_first[:n_land]]
    l_mask[:n_land] = True

    n_window = n_kf - start_idx  # <= p_w
    rot_w = np.tile(np.eye(3, dtype=np.float32), (p_w, 1, 1))
    trans_w = np.zeros((p_w, 3), np.float32)
    rot_w[:n_window] = np.stack(kf_rots[start_idx:])
    trans_w[:n_window] = np.stack(kf_trans[start_idx:])
    pose_mask = np.zeros(p_w, bool)
    pose_mask[:n_window] = True
    # Anchor the window: its two oldest poses are frozen. One pins the 6-DOF
    # gauge, the second the monocular scale (reprojection is invariant under
    # a similarity, so an unanchored window drifts).
    pose_mask[: min(2, n_window)] = False

    dev = map_state.positions.device
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    new_rot, new_trans, new_positions = _ba_window_solve(
        map_state.positions, t(rot_w), t(trans_w), t(pose_mask), t(slots), t(l_mask), t(kf_arr), t(pt_arr),
        t(px_arr), t(obs_mask), intrinsics, config.ba, False)  # gauge: the frozen anchors
    map_state = map_state._replace(positions=new_positions)
    new_rot, new_trans = new_rot.cpu().numpy(), new_trans.cpu().numpy()
    kf_rots, kf_trans = list(kf_rots), list(kf_trans)
    for j in range(n_window):
        kf_rots[start_idx + j] = new_rot[j]
        kf_trans[start_idx + j] = new_trans[j]
    return map_state, kf_rots, kf_trans, True


def run_global_ba(result: PointCloudResult, intrinsics: CameraIntrinsics, ba_config: BaConfig | None = None,
                  landmark_chunk: int = 2048, schur_method: str = "auto", coobs_k: int | None = None,
                  device=None):
    """One joint LM solve over all keyframes and logged observations, on
    `device` ("cuda" when None). The two oldest keyframes are frozen (gauge
    and scale); observations whose slot was pruned or recycled are dropped.
    schur_method "auto" takes the co-observation assembly past 256 poses
    and the dense one below; coobs_k defaults to the largest observer count,
    at most 64 (a note on stderr counts what that drops).

    Returns (new_result, error_before, error_after): total Huber
    reprojection error over the retained observations, f32.
    """
    dev = resolve_device(device)
    obs_kf, obs_pt, obs_px, obs_id = result.observations
    if len(obs_kf) == 0 or result.keyframe_rotations.shape[0] < 3:
        return result, 0.0, 0.0

    ids_np = result.map_state.ids.cpu().numpy()
    valid_np = result.map_state.valid.cpu().numpy()
    obs_kf = np.asarray(obs_kf, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    obs_px = np.asarray(obs_px, np.float32).reshape(-1, 2)
    ok = valid_np[obs_pt] & (ids_np[obs_pt] == np.asarray(obs_id))
    obs_kf, obs_pt, obs_px = obs_kf[ok], obs_pt[ok], obs_px[ok]
    if obs_kf.size == 0:
        return result, 0.0, 0.0

    uniq_slots, pt_idx = np.unique(obs_pt, return_inverse=True)
    positions = result.map_state.positions
    points = positions[torch.from_numpy(uniq_slots).to(positions.device)].to(device=dev, dtype=torch.float32)
    rot = torch.as_tensor(np.asarray(result.keyframe_rotations, np.float32), device=dev)
    trans = torch.as_tensor(np.asarray(result.keyframe_translations, np.float32), device=dev)
    pose_mask = torch.ones(rot.shape[0], dtype=torch.bool, device=dev)
    pose_mask[:2] = False

    obs = ObservationBatch(torch.from_numpy(obs_kf).to(dev), torch.from_numpy(pt_idx.astype(np.int64)).to(dev),
                           torch.from_numpy(obs_px).to(dev), torch.ones(obs_kf.size, dtype=torch.bool, device=dev))
    cfg = ba_config or BaConfig()
    err_before = float(compute_total_error(intrinsics, rot, trans, points, obs, cfg.huber_delta))
    if schur_method == "auto":
        schur_method = "coobs" if rot.shape[0] > 256 else "dense"
    if schur_method == "coobs" and coobs_k is None:
        # Derived from the observation structure: the largest observer
        # count, capped at 64 (O(L K^2) work in K passes).
        observers = np.bincount(pt_idx, minlength=uniq_slots.size)
        coobs_k = int(min(max(observers.max(), 1), 64))
        dropped = int(np.maximum(observers - coobs_k, 0).sum())
        if dropped:
            import sys

            print(f"run_global_ba: coobs_k={coobs_k} (capped) drops {dropped}/{pt_idx.size} observations "
                  "on over-observed landmarks", file=sys.stderr)
    elif coobs_k is None:
        coobs_k = 16  # unused by the dense path
    new_rot, new_trans, new_pts, err_after, _ = ba_solve(
        intrinsics, rot, trans, points, obs, cfg, fix_first_pose=False, pose_mask=pose_mask,
        landmark_chunk=landmark_chunk, schur_method=schur_method, coobs_k=coobs_k)

    new_positions = positions.clone()
    new_positions[torch.from_numpy(uniq_slots).to(positions.device)] = new_pts.to(positions)
    new_result = dataclasses.replace(
        result,
        map_state=result.map_state._replace(positions=new_positions),
        keyframe_rotations=new_rot.cpu().numpy(),
        keyframe_translations=new_trans.cpu().numpy(),
        ba_runs=result.ba_runs + 1,
    )
    return new_result, err_before, float(err_after)


# ---------------------------------------------------------------------------
# Fused phase 2 (counterpart of the JAX package's scan-fused runner).
#
# The map, the free-slot table, the unpacked map descriptors and the BA
# observation ring stay on the device for the whole run, and each keyframe
# step returns compact outputs that are stacked per chunk and fetched once,
# after the last chunk. The JAX scan becomes a Python loop over the chunk's
# steps: the host reads the chunk's keyframe flags once, and one scalar
# (does the ring hold an observation?) on the steps where BA is due. The
# keyframe count, and with it the BA and prune predicates, is therefore
# known on the host, and BA and the free-table rebuild run only on the steps
# whose predicate holds, as lax.cond runs only the taken branch. Nothing
# else in a step reads the device: dropped scatter rows go to a scratch row
# (mapping/map.py::_set_rows), so every kept row is written once and two
# CUDA runs agree. On the card the step's device-only part, everything
# before the BA-due read, replays one CUDA graph (`_map_step`).
# ---------------------------------------------------------------------------


class _FusedCarry(NamedTuple):
    """Phase 2's state between keyframe steps: tensors on the run's device,
    except kf_count, which the host keeps."""

    map_state: MapState
    # Free slots in index order as a rank -> slot table (cap = none) and the
    # next unconsumed rank: rebuilt only on prune steps, consumed in order
    # by inserts (between prunes the free set only shrinks from the front).
    free_slots: torch.Tensor  # [cap] int32
    free_head: torch.Tensor  # int32 scalar
    # Unpacked map descriptors for re-association (ops/hamming.py layout),
    # updated on the rows each insert writes; freed slots keep stale bits,
    # which map_find_matches masks by validity.
    map_bits: torch.Tensor  # [cap, 256] bf16
    map_pops: torch.Tensor  # [cap] f32
    prev_xy: torch.Tensor  # [K, 2] the previous keyframe's keypoints
    prev_desc: torch.Tensor  # [K, 32]
    prev_mask: torch.Tensor  # [K]
    prev_rot: torch.Tensor  # [3, 3] world-to-camera of the previous keyframe (pose dtype)
    prev_trans: torch.Tensor  # [3]
    kf_count: int  # keyframes so far, keyframe 0 included
    ring_rot: torch.Tensor  # [W, 3, 3] the last W keyframe poses, oldest first
    ring_trans: torch.Tensor  # [W, 3]
    ring_kf: torch.Tensor  # [W] int32 global keyframe index (-1 = empty)
    ring_slots: torch.Tensor  # [W, O] int32 observed map slots
    ring_ids: torch.Tensor  # [W, O] int32 landmark id at observation time
    ring_px: torch.Tensor  # [W, O, 2] f32 observed pixels
    ring_mask: torch.Tensor  # [W, O] bool


class _FusedStepOut(NamedTuple):
    """One step's outputs (stacked over a chunk's steps by
    _fused_phase2_chunk). kf_idx and ba_flag are decided on the host and
    stay there; the rest are device tensors."""

    kf_idx: int  # -1 when the step created no keyframe
    new_rot: torch.Tensor  # [3, 3] the new keyframe's pose before BA
    new_trans: torch.Tensor  # [3]
    ba_flag: bool
    ring_rot: torch.Tensor  # [W, 3, 3] after BA
    ring_trans: torch.Tensor  # [W, 3]
    ring_kf: torch.Tensor  # [W]
    obs_slots: torch.Tensor  # [O]
    obs_ids: torch.Tensor  # [O]
    obs_px: torch.Tensor  # [O, 2]
    obs_mask: torch.Tensor  # [O]


def _free_table(state: MapState):
    """Free slots in index order as a rank -> slot table (cap = no slot),
    and rank 0: the ranking map_insert computes per call."""
    cap, dev = state.capacity, state.valid.device
    free = ~state.valid
    free_rank = torch.cumsum(free, dim=0, dtype=torch.int32) - 1
    table = _set_rows(torch.full((cap,), cap, dtype=torch.int32, device=dev), torch.where(free, free_rank, cap),
                      torch.arange(cap, dtype=torch.int32, device=dev))
    return table, torch.zeros((), dtype=torch.int32, device=dev)


def _map_insert_at(state: MapState, free_slots, free_head, positions, descriptors, mask):
    """map_insert consuming the carried free table: the same slots and ids.
    Returns (new state, new free_head, slot per row (cap = dropped))."""
    cap = state.capacity
    rank = torch.cumsum(mask, dim=0, dtype=torch.int32) - 1
    pos = free_head + rank
    # Table entries past the free count hold cap. Ranks past the table's end
    # would clamp onto its last entry, a live slot when the table was built
    # on an empty map: they are dropped too, as map_insert drops rows beyond
    # the free count.
    slot = torch.where(mask & (pos < cap), free_slots[torch.clamp(pos, 0, cap - 1)], cap)
    n_new = torch.sum(mask, dtype=torch.int32)
    new_state = MapState(
        positions=_set_rows(state.positions, slot, positions),
        descriptors=_set_rows(state.descriptors, slot, descriptors),
        observations=_set_rows(state.observations, slot, 1),
        ids=_set_rows(state.ids, slot, state.next_id + rank),
        valid=_set_rows(state.valid, slot, True),
        next_id=state.next_id + n_new,
    )
    return new_state, free_head + n_new, slot


def _fused_carry_init(config: PointCloudConfig, feats0: OrbFeatures, pose_dtype) -> _FusedCarry:
    """An empty map and a ring holding keyframe 0 (identity) as its newest
    entry."""
    dev = feats0.xy.device
    w, o_cap = config.ba_window, config.max_obs_per_kf
    ring_kf = torch.cat([torch.full((w - 1,), -1, dtype=torch.int32, device=dev),
                         torch.zeros((1,), dtype=torch.int32, device=dev)])
    empty = MapState.empty(config.map_capacity, torch.float32, dev)
    table0, head0 = _free_table(empty)
    bits0, pops0 = descriptor_bits(empty.descriptors)
    eye = torch.eye(3, dtype=pose_dtype, device=dev)
    return _FusedCarry(
        map_state=empty, free_slots=table0, free_head=head0, map_bits=bits0, map_pops=pops0,
        prev_xy=feats0.xy, prev_desc=feats0.descriptors, prev_mask=feats0.mask,
        prev_rot=eye, prev_trans=torch.zeros((3,), dtype=pose_dtype, device=dev), kf_count=1,
        ring_rot=eye.expand(w, 3, 3).clone(), ring_trans=torch.zeros((w, 3), dtype=pose_dtype, device=dev),
        ring_kf=ring_kf, ring_slots=torch.zeros((w, o_cap), dtype=torch.int32, device=dev),
        ring_ids=torch.full((w, o_cap), -1, dtype=torch.int32, device=dev),
        ring_px=torch.zeros((w, o_cap, 2), dtype=torch.float32, device=dev),
        ring_mask=torch.zeros((w, o_cap), dtype=torch.bool, device=dev),
    )


def _window_problem(positions, valid, ids, ring_rot, ring_trans, ring_kf, ring_slots, ring_ids, ring_px, ring_mask,
                    *, plan, config: PointCloudConfig):
    """Region `ba.setup` of the fused runner: the ring's compact problem and
    the solve's tables. Returns (landmarks, kf_idx, pt_idx, pixels, mask,
    free poses, write-back slots (capacity = dropped), *_lm_setup's)."""
    w, o_cap = config.ba_window, config.max_obs_per_kf
    live = ring_kf >= 0
    # Drop observations whose slot was pruned or recycled since recording.
    obs_ok = ring_mask & live[:, None] & valid[ring_slots] & (ids[ring_slots] == ring_ids)
    l_max = min(config.max_ba_landmarks, w * o_cap)
    big = valid.shape[0]
    flat_slots = ring_slots.reshape(-1)
    flat_ok = obs_ok.reshape(-1)
    skeys = torch.sort(torch.where(flat_ok, flat_slots, big)).values
    firsts = torch.cat([torch.ones((1,), dtype=torch.bool, device=skeys.device), skeys[1:] != skeys[:-1]])
    uniq = torch.sort(torch.where(firsts, skeys, big)).values[:l_max]
    l_mask = uniq < big
    pt_c = torch.clamp(torch.searchsorted(uniq, flat_slots), 0, l_max - 1)
    ok_c = flat_ok & (uniq[pt_c] == flat_slots)
    # Gauge and scale anchor: the window's two oldest live poses are frozen.
    live_rank = torch.cumsum(live, dim=0, dtype=torch.int32) - 1
    pose_free = live & (live_rank >= 2)
    kf_of_obs = torch.arange(w, device=ring_kf.device)[:, None].expand(w, o_cap).reshape(-1)
    pts = positions[torch.where(l_mask, uniq, 0)].to(ring_rot.dtype)
    px = ring_px.reshape(-1, 2).to(ring_rot.dtype)
    # Padding rows are routed to a dropped scratch row, so that slot 0 is
    # written once, with its optimised value.
    write_slots = torch.where(l_mask, uniq, big)
    return (pts, kf_of_obs, pt_c, px, ok_c, pose_free, write_slots,
            *_lm_setup(ring_rot, ring_trans, pts, kf_of_obs, pt_c, px, ok_c, plan=plan))


def _fused_window_ba(state: MapState, ring_rot, ring_trans, ring_kf, ring_slots, ring_ids, ring_px, ring_mask,
                     intrinsics, config: PointCloudConfig):
    """Windowed BA over the ring's poses, in the ring's dtype. Returns (ring
    rotations, ring translations, map positions) after the solve.

    The window observes at most W*O slots; they are deduplicated (sort,
    first occurrence, sort again) into l_max compact rows and each
    observation's landmark is found by a binary search: the compact problem
    the host loop builds, without a host read. The gather-mode observer
    bound (the window size) holds by construction: a ring row's slots are
    compacted from a per-slot mask, so a landmark appears at most once per
    keyframe; the host loop's check of that is dropped here, as it would
    read the device. The problem's set-up and each LM iteration are the
    regions `ba.setup` and `ba.step` (utils/graphs.py), one key each for
    every solve of a run; the segment sums are those of _ba_window_solve.
    """
    with span("map.window_ba"):
        w, o_cap = config.ba_window, config.max_obs_per_kf
        dev = ring_rot.device
        gather = dev.type == "cuda"
        plan = _plan(intrinsics, config.ba, fix_first_pose=False, dev=dev, n_poses=w,
                     n_points=min(config.max_ba_landmarks, w * o_cap), m=w * o_cap, landmark_chunk=2048,
                     segment_method="gather" if gather else "auto", schur_method="dense", coobs_k=16,
                     gather_k_pt=w if gather else None, busiest_pose=lambda: o_cap)
        pts, kf_idx, pt_idx, px, ok, free, write_slots, *tables, err = graphs.run(
            "ba.setup", functools.partial(_window_problem, plan=plan, config=config),
            (state.positions, state.valid, state.ids, ring_rot, ring_trans, ring_kf, ring_slots, ring_ids, ring_px,
             ring_mask), static=(plan, config), eager=w * 6 > 64)
        new_rot, new_trans, new_pts, _, _ = _lm(plan, ring_rot, ring_trans, pts, err,
                                                (kf_idx, pt_idx, px, ok, free, None, *tables))
        return new_rot, new_trans, _set_rows(state.positions, write_slots, new_pts.to(state.positions.dtype))


def _carry_tensors(carry: _FusedCarry) -> tuple:
    """The carry's tensors in field order (the map state's six first),
    kf_count left out."""
    return (*carry.map_state, *carry[1:10], *carry[11:])


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy of it at storage offset 0 where it is a view
    elsewhere: a graph's key holds each input's layout (utils/graphs.py)."""
    return t if t.storage_offset() == 0 and t.is_contiguous() else t.clone(memory_format=torch.contiguous_format)


def _map_step(xy, desc, mask, rel_r, rel_t, kf_idx, *carry_tensors, intrinsics, config: PointCloudConfig):
    """The device-only part of a keyframe step: re-match against the
    previous keyframe, triangulate and insert, re-associate and log the
    observations into the ring. It reads nothing from the host that changes
    from step to step (kf_idx [1] int32 is the new keyframe's index), so one
    CUDA graph replays it for every step of a run. Returns (new_r, new_t,
    the map state's six tensors, free_head, map_bits, map_pops, the ring's
    seven tensors, slots, oids, opx, omask)."""
    carry = _FusedCarry(MapState(*carry_tensors[:6]), *carry_tensors[6:15], None, *carry_tensors[15:])
    state = carry.map_state
    dev = xy.device
    o_cap = config.max_obs_per_kf
    with span("map.match"):
        good = _match_keyframes(carry.prev_desc, carry.prev_mask, desc, mask)
        xy2 = xy[good.train_idx]
        desc2 = desc[good.train_idx]

    with span("map.triangulate"):
        # Correct world-to-camera chain in the pose dtype (the frontend's
        # f32 relative pose is promoted exactly); triangulation stays f32.
        rel_r = rel_r.to(carry.prev_rot.dtype)
        new_r = rel_r @ carry.prev_rot
        new_t = rel_r @ carry.prev_trans + rel_t.to(carry.prev_rot.dtype)
        r32, t32 = new_r.float(), new_t.float()
        xyz, tri_valid = triangulate_points(intrinsics, (carry.prev_rot.float(), carry.prev_trans.float()),
                                            (r32, t32), carry.prev_xy, xy2)
        state, free_head, slot_i = _map_insert_at(state, carry.free_slots, carry.free_head, xyz, desc2,
                                                  tri_valid & good.mask)
        ins_bits, ins_pops = descriptor_bits(desc2)
        map_bits = _set_rows(carry.map_bits, slot_i, ins_bits)
        map_pops = _set_rows(carry.map_pops, slot_i, ins_pops)

    # Re-associate the map with this keyframe: the observation count rises
    # for every match, the ring logs those within the reprojection gate.
    with span("map.reassociate"):
        state, midx, mgood = _reassociate(state, intrinsics, desc, mask, xy, (r32, t32),
                                          config.obs_max_reproj_px, map_bits, map_pops)

    with span("map.ring"):
        # The first o_cap matched slots in index order as observation rows
        # (padding rows point at slot 0, unmasked).
        obs_rank = torch.cumsum(mgood, dim=0, dtype=torch.int32) - 1
        slots = _set_rows(torch.zeros((o_cap,), dtype=torch.int32, device=dev),
                          torch.where(mgood & (obs_rank < o_cap), obs_rank, o_cap),
                          torch.arange(state.capacity, dtype=torch.int32, device=dev))
        omask = mgood[slots] & (torch.arange(o_cap, device=dev) <= obs_rank[-1])
        opx = xy[midx[slots]]
        oids = state.ids[slots]

        ring = (torch.cat([carry.ring_rot[1:], new_r[None]]), torch.cat([carry.ring_trans[1:], new_t[None]]),
                torch.cat([carry.ring_kf[1:], kf_idx]), torch.cat([carry.ring_slots[1:], slots[None]]),
                torch.cat([carry.ring_ids[1:], oids[None]]), torch.cat([carry.ring_px[1:], opx[None]]),
                torch.cat([carry.ring_mask[1:], omask[None]]))
    return (new_r, new_t, *state, free_head, map_bits, map_pops, *ring, slots, oids, opx, omask)


def _kf_step(carry: _FusedCarry, xy, desc, mask, rel_r, rel_t, intrinsics, config: PointCloudConfig):
    """One keyframe: the map step (`_map_step`, a CUDA graph on the card
    once its key recurs), then BA and prune when due. Returns (new carry,
    step outputs)."""
    with span("map.kf_step"):
        # Every input at offset 0, so that one key serves each step of each
        # chunk; the index is filled on the device, as the region reads it.
        xy, desc, mask, rel_r, rel_t = (_fresh(t) for t in (xy, desc, mask, rel_r, rel_t))
        kf_idx = carry.kf_count
        new_count = kf_idx + 1
        kf_t = torch.full((1,), kf_idx, dtype=torch.int32, device=xy.device)
        out = graphs.run("map.step", functools.partial(_map_step, intrinsics=intrinsics, config=config),
                         (xy, desc, mask, rel_r, rel_t, kf_t, *(_fresh(t) for t in _carry_tensors(carry))),
                         static=(config, intrinsics))
        new_r, new_t, state = out[0], out[1], MapState(*out[2:8])
        free_head, map_bits, map_pops = out[8:11]
        ring_rot, ring_trans, ring_kf, ring_slots, ring_ids, ring_px, ring_mask = out[11:18]
        slots, oids, opx, omask = out[18:]

        # Windowed BA every ba_interval keyframes, when the window logged an
        # observation: the step's one host read.
        ba_flag = False
        if config.ba_interval and new_count % config.ba_interval == 0:
            with span("map.ba_due.read"):
                ba_flag = bool(ring_mask.any())
        if ba_flag:
            ring_rot, ring_trans, positions = _fused_window_ba(state, ring_rot, ring_trans, ring_kf, ring_slots,
                                                               ring_ids, ring_px, ring_mask, intrinsics, config)
            state = state._replace(positions=positions)

        # Prune every prune_interval keyframes; pruning frees slots, so the
        # free table is rebuilt on the same steps only.
        free_slots = carry.free_slots
        if config.prune_interval and new_count % config.prune_interval == 0:
            with span("map.prune"):
                state = map_prune(state, config.min_observations)
                free_slots, free_head = _free_table(state)

        new_carry = _FusedCarry(
            map_state=state, free_slots=free_slots, free_head=free_head, map_bits=map_bits, map_pops=map_pops,
            prev_xy=xy, prev_desc=desc, prev_mask=mask,
            # The next keyframe chains off the ring's newest pose: BA may have
            # just moved it (the host loop chains off its BA-updated chain too).
            prev_rot=ring_rot[-1], prev_trans=ring_trans[-1], kf_count=new_count,
            ring_rot=ring_rot, ring_trans=ring_trans, ring_kf=ring_kf, ring_slots=ring_slots, ring_ids=ring_ids,
            ring_px=ring_px, ring_mask=ring_mask,
        )
        out = _FusedStepOut(kf_idx, new_r, new_t, ba_flag, ring_rot, ring_trans, ring_kf, slots, oids, opx, omask)
        return new_carry, out


def _fused_phase2_chunk(carry: _FusedCarry, feats: OrbFeatures, rel_rot, rel_trans, is_kf, intrinsics,
                        config: PointCloudConfig):
    """The keyframe loop over one chunk of C steps. is_kf [C] bool is host
    data (the frontend's keyframe flags, which include pose success).
    Returns (new carry, _FusedStepOut stacked over the steps: kf_idx and
    ba_flag as CPU tensors, the rest on the device). A step without a
    keyframe leaves the carry as it is and yields the carry's poses and
    ring with kf_idx -1 and no observation."""
    with span("map.phase2"):
        skipped_obs = None
        outs = []
        for i, kf in enumerate(np.asarray(is_kf, dtype=bool)):
            if kf:
                carry, out = _kf_step(carry, feats.xy[i], feats.descriptors[i], feats.mask[i], rel_rot[i],
                                      rel_trans[i], intrinsics, config)
            else:
                if skipped_obs is None:
                    o_cap, dev = config.max_obs_per_kf, carry.ring_kf.device
                    skipped_obs = (torch.zeros((o_cap,), dtype=torch.int32, device=dev),
                                   torch.full((o_cap,), -1, dtype=torch.int32, device=dev),
                                   torch.zeros((o_cap, 2), dtype=torch.float32, device=dev),
                                   torch.zeros((o_cap,), dtype=torch.bool, device=dev))
                out = _FusedStepOut(-1, carry.prev_rot, carry.prev_trans, False, carry.ring_rot, carry.ring_trans,
                                    carry.ring_kf, *skipped_obs)
            outs.append(out)
        stacked = {name: torch.stack(f) for name, f in zip(_FusedStepOut._fields, zip(*outs))
                   if name not in ("kf_idx", "ba_flag")}
        return carry, _FusedStepOut(kf_idx=torch.tensor([o.kf_idx for o in outs], dtype=torch.int32),
                                    ba_flag=torch.tensor([o.ba_flag for o in outs]), **stacked)


def _flagship_chunk(carry1, carry2: _FusedCarry, block, intrinsics, config: PointCloudConfig, uniforms=None,
                    seed: int = 0, first_step: int = 0, prev_frame=None):
    """The VO frontend over one chunk, then phase 2 over its keyframes.
    Reads the chunk's keyframe flags on the host once. Returns (frontend
    carry, phase-2 carry, VoChunkResult, stacked step outputs)."""
    carry1, res, feats = vo_frontend(*carry1, block, intrinsics, config.vo, uniforms=uniforms, seed=seed,
                                     first_step=first_step, prev_frame=prev_frame)
    with span("flagship.keyframes.read"):
        is_kf = res.is_keyframe.cpu().numpy()
    carry2, outs = _fused_phase2_chunk(carry2, feats, res.rotations, res.translations, is_kf, intrinsics, config)
    return carry1, carry2, res, outs


def run_point_cloud_fused(frames, intrinsics: CameraIntrinsics, config: PointCloudConfig = PointCloudConfig(),
                          chunk_size: int | None = None, seed: int = 0, resume_from: str | None = None,
                          on_compute_done=None, device=None, uniforms=None,
                          pose_dtype: torch.dtype = torch.float32) -> PointCloudResult:
    """`run_point_cloud` with phase 2 kept on the device: the same keyframe
    schedule, map updates, BA windows and pruning, on `device` ("cuda" when
    None; raises without one). Returns the same PointCloudResult.

    Differences from the host loop, as in the JAX package: observations are
    capped per keyframe (max_obs_per_kf) instead of per window, the keyframe
    chain and BA run in `pose_dtype` (the JAX package's chain dtype: f64
    under jax_enable_x64, else f32), and a window BA counts as run whenever
    the ring holds an observation, even one whose landmark was recycled
    since.

    chunk_size, seed, uniforms: as for run_point_cloud. resume_from: a
    directory written by PointCloudResult.save_checkpoint; the map,
    keyframe chain, trajectory and observation log continue from it, and
    the first BA window spans only keyframes created after the resume (the
    observation ring starts empty). on_compute_done: a 0-argument callback
    run once all device work has finished, before the result is copied to
    the host.
    """
    require_orb(config.vo, "run_point_cloud_fused")
    with span("flagship.run", root=True):
        dev = resolve_device(device)
        t_total = frames.shape[0]
        n_pairs = t_total - 1
        chunk = chunk_size or max(n_pairs, 1)

        feats0 = _first_features(frames, config, dev)
        carry2 = _fused_carry_init(config, feats0, pose_dtype)
        trajectory = Trajectory()
        init_chain = init_obs = None
        if resume_from:
            map_state, kf_rots, kf_trans, kf_frames, trajectory, init_obs = _load_resume(resume_from, config, dev)
            init_chain = (kf_rots, kf_trans, kf_frames)
            table, head = _free_table(map_state)
            bits, pops = descriptor_bits(map_state.descriptors)
            # The ring keeps its keyframe-0 entry, as in the JAX package: it holds
            # no observation and is the first window's first frozen anchor.
            carry2 = carry2._replace(
                map_state=map_state, free_slots=table, free_head=head, map_bits=bits, map_pops=pops,
                kf_count=len(kf_rots), prev_rot=torch.as_tensor(kf_rots[-1], dtype=pose_dtype, device=dev),
                prev_trans=torch.as_tensor(kf_trans[-1], dtype=pose_dtype, device=dev))
        carry1 = (feats0, KeyframeState.initial(dev), torch.as_tensor(trajectory.global_pose, dtype=pose_dtype,
                                                                      device=dev))

        step_outs, res_list = [], []
        for start in range(0, n_pairs, chunk):
            stop = min(start + chunk, n_pairs)
            with span("flagship.chunk"):
                with span("vo.upload"):
                    block = torch.as_tensor(frames[start + 1 : stop + 1]).to(dev)
                    draws = None if uniforms is None else torch.as_tensor(uniforms[start:stop]).to(dev)
                    prev_frame = torch.as_tensor(frames[start]).to(dev) if config.vo.refine_matches else None
                carry1, carry2, res, outs = _flagship_chunk(carry1, carry2, block, intrinsics, config, draws, seed,
                                                            first_step=start + 1, prev_frame=prev_frame)
            step_outs.append(outs)
            res_list.append(res)

        if on_compute_done is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            on_compute_done()
        # One fetch at the end: every output leaf, concatenated over the chunks.
        with span("flagship.read"):
            outs = rot_all = trans_all = iskf_all = None
            successful = 0
            if step_outs:  # empty for a single-frame clip (keyframe 0 only)
                outs = _FusedStepOut(*[torch.cat(parts).cpu().numpy() for parts in zip(*step_outs)])
                rot_all, trans_all, iskf_all, success = (torch.cat(parts).cpu().numpy() for parts in zip(
                    *[(r.rotations, r.translations, r.is_keyframe, r.success) for r in res_list]))
                successful = int(success.sum())
            kf_rots, kf_trans, kf_frames, obs, ba_runs = _phase2_host_reconstruct(
                outs, rot_all, trans_all, iskf_all, trajectory, config, init_chain=init_chain, init_obs=init_obs)
        return PointCloudResult(
            map_state=carry2.map_state,
            trajectory=trajectory,
            keyframe_rotations=np.stack(kf_rots),
            keyframe_translations=np.stack(kf_trans),
            keyframe_frame_idx=np.asarray(kf_frames),
            ba_runs=ba_runs,
            total_frames=t_total,
            successful_frames=successful,
            observations=(np.asarray(obs[0], np.int32), np.asarray(obs[1], np.int32),
                          np.asarray(obs[2], np.float32).reshape(-1, 2), np.asarray(obs[3], np.int32)),
        )


def _phase2_host_reconstruct(outs, rot_all, trans_all, iskf_all, trajectory, config, init_chain=None,
                             init_obs=None):
    """The keyframe chain and observation log from the fused steps' outputs
    (concatenated over all chunks, numpy). A copy of the JAX package's.

    Returns (kf_rots, kf_trans, kf_frames, (obs_kf, obs_pt, obs_px, obs_id),
    ba_runs); fills `trajectory` with the reference-style artifact.
    Applying the ring rewrites in step order after the appends keeps the
    last write of every keyframe, as the interleaved per-step loop would:
    a keyframe exists before BA can touch it.

    init_chain/init_obs: optional (kf_rots, kf_trans, kf_frames) and
    (obs_kf, obs_pt, obs_px, obs_id) from a checkpoint; the steps' global
    keyframe indices continue past the restored chain.
    """
    if init_chain is not None:
        kf_rots, kf_trans, kf_frames = (list(v) for v in init_chain)
    else:
        kf_rots = [np.eye(3)]
        kf_trans = [np.zeros(3)]
        kf_frames = [0]
    obs_kf, obs_pt, obs_px, obs_id = (list(v) for v in init_obs) if init_obs else ([], [], [], [])
    ba_runs = 0
    if outs is None:
        return kf_rots, kf_trans, kf_frames, (obs_kf, obs_pt, obs_px, obs_id), 0

    # Reference-style trajectory (frame numbering 1-based, keyframes only).
    for pair_idx in np.nonzero(iskf_all)[0]:
        frame_idx = int(pair_idx) + 1
        trajectory.update(rot_all[pair_idx], trans_all[pair_idx], frame_idx + 1, frame_idx / config.vo.fps)

    kf_steps = np.nonzero(outs.kf_idx >= 0)[0]
    kf_rots.extend(outs.new_rot[kf_steps])
    kf_trans.extend(outs.new_trans[kf_steps])
    kf_frames.extend((kf_steps + 1).tolist())
    rows, cols = np.nonzero(outs.obs_mask[kf_steps])
    obs_kf.extend(outs.kf_idx[kf_steps][rows].tolist())
    obs_pt.extend(outs.obs_slots[kf_steps][rows, cols].tolist())
    obs_px.extend(outs.obs_px[kf_steps][rows, cols])
    obs_id.extend(outs.obs_ids[kf_steps][rows, cols].tolist())
    ba_steps = np.nonzero(outs.ba_flag)[0]
    ba_runs += int(ba_steps.shape[0])
    for i in ba_steps:
        live = outs.ring_kf[i] >= 0
        for g, r, t in zip(outs.ring_kf[i][live], outs.ring_rot[i][live], outs.ring_trans[i][live]):
            kf_rots[g] = r
            kf_trans[g] = t
    return kf_rots, kf_trans, kf_frames, (obs_kf, obs_pt, obs_px, obs_id), ba_runs
