"""Flagship pipeline: VO + keyframe triangulation + global map + windowed
bundle adjustment + PLY/JSON export (counterpart of the host-loop
`run_point_cloud` and `run_global_ba` of slamtpu/pipeline/point_cloud.py).

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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..feature.detector import OrbFeatures, detect_and_compute
from ..feature.matcher import FeatureMatcher
from ..mapping.bundle_adjustment import BaConfig, ObservationBatch, ba_solve, compute_total_error
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
from .vo import VoConfig, vo_frontend

__all__ = ["PointCloudConfig", "PointCloudResult", "run_point_cloud", "run_global_ba"]


@dataclasses.dataclass(frozen=True)
class PointCloudConfig:
    """The JAX package's PointCloudConfig, same defaults. (Its
    max_obs_per_kf sizes the fused pipeline, which is not ported yet.)"""

    vo: VoConfig = VoConfig(keyframe=KeyframeConfig(min_translation=0.03, min_rotation=0.03,
                                                    min_match_ratio=0.7, max_frames=3))
    ba_interval: int = 5
    ba_window: int = 5
    prune_interval: int = 10
    map_capacity: int = 16384
    max_ba_observations: int = 4096
    max_ba_landmarks: int = 2048  # distinct landmarks per BA window
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
        raise NotImplementedError("pipeline checkpoints come with io/checkpoint.py, not ported yet")


def _match_keyframes(prev: OrbFeatures, cur: OrbFeatures):
    """Previous keyframe vs current frame, with the reference's ratio filter."""
    matcher = FeatureMatcher()
    return matcher.filter_good_matches(
        matcher.match_descriptors(prev.descriptors, cur.descriptors, prev.mask, cur.mask), 2.0)


def _triangulate_and_insert(state: MapState, intrinsics, pose1, pose2, xy1, xy2, desc2, good_mask):
    xyz, valid = triangulate_points(intrinsics, pose1, pose2, xy1, xy2)
    return map_insert(state, xyz, desc2, valid & good_mask)


def _reassociate(state: MapState, intrinsics, feats: OrbFeatures, pose, max_reproj_px: float):
    """Match the map against one keyframe's features. Returns the new state
    (observation counts raised), the matched keypoint per slot and the
    slots whose match passes the reprojection gate (these are logged)."""
    idx, good, dist = map_find_matches(state, intrinsics, feats.descriptors, feats.mask, pose[0], pose[1],
                                       frame_xy=feats.xy)
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
                    rerun_logger=None, device=None, uniforms=None) -> PointCloudResult:
    """Run the flagship over a clip [T, H, W] (uint8/float, numpy or tensor)
    on `device` ("cuda" when None; raises without one).

    chunk_size: frame pairs per frontend call (None = all). RANSAC draws
    come from `seed`, one generator per global pair index
    (ops/ransac.py::pair_uniforms), or from `uniforms` [T-1, iters, K].
    resume_from and rerun_logger are not ported yet and raise.
    """
    if resume_from is not None:
        raise NotImplementedError("resume_from comes with io/checkpoint.py, not ported yet")
    if rerun_logger is not None:
        raise NotImplementedError("rerun_logger comes with utils/metrics.py, not ported yet")
    dev = resolve_device(device)
    t_total = frames.shape[0]
    n_pairs = t_total - 1
    chunk = chunk_size or max(n_pairs, 1)

    feats0 = detect_and_compute(torch.as_tensor(frames[:1]).to(dev), config.vo.orb)
    feats0 = OrbFeatures(*[x[0] for x in feats0])
    carry = (feats0, KeyframeState.initial(dev), torch.eye(4, dtype=torch.float64, device=dev))
    map_state = MapState.empty(config.map_capacity, torch.float32, dev)
    trajectory = Trajectory()
    kf_rots = [np.eye(3)]
    kf_trans = [np.zeros(3)]
    kf_frames = [0]
    prev_feats = feats0
    # Observation log, one entry per keyframe >= 1: (slots, pixels, ids).
    # Slots are recycled by prune and insert, so BA keeps an observation
    # only while its slot still holds the landmark id logged with it.
    log = []
    n_logged = 0
    ba_runs = 0
    successful = 0

    for start in range(0, n_pairs, chunk):
        stop = min(start + chunk, n_pairs)
        block = torch.as_tensor(frames[start + 1 : stop + 1]).to(dev)
        draws = None if uniforms is None else torch.as_tensor(uniforms[start:stop]).to(dev)
        carry, res, feats_new = vo_frontend(*carry, block, intrinsics, config.vo, uniforms=draws, seed=seed,
                                            first_step=start + 1)
        success, is_kf, rotations, translations = (
            x.cpu().numpy() for x in (res.success, res.is_keyframe, res.rotations, res.translations))
        successful += int(success.sum())

        for local_idx in np.nonzero(is_kf)[0]:
            frame_idx = start + int(local_idx) + 1
            rel_r, rel_t = rotations[local_idx], translations[local_idx]
            trajectory.update(rel_r, rel_t, frame_idx + 1, frame_idx / config.vo.fps)
            new_r = rel_r @ kf_rots[-1]
            new_t = rel_r @ kf_trans[-1] + rel_t
            cur_feats = OrbFeatures(*[x[local_idx] for x in feats_new])

            good = _match_keyframes(prev_feats, cur_feats)
            pose_prev = (_f32(kf_rots[-1], dev), _f32(kf_trans[-1], dev))
            pose_cur = (_f32(new_r, dev), _f32(new_t, dev))
            map_state = _triangulate_and_insert(
                map_state, intrinsics, pose_prev, pose_cur, prev_feats.xy, cur_feats.xy[good.train_idx],
                cur_feats.descriptors[good.train_idx], good.mask)
            kf_rots.append(np.asarray(new_r))
            kf_trans.append(np.asarray(new_t))
            kf_frames.append(frame_idx)
            prev_feats = cur_feats

            map_state, idx, good = _reassociate(map_state, intrinsics, cur_feats, pose_cur, config.obs_max_reproj_px)
            log.append(_log_observations(map_state, cur_feats, idx, good))
            n_logged += len(log[-1][0])

            n_kf = len(kf_rots)
            if config.ba_interval and n_kf % config.ba_interval == 0 and n_logged:
                map_state, kf_rots, kf_trans, did_run = _run_window_ba(map_state, intrinsics, kf_rots, kf_trans,
                                                                       log, config)
                ba_runs += int(did_run)  # a window with no surviving observation runs no solve
            if config.prune_interval and n_kf % config.prune_interval == 0:
                map_state = map_prune(map_state, config.min_observations)

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


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


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
