"""Whole-clip visual odometry (counterpart of slamtpu/pipeline/vo.py).

One chunk of C frames is one call of `vo_frontend`:

  detect_and_compute over the C frames (kernels K1 and K2)
  Hamming matching of the C consecutive pairs (one batched matmul)
  RANSAC 5-point pose of all C pairs as one batch
  keyframe selection (serial over the C steps)
  global pose composition (log-depth prefix product)

Reference semantics, as in the JAX package: matching is always against the
previous frame; the trajectory advances only on keyframes, with that
frame's relative pose; a failed frame leaves the keyframe state and pose
untouched; timestamps are (frame_count - 1) / fps.

`run_vo` streams a clip through fixed-size chunks with the carry (last
frame's features, keyframe state, global pose) and the same masked-seed
schedule: step 0 pairs an empty feature carry with frame 0 and is masked,
step j >= 1 is pair j-1. Chunked and whole-clip runs give the same result:
RANSAC draws are seeded per global pair index, and a short last chunk
simply has fewer steps (no padding is needed without a compiler).

`run_vo_batched` runs B sequences a chunk in one pass through the same
chunk step (`_frontend`, which `run_vo` runs with B = 1): one detector
call and one RANSAC batch for all B*C pairs, and each sequence gets what
`run_vo` gives it (see `detect_and_compute`'s `groups` and
`ops/ransac.py::_gn_step` for the two ops made batch-invariant).
With `refine_matches` each chunk also needs the frame before it.

`VoConfig(features="superpoint_lightglue")` swaps the frontend's first two
stages for the learned ones (feature/learned.py, a `LearnedFrontend` the
caller passes as `frontend`): SuperPoint over the C frames in `vo.detect`
and LightGlue over the C pairs in the `pose.match` region, 2048 slots a
frame; RANSAC, keyframes and the trajectory are unchanged (sigma is 1:
SuperPoint has no octaves). `run_vo(..., keep=pairs)` also keeps, on the
device, what each stage made for those pairs (VoRun.kept) and the matches
of every pair, for a comparison with a reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..feature.detector import OrbConfig, OrbFeatures, detect_and_compute
from ..feature.learned import LearnedFeatures, LearnedFrontend
from ..feature.learned import seed_features as learned_seed_features
from ..feature.matcher import FeatureMatcher
from ..mapping.keyframe import KeyframeConfig, KeyframeState, keyframe_step
from ..odometry.camera import CameraIntrinsics
from ..odometry.pose import estimate_relative_pose
from ..odometry.trajectory import Trajectory, compose_relative_transforms
from ..ops.hamming import descriptor_bits
from ..ops.lie import se3_matrix
from ..ops.patch_refine import refine_matches
from ..ops.ransac import PairDraws, RansacConfig, as_draws, pair_draws
from ..utils import graphs
from ..utils.graphs import device_constant
from ..utils.metrics import span

__all__ = ["VoConfig", "VoChunkResult", "VoRun", "seed_features", "vo_frontend", "vo_chunk", "vo_chunk_batched",
           "run_vo", "run_vo_batched"]


@dataclasses.dataclass(frozen=True)
class VoConfig:
    """The JAX package's VoConfig, same defaults: 500 features over 8
    levels, Nistér 5-point RANSAC at 64 hypotheses with the GN polish and
    per-octave sigma. refine_matches aligns each matched keypoint of the
    second frame to its first-frame template by SSD (ops/patch_refine.py)
    over a (2 refine_radius + 1)^2 template and +-refine_search px.
    features "superpoint_lightglue" runs the learned frontend (the
    `LearnedFrontend` passed as `frontend`, with its own settings) in place
    of ORB and Hamming matching (then `orb`, `match_ratio` and the
    refinement are not read)."""

    orb: OrbConfig = OrbConfig()
    ransac: RansacConfig = RansacConfig(iters=64, min_solver="5pt")
    keyframe: KeyframeConfig = KeyframeConfig()
    match_ratio: float = 2.0
    min_matches: int = 8
    fps: float = 30.0
    refine_matches: bool = False
    refine_radius: int = 4
    refine_search: int = 2
    features: str = "orb"  # or LEARNED

    @staticmethod
    def robust() -> "VoConfig":
        """Low-inlier preset: 256 RANSAC hypotheses instead of 64, for
        repeated texture where genuine outliers pass the ratio filter."""
        return VoConfig(ransac=RansacConfig(iters=256, min_solver="5pt"))


LEARNED = "superpoint_lightglue"


class VoChunkResult(NamedTuple):
    rotations: torch.Tensor  # [..., C, 3, 3] relative pose per pair
    translations: torch.Tensor  # [..., C, 3] (unit norm where valid)
    num_matches: torch.Tensor  # [..., C] good matches per pair
    num_inliers: torch.Tensor  # [..., C] RANSAC inliers
    success: torch.Tensor  # [..., C] bool — pose recovered
    is_keyframe: torch.Tensor  # [..., C] bool
    global_poses: torch.Tensor  # [..., C, 4, 4] pose AFTER each pair


def seed_features(orb: OrbConfig, device=None) -> OrbFeatures:
    """All-masked OrbFeatures: the carry seed for a run's first chunk."""
    k = orb.max_features
    zeros = torch.zeros((k,), dtype=torch.float32, device=device)
    return OrbFeatures(
        xy=torch.zeros((k, 2), dtype=torch.float32, device=device),
        response=zeros,
        angle=zeros.clone(),
        octave=torch.zeros((k,), dtype=torch.int32, device=device),
        size=zeros.clone(),
        descriptors=torch.zeros((k, 32), dtype=torch.uint8, device=device),
        mask=torch.zeros((k,), dtype=torch.bool, device=device),
    )


def _slots(config: VoConfig, frontend) -> int:
    """Keypoint slots a frame, the correspondences a pair."""
    return frontend.config.max_keypoints if config.features == LEARNED else config.orb.max_features


def _check_frontend(config: VoConfig, frontend) -> None:
    if config.features == LEARNED:
        if not isinstance(frontend, LearnedFrontend):
            raise ValueError('features="superpoint_lightglue" needs frontend=LearnedFrontend(...) (its weights)')
        if config.refine_matches:
            raise ValueError("refine_matches runs on ORB matches only")
    elif config.features != "orb":
        raise ValueError(f"unknown features {config.features!r}: 'orb' or {LEARNED!r}")


def require_orb(config: VoConfig, who: str) -> None:
    """Raise unless `config` runs the ORB frontend (the mapping pipelines
    read ORB's binary descriptors and octaves)."""
    if config.features != "orb":
        raise ValueError(f"{who} runs the ORB frontend only; features={config.features!r} is for run_vo, "
                         "vo_chunk and run_vo_batched")


def _seed_carry(config: VoConfig, frontend, device):
    if config.features == LEARNED:
        return learned_seed_features(frontend.config, frontend.compute_dtype, device)
    return seed_features(config.orb, device)


def _step_pairs(first_step: int, c: int):
    """The pair each of c steps draws from: step j is pair j - 1, and the
    masked seed step 0 reuses pair 0's draws."""
    return [max(first_step + j - 1, 0) for j in range(c)]


def _index_draws(draws: PairDraws, idx) -> PairDraws:
    return PairDraws(*[None if d is None else torch.as_tensor(d[idx]) for d in draws])


def _detect(frames, config: VoConfig, frontend=None, keeper=None):
    """Features of frames [B, C, H, W] as [B, C, K, ...]: one detector call
    over all B*C frames (ORB: one launch of each kernel, each sequence's
    pyramid built alone; learned: one SuperPoint batch)."""
    b, c = frames.shape[:2]
    flat = frames.reshape(b * c, *frames.shape[2:])
    with span("vo.detect"):
        if config.features == LEARNED:
            feats, logits, descriptor_map = frontend.detect(flat)
            if keeper is not None:
                keeper.frames(feats, logits, descriptor_map)
            return LearnedFeatures(*[x.reshape(b, c, *x.shape[1:]) for x in feats])
        feats = detect_and_compute(flat, config.orb, groups=b)
        return OrbFeatures(*[x.reshape(b, c, *x.shape[1:]) for x in feats])


def _pair_rows(x, first: bool):
    """[B, C+1, ...] -> the pairs' first (or second) frames as [B*C, ...]."""
    x = x[:, :-1] if first else x[:, 1:]
    return x.reshape(-1, *x.shape[2:])


def _match(descriptors, mask, xy, octave, imgs, config: VoConfig):
    """The `pose.match` region over the frames [B, C+1, ...] of C pairs:
    (points1, points2 [B*C, K, 2], good [B*C, K], sigma [B*C, K],
    num_good, enough [B*C])."""
    pairs = _pair_rows

    # Unpack descriptor bits once per frame (each frame is in two pairs).
    bits, pops = descriptor_bits(descriptors)
    matcher = FeatureMatcher()
    good = matcher.filter_good_matches(
        matcher.match_from_bits(pairs(bits, True), pairs(pops, True), pairs(mask, True),
                                pairs(bits, False), pairs(pops, False), pairs(mask, False)),
        config.match_ratio,
    )
    pts1 = pairs(xy, True)
    pts2 = torch.gather(pairs(xy, False), 1, good.train_idx[..., None].expand(-1, -1, 2))
    num_good = torch.sum(good.mask, dim=-1, dtype=torch.int32)
    enough = num_good >= config.min_matches

    if imgs is not None:
        pts2 = refine_matches(pairs(imgs, True), pairs(imgs, False), pts1, pts2, good.mask,
                              radius=config.refine_radius, search=config.refine_search)

    if octave is not None:
        oct1 = pairs(octave, True)
        oct2 = torch.gather(pairs(octave, False), 1, good.train_idx)
        base = device_constant(config.orb.scale_factor, pts1.dtype, pts1.device)
        sigma = torch.pow(base, torch.maximum(oct1, oct2).to(pts1.dtype))
    else:
        sigma = torch.ones_like(pts1[..., 0])
    return pts1, pts2, good.mask, sigma, num_good, enough


def _match_learned(xy, descriptors, mask, keep, config: VoConfig, frontend: LearnedFrontend, size: tuple):
    """The `pose.match` region of the learned frontend: LightGlue over the C
    pairs of frames [B, C+1, ...] as _match's outputs (sigma 1), then the
    matches [B*C, K] and, where `keep` (pair rows [n]) is given, those
    pairs' log-assignments [n, K+1, K+1]."""
    first, second = (tuple(_pair_rows(x, f) for x in (xy, descriptors, mask)) for f in (True, False))
    scores, matches0, _ = frontend.match(*first, *second, size)
    good = matches0 >= 0
    pts1 = first[0]
    pts2 = torch.gather(second[0], 1, matches0.clamp(min=0)[..., None].expand(-1, -1, 2))
    num_good = torch.sum(good, dim=-1, dtype=torch.int32)
    kept = None if keep is None else scores[keep]
    return pts1, pts2, good, torch.ones_like(pts1[..., 0]), num_good, num_good >= config.min_matches, matches0, kept


def _pair_poses(prev_feats, feats_new, frames, intrinsics: CameraIntrinsics, config: VoConfig, step_mask,
                draws: PairDraws, prev_frame, frontend=None, keeper=None):
    """The pose part of the chunk step: each frame of feats_new [B, C, ...]
    against the one before it (prev_feats [B, ...] before the first),
    matching, sub-pixel refinement, per-octave sigma and RANSAC of all B*C
    pairs as one batch (learned features: LightGlue, then RANSAC). Returns
    (rotation [B, C, 3, 3], translation [B, C, 3], num_good, num_inliers,
    success, all [B, C]). On the card each region
    replays a CUDA graph once its shapes recur (utils/graphs.py); the
    masked seed step and `enough` are applied outside, so the first chunk
    shares the graphs of the others."""
    device = frames.device
    b, c = frames.shape[:2]

    with span("vo.pose"):
        with span("pose.match"):
            cat = lambda p, f: torch.cat([p[:, None], f], dim=1)  # noqa: E731
            if config.features == LEARNED:
                out = graphs.run(
                    "pose.match", functools.partial(_match_learned, config=config, frontend=frontend,
                                                    size=(frames.shape[-1], frames.shape[-2])),
                    (cat(prev_feats.xy, feats_new.xy), cat(prev_feats.descriptors, feats_new.descriptors),
                     cat(prev_feats.mask, feats_new.mask), None if keeper is None else keeper.rows(device)),
                    static=(config, frontend))
                pts1, pts2, good, sigma, num_good, enough = out[:6]
                if keeper is not None:
                    keeper.pairs(pts1, pts2, good, *out[6:])
            else:
                imgs = None
                if config.refine_matches and prev_frame is not None:
                    imgs = cat(torch.as_tensor(prev_frame, device=device), frames)
                pts1, pts2, good, sigma, num_good, enough = graphs.run(
                    "pose.match", functools.partial(_match, config=config),
                    (cat(prev_feats.descriptors, feats_new.descriptors), cat(prev_feats.mask, feats_new.mask),
                     cat(prev_feats.xy, feats_new.xy),
                     cat(prev_feats.octave, feats_new.octave) if config.ransac.octave_sigma else None, imgs),
                    static=config)

        flat_draws = PairDraws(*[None if d is None else d.reshape(b * c, *d.shape[2:]) for d in draws])
        poses = estimate_relative_pose(intrinsics, pts1, pts2, mask=good, config=config.ransac,
                                       sigma=sigma, uniforms=flat_draws)
        success = (poses.valid & enough).reshape(b, c)
        if step_mask is not None:
            success = success & torch.as_tensor(step_mask, dtype=torch.bool, device=device)
        return (poses.rotation.reshape(b, c, 3, 3), poses.translation.reshape(b, c, 3), num_good.reshape(b, c),
                poses.num_inliers.reshape(b, c), success)


def _keyframe_scan(config: KeyframeConfig, kf_state: KeyframeState, rotation, translation, num_good, success):
    """Keyframe selection, serial over the C steps of [B, C] inputs, all
    sequences at once; failed frames leave their state untouched. Returns
    (state after the last step, is_keyframe [B, C])."""
    state = kf_state
    is_kf = []
    with span("vo.keyframe_scan"):
        for i in range(success.shape[1]):
            stepped, kf = keyframe_step(config, state, rotation[:, i], translation[:, i], num_good[:, i])
            ok = success[:, i]
            state = KeyframeState(*[torch.where(ok, a, s) for a, s in zip(stepped, state)])
            is_kf.append(kf & ok)
        return state, torch.stack(is_kf, dim=1)


def _keyframe_transforms(rotation, translation, is_kf, dtype):
    """The relative 4x4 transforms [..., 4, 4] in `dtype`, identity where a
    step is no keyframe (the trajectory advances on keyframes only)."""
    rel = se3_matrix(rotation, translation).to(dtype)
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device)
    return torch.where(is_kf[..., None, None], rel, eye)


def _frontend(prev_feats, kf_state: KeyframeState, global_pose, frames, intrinsics: CameraIntrinsics,
              config: VoConfig, step_mask, draws: PairDraws, prev_frame, frontend=None, keeper=None):
    """The chunk step over B sequences at once: frames [B, C, H, W], carry
    fields with a leading [B], draws [B, C, ...]. The detector sees all B*C
    frames in one call (one launch of each kernel), matching and RANSAC all
    B*C pairs as one batch; the keyframe scan steps the B states together."""
    feats_new = _detect(frames, config, frontend, keeper)
    rotation, translation, num_good, num_inliers, success = _pair_poses(
        prev_feats, feats_new, frames, intrinsics, config, step_mask, draws, prev_frame, frontend, keeper)
    state, is_kf = _keyframe_scan(config.keyframe, kf_state, rotation, translation, num_good, success)

    # Trajectory: one prefix product per sequence from the carried pose.
    with span("vo.trajectory"):
        rel = _keyframe_transforms(rotation, translation, is_kf, global_pose.dtype)
        globals_ = compose_relative_transforms(torch.cat([global_pose[:, None], rel], dim=1))[:, 1:]

    new_prev = type(feats_new)(*[x[:, -1] for x in feats_new])
    result = VoChunkResult(rotation, translation, num_good, num_inliers, success, is_kf, globals_)
    return (new_prev, state, globals_[:, -1]), result, feats_new


def vo_frontend(prev_feats, kf_state: KeyframeState, global_pose, frames,
                intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(), step_mask=None,
                uniforms=None, seed: int = 0, first_step: int = 0, prev_frame=None, frontend=None, keeper=None):
    """vo_chunk plus the per-frame features.

    frames [C, H, W] (uint8 or float) on the carry's device. step_mask:
    optional [C] bool, False marks steps treated as failed frames (the
    masked seed step). uniforms: optional RANSAC draws for the C steps,
    the essential stream [C, iters, K] or a `PairDraws`; a stream the
    config reads and `uniforms` lacks comes from the generator of pair
    max(first_step + j - 1, 0) under `seed` (step j of the chunk).
    prev_frame: [H, W] pixels of the frame before frames[0], which
    refine_matches needs (without it no match is refined). frontend: the
    `LearnedFrontend` of features "superpoint_lightglue" (the carry is then
    `LearnedFeatures`).

    Returns ((new_prev_feats, new_kf_state, new_global_pose),
    VoChunkResult, feats_new [C]).
    """
    _check_frontend(config, frontend)
    device = global_pose.device
    frames = torch.as_tensor(frames, device=device)
    c, k = frames.shape[0], _slots(config, frontend)
    with span("vo.draws"):
        draws = pair_draws(seed, _step_pairs(first_step, c), config.ransac, k, device, given=as_draws(uniforms))
    carry, result, feats_new = _frontend(
        type(prev_feats)(*[x[None] for x in prev_feats]), KeyframeState(*[x[None] for x in kf_state]),
        global_pose[None], frames[None], intrinsics, config, step_mask,
        PairDraws(*[None if d is None else d[None] for d in draws]),
        None if prev_frame is None else torch.as_tensor(prev_frame, device=device)[None], frontend, keeper)
    unbatch = lambda tree: type(tree)(*[x[0] for x in tree])  # noqa: E731
    new_prev, state, pose = carry
    return (unbatch(new_prev), unbatch(state), pose[0]), unbatch(result), unbatch(feats_new)


def vo_chunk(prev_feats, kf_state: KeyframeState, global_pose, frames,
             intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(), step_mask=None,
             uniforms=None, seed: int = 0, first_step: int = 0, prev_frame=None, frontend=None, keeper=None):
    """Process C new frames against the carried previous frame.
    Returns ((new_prev_feats, new_kf_state, new_global_pose), VoChunkResult)."""
    with span("vo.chunk"):
        carry, result, _ = vo_frontend(prev_feats, kf_state, global_pose, frames, intrinsics, config,
                                       step_mask, uniforms, seed, first_step, prev_frame, frontend, keeper)
    return carry, result


def vo_chunk_batched(prev_feats, kf_states: KeyframeState, global_poses, frames,
                     intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(), step_mask=None,
                     uniforms=None, seeds=None, first_step: int = 0, prev_frames=None, frontend=None):
    """vo_chunk over B independent sequences in one pass: frames
    [B, C, H, W], carries with a leading [B], step_mask [C] shared by all.
    The detector runs once over all B*C frames (one launch of each
    kernel) and RANSAC over all B*C pairs. uniforms: optional [B, C, ...]
    draws (a tensor for the essential stream or a `PairDraws`); missing
    streams of sequence b come from seeds[b] (default b).
    Returns ((new_prev_feats, new_kf_states, new_global_poses),
    VoChunkResult with a leading [B])."""
    _check_frontend(config, frontend)
    device = global_poses.device
    with span("vo.chunk"):
        frames = torch.as_tensor(frames, device=device)
        b, c = frames.shape[:2]
        seeds = list(range(b)) if seeds is None else list(seeds)
        given = as_draws(uniforms)
        with span("vo.draws"):
            per_seq = [pair_draws(seeds[i], _step_pairs(first_step, c), config.ransac, _slots(config, frontend),
                                  device, given=_index_draws(given, i)) for i in range(b)]
            draws = PairDraws(*[None if parts[0] is None else torch.stack(parts) for parts in zip(*per_seq)])
        prev_frames = None if prev_frames is None else torch.as_tensor(prev_frames, device=device)
        carry, result, _ = _frontend(prev_feats, kf_states, global_poses, frames, intrinsics, config, step_mask,
                                     draws, prev_frames, frontend)
    return carry, result


@dataclasses.dataclass
class VoRun:
    """Host-side results of a full run: the summary counts plus the raw
    per-pair arrays."""

    trajectory: Trajectory
    total_frames: int
    successful_frames: int
    failed_frames: int
    keyframe_count: int
    num_matches: np.ndarray  # [T-1]
    num_inliers: np.ndarray  # [T-1]
    success: np.ndarray  # [T-1]
    is_keyframe: np.ndarray  # [T-1]
    rotations: np.ndarray  # [T-1, 3, 3] per-pair relative rotations
    translations: np.ndarray  # [T-1, 3] per-pair unit translations
    kept: Optional[dict] = None  # device tensors of run_vo(keep=...) (see _Keeper)

    @property
    def keyframe_ratio(self) -> float:
        return self.keyframe_count / max(self.total_frames, 1)


class _Keeper:
    """What run_vo(keep=pairs) keeps on the device, for a comparison of the
    learned frontend's stages with a reference: `frames` {frame: its
    SuperPoint logits [65, h, w], coarse descriptor map [D, h, w] before
    its normalisation and features (xy, descriptors, scores, mask)} for both frames of
    each kept pair; `assign` {pair: its log-assignment [K+1, K+1] and
    matches0 [K]}; and `pose_inputs`, each chunk's correspondences as the
    pose stage took them: (first step, points1 [C, K, 2], points2, good
    [C, K]), step j of a chunk being pair first + j - 1 (the first chunk's
    step 0 is the masked seed step). Pair p joins frames p and p + 1. Only
    copies of small slices are made."""

    def __init__(self, pairs, n_pairs: int):
        self.keep = sorted({int(p) for p in pairs})
        if not all(0 <= p < n_pairs for p in self.keep):
            raise ValueError(f"keep: pairs {self.keep} outside [0, {n_pairs})")
        self.kept = {"pairs": self.keep, "frames": {}, "assign": {}}
        self.points = []
        self.start = self.steps = 0

    def chunk(self, start: int, steps: int) -> None:
        self.start, self.steps = start, steps

    def _step(self, p: int):
        """The chunk's step of pair p (step j pairs frames j - 1 and j), or None."""
        j = p - self.start + 1
        return j if 0 <= j < self.steps else None

    def rows(self, device):
        """The kept pairs' steps in this chunk (0 for a pair outside it), or
        None where the chunk holds none of them: its region gathers nothing."""
        steps = [self._step(p) for p in self.keep]
        if all(j is None for j in steps):
            return None
        return device_constant(tuple(j or 0 for j in steps), torch.int64, device)

    def frames(self, feats: LearnedFeatures, logits, descriptor_map) -> None:
        for f in {f for p in self.keep for f in (p, p + 1)}:
            j = f - self.start
            if 0 <= j < self.steps:
                self.kept["frames"][f] = dict(logits=logits[j].clone(), descriptor_map=descriptor_map[j].clone(),
                                              **{k: v[j].clone() for k, v in feats._asdict().items()})

    def pairs(self, pts1, pts2, good, matches0, log_assignment) -> None:
        self.points.append((self.start, pts1, pts2, good))
        for n, p in enumerate(self.keep):
            j = self._step(p)
            if j is not None:
                self.kept["assign"][p] = dict(log_assignment=log_assignment[n].clone(), matches0=matches0[j].clone())

    def result(self) -> dict:
        return {**self.kept, "pose_inputs": self.points}


def _vo_run(merged: VoChunkResult, t_total: int, fps: float) -> VoRun:
    """The host-side VoRun of one sequence's per-pair numpy arrays."""
    trajectory = Trajectory()
    for idx in np.nonzero(merged.is_keyframe)[0]:
        frame_count = idx + 2  # pair idx connects frame idx -> idx+1 (1-based count)
        trajectory.update(merged.rotations[idx], merged.translations[idx], frame_count, (frame_count - 1) / fps)
    success = merged.success
    return VoRun(
        trajectory=trajectory,
        total_frames=t_total,
        successful_frames=int(success.sum()),
        failed_frames=int((~success).sum()),
        keyframe_count=int(merged.is_keyframe.sum()),
        num_matches=merged.num_matches,
        num_inliers=merged.num_inliers,
        success=success,
        is_keyframe=merged.is_keyframe,
        rotations=merged.rotations,
        translations=merged.translations,
    )


def _empty_run(t_total: int) -> VoRun:
    return VoRun(Trajectory(), t_total, 0, 0, 0, *(np.zeros((0,)),) * 4, np.zeros((0, 3, 3)), np.zeros((0, 3)))


def run_vo(frames, intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(),
           chunk_size: int | None = None, seed: int = 0, device=None, uniforms=None,
           pose_dtype: torch.dtype = torch.float32, frontend=None, keep=()) -> VoRun:
    """Run the VO pipeline over a clip [T, H, W] (uint8/float, numpy or
    tensor) on `device` ("cuda" when None; raises without one).

    chunk_size None = the whole clip in one chunk; otherwise frames stream
    through chunks of that many steps. Identical results either way.
    RANSAC draws come from `seed`, one generator per global pair index and
    stream (ops/ransac.py::pair_draws, the same numbers on every device),
    or from `uniforms` [T-1, ...]: the essential stream [T-1, iters, K] or
    a `PairDraws` (streams it lacks come from `seed`). pose_dtype: the
    dtype of the device pose chain (`VoChunkResult.global_poses`), f32 as
    in the JAX package without x64; the trajectory is composed on the host
    in f64 either way. frontend: the `LearnedFrontend` of features
    "superpoint_lightglue". keep: pair indices whose stages the learned
    frontend keeps on the device in `VoRun.kept` (see `_Keeper`).
    """
    _check_frontend(config, frontend)
    dev = resolve_device(device)
    t_total = frames.shape[0]
    if keep and config.features != LEARNED:
        raise ValueError("keep is read from the learned frontend only")
    if t_total < 2:
        return _empty_run(t_total)
    keeper = _Keeper(keep, t_total - 1) if keep else None
    chunk = chunk_size or t_total
    with span("vo.run", root=True):
        carry = (_seed_carry(config, frontend, dev), KeyframeState.initial(dev),
                 torch.eye(4, dtype=pose_dtype, device=dev))
        given = as_draws(uniforms)
        results = []
        for start in range(0, t_total, chunk):
            stop = min(start + chunk, t_total)
            with span("vo.upload"):
                block = torch.as_tensor(frames[start:stop]).to(dev)  # uint8 crosses the bus
                step_mask = torch.arange(start, stop, device=dev) >= 1
                prev_frame = torch.as_tensor(frames[max(start - 1, 0)]).to(dev) if config.refine_matches else None
            if keeper is not None:
                keeper.chunk(start, stop - start)
            carry, res = vo_chunk(*carry, block, intrinsics, config, step_mask,
                                  uniforms=_index_draws(given, _step_pairs(start, stop - start)), seed=seed,
                                  first_step=start, prev_frame=prev_frame, frontend=frontend, keeper=keeper)
            results.append(res)
        # One device->host copy per field; drop the masked seed step so row
        # i is pair i.
        with span("vo.read"):
            merged = VoChunkResult(*[torch.cat(parts, dim=0)[1:].cpu().numpy() for parts in zip(*results)])
            run = _vo_run(merged, t_total, config.fps)
        if keeper is not None:
            run.kept = keeper.result()
        return run


def run_vo_batched(frames, intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(),
                   chunk_size: int | None = None, seed: int = 0, device=None, uniforms=None,
                   pose_dtype: torch.dtype = torch.float32, frontend=None) -> list:
    """run_vo over B sequences [B, T, H, W] in one pass per chunk: a list of
    B VoRuns, sequence b drawing from `seed + b` (so each equals run_vo of
    that sequence at seed + b) or from `uniforms` [B, T-1, ...]. Each
    chunk runs the detector once over all B sequences' frames."""
    _check_frontend(config, frontend)
    dev = resolve_device(device)
    b, t_total = frames.shape[:2]
    if t_total < 2:
        return [_empty_run(t_total) for _ in range(b)]
    chunk = chunk_size or t_total
    with span("vo.run_batched", root=True):
        seed_carry = _seed_carry(config, frontend, dev)
        carry = (type(seed_carry)(*[x.expand(b, *x.shape).clone() for x in seed_carry]),
                 KeyframeState(*[x.expand(b).clone() for x in KeyframeState.initial(dev)]),
                 torch.eye(4, dtype=pose_dtype, device=dev).expand(b, 4, 4).clone())
        given = as_draws(uniforms)
        seeds = [seed + i for i in range(b)]
        results = []
        for start in range(0, t_total, chunk):
            stop = min(start + chunk, t_total)
            with span("vo.upload"):
                block = torch.as_tensor(frames[:, start:stop]).to(dev)
                step_mask = torch.arange(start, stop, device=dev) >= 1
                prev_frames = (torch.as_tensor(frames[:, max(start - 1, 0)]).to(dev) if config.refine_matches
                               else None)
                steps = _step_pairs(start, stop - start)
                draws = PairDraws(*[None if d is None else torch.as_tensor(d)[:, steps] for d in given])
            carry, res = vo_chunk_batched(*carry, block, intrinsics, config, step_mask, uniforms=draws,
                                          seeds=seeds, first_step=start, prev_frames=prev_frames, frontend=frontend)
            results.append(res)
        with span("vo.read"):
            merged = VoChunkResult(*[torch.cat(parts, dim=1)[:, 1:].cpu().numpy() for parts in zip(*results)])
            return [_vo_run(VoChunkResult(*[x[i] for x in merged]), t_total, config.fps) for i in range(b)]
