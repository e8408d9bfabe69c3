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
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..feature.detector import OrbConfig, OrbFeatures, detect_and_compute
from ..feature.matcher import FeatureMatcher
from ..mapping.keyframe import KeyframeConfig, KeyframeState, keyframe_step
from ..odometry.camera import CameraIntrinsics
from ..odometry.pose import estimate_relative_pose
from ..odometry.trajectory import Trajectory, compose_relative_transforms
from ..ops.hamming import descriptor_bits
from ..ops.lie import se3_matrix
from ..ops.ransac import RansacConfig, pair_uniforms

__all__ = ["VoConfig", "VoChunkResult", "VoRun", "seed_features", "vo_frontend", "vo_chunk", "run_vo"]


@dataclasses.dataclass(frozen=True)
class VoConfig:
    """The JAX package's VoConfig, same defaults: 500 features over 8
    levels, Nistér 5-point RANSAC at 64 hypotheses with the GN polish and
    per-octave sigma. refine_matches=True is not ported yet (raises)."""

    orb: OrbConfig = OrbConfig()
    ransac: RansacConfig = RansacConfig(iters=64, min_solver="5pt")
    keyframe: KeyframeConfig = KeyframeConfig()
    match_ratio: float = 2.0
    min_matches: int = 8
    fps: float = 30.0
    refine_matches: bool = False


class VoChunkResult(NamedTuple):
    rotations: torch.Tensor  # [C, 3, 3] relative pose per pair
    translations: torch.Tensor  # [C, 3] (unit norm where valid)
    num_matches: torch.Tensor  # [C] good matches per pair
    num_inliers: torch.Tensor  # [C] RANSAC inliers
    success: torch.Tensor  # [C] bool — pose recovered
    is_keyframe: torch.Tensor  # [C] bool
    global_poses: torch.Tensor  # [C, 4, 4] pose AFTER each pair


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


def vo_frontend(prev_feats: OrbFeatures, kf_state: KeyframeState, global_pose, frames,
                intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(), step_mask=None,
                uniforms=None, seed: int = 0, first_step: int = 0):
    """vo_chunk plus the per-frame features.

    frames [C, H, W] (uint8 or float) on the carry's device. step_mask:
    optional [C] bool, False marks steps treated as failed frames (the
    masked seed step). uniforms: optional [C, iters, K] RANSAC draws;
    otherwise step j of the chunk (global step first_step + j) draws from
    the generator of pair max(first_step + j - 1, 0) under `seed`.

    Returns ((new_prev_feats, new_kf_state, new_global_pose),
    VoChunkResult, feats_new [C]).
    """
    if config.refine_matches:
        raise NotImplementedError("refine_matches is not ported yet")
    device = global_pose.device
    frames = torch.as_tensor(frames, device=device)
    c = frames.shape[0]
    feats_new = detect_and_compute(frames, config.orb)
    feats_all = OrbFeatures(*[torch.cat([p[None], f], dim=0) for p, f in zip(prev_feats, feats_new)])

    # Unpack descriptor bits once per frame (each frame is in two pairs).
    bits, pops = descriptor_bits(feats_all.descriptors)
    matcher = FeatureMatcher()
    good = matcher.filter_good_matches(
        matcher.match_from_bits(bits[:-1], pops[:-1], feats_all.mask[:-1],
                                bits[1:], pops[1:], feats_all.mask[1:]),
        config.match_ratio,
    )
    pts1 = feats_all.xy[:-1]
    pts2 = torch.gather(feats_all.xy[1:], 1, good.train_idx[..., None].expand(-1, -1, 2))
    num_good = torch.sum(good.mask, dim=-1, dtype=torch.int32)
    enough = num_good >= config.min_matches

    if config.ransac.octave_sigma:
        oct1 = feats_all.octave[:-1]
        oct2 = torch.gather(feats_all.octave[1:], 1, good.train_idx)
        base = torch.tensor(config.orb.scale_factor, dtype=pts1.dtype, device=device)
        sigma = torch.pow(base, torch.maximum(oct1, oct2).to(pts1.dtype))
    else:
        sigma = torch.ones_like(pts1[..., 0])

    if uniforms is None:
        pair_ids = [max(first_step + j - 1, 0) for j in range(c)]
        uniforms = pair_uniforms(seed, pair_ids, config.ransac.iters, pts1.shape[1], device)
    poses = estimate_relative_pose(intrinsics, pts1, pts2, mask=good.mask, config=config.ransac,
                                   sigma=sigma, uniforms=uniforms)
    success = poses.valid & enough
    if step_mask is not None:
        success = success & torch.as_tensor(step_mask, dtype=torch.bool, device=device)

    # Keyframe selection: serial over the steps; failed frames leave the
    # state untouched.
    state = kf_state
    is_kf = []
    for i in range(c):
        stepped, kf = keyframe_step(config.keyframe, state, poses.rotation[i], poses.translation[i],
                                    num_good[i])
        ok = success[i]
        state = KeyframeState(*[torch.where(ok, a, b) for a, b in zip(stepped, state)])
        is_kf.append(kf & ok)
    is_kf = torch.stack(is_kf)

    # Trajectory: identity for non-keyframes, then one prefix product.
    rel = se3_matrix(poses.rotation, poses.translation).to(global_pose.dtype)
    eye = torch.eye(4, dtype=rel.dtype, device=device)
    rel = torch.where(is_kf[:, None, None], rel, eye)
    globals_ = compose_relative_transforms(torch.cat([global_pose[None], rel], dim=0))[1:]

    new_prev = OrbFeatures(*[x[-1] for x in feats_new])
    result = VoChunkResult(poses.rotation, poses.translation, num_good, poses.num_inliers, success,
                           is_kf, globals_)
    return (new_prev, state, globals_[-1]), result, feats_new


def vo_chunk(prev_feats: OrbFeatures, kf_state: KeyframeState, global_pose, frames,
             intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(), step_mask=None,
             uniforms=None, seed: int = 0, first_step: int = 0):
    """Process C new frames against the carried previous frame.
    Returns ((new_prev_feats, new_kf_state, new_global_pose), VoChunkResult)."""
    carry, result, _ = vo_frontend(prev_feats, kf_state, global_pose, frames, intrinsics, config,
                                   step_mask, uniforms, seed, first_step)
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

    @property
    def keyframe_ratio(self) -> float:
        return self.keyframe_count / max(self.total_frames, 1)


def run_vo(frames, intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(),
           chunk_size: int | None = None, seed: int = 0, device=None, uniforms=None,
           pose_dtype: torch.dtype = torch.float32) -> VoRun:
    """Run the VO pipeline over a clip [T, H, W] (uint8/float, numpy or
    tensor) on `device` ("cuda" when None; raises without one).

    chunk_size None = the whole clip in one chunk; otherwise frames stream
    through chunks of that many steps. Identical results either way.
    RANSAC draws come from `seed`, one generator per global pair index
    (ops/ransac.py::pair_uniforms, the same numbers on every device), or
    from `uniforms` [T-1, iters, K]. pose_dtype: the dtype of the device
    pose chain (`VoChunkResult.global_poses`), f32 as in the JAX package
    without x64; the trajectory is composed on the host in f64 either way.
    """
    dev = resolve_device(device)
    t_total = frames.shape[0]
    if t_total < 2:
        return VoRun(Trajectory(), t_total, 0, 0, 0, *(np.zeros((0,)),) * 4,
                     np.zeros((0, 3, 3)), np.zeros((0, 3)))
    chunk = chunk_size or t_total
    carry = (seed_features(config.orb, dev), KeyframeState.initial(dev),
             torch.eye(4, dtype=pose_dtype, device=dev))
    results = []
    for start in range(0, t_total, chunk):
        stop = min(start + chunk, t_total)
        block = torch.as_tensor(frames[start:stop]).to(dev)  # uint8 crosses the bus
        step_mask = torch.arange(start, stop, device=dev) >= 1
        draws = None
        if uniforms is not None:
            # Step j is pair max(j - 1, 0); the masked seed step reuses pair 0's.
            steps = [max(j - 1, 0) for j in range(start, stop)]
            draws = torch.as_tensor(uniforms)[steps].to(dev)
        carry, res = vo_chunk(*carry, block, intrinsics, config, step_mask, uniforms=draws, seed=seed,
                              first_step=start)
        results.append(res)
    # One device->host copy per field; drop the masked seed step so row i
    # is pair i.
    merged = VoChunkResult(*[torch.cat(parts, dim=0)[1:].cpu().numpy() for parts in zip(*results)])

    trajectory = Trajectory()
    for idx in np.nonzero(merged.is_keyframe)[0]:
        frame_count = idx + 2  # pair idx connects frame idx -> idx+1 (1-based count)
        trajectory.update(merged.rotations[idx], merged.translations[idx], frame_count,
                          (frame_count - 1) / config.fps)
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
