"""Multi-device flagship: the sharded VO frontend feeding the fused map
phase (counterpart of slamtpu/parallel/flagship.py).

As in the JAX package, the work splits in two:

  * Phase 1 is parallel.sharded.sharded_vo_step over the (data, seq) mesh,
    with the per-frame features returned beside the poses.
  * Phase 2 is the fused runner's keyframe loop (pipeline/point_cloud.py:
    `_fused_carry_init`, `_fused_phase2_chunk`, `_phase2_host_reconstruct`)
    over all pairs of a clip, on the first rank of its data row: the map is
    a running state, and sharding it would buy nothing. Nothing sharded
    exists on this path.

The sharded frontend computes what the serial one does and phase 2 is the
same code, so each clip's result is run_point_cloud_fused's (up to the
detector's batch: the fused runner detects frame 0 alone, the sharded
frontend in the mesh's blocks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..feature.detector import OrbFeatures
from ..odometry.camera import CameraIntrinsics
from ..odometry.trajectory import Trajectory
from ..ops.ransac import PairDraws, as_draws
from ..pipeline.point_cloud import (
    PointCloudConfig,
    PointCloudResult,
    _fused_carry_init,
    _fused_phase2_chunk,
    _FusedStepOut,
    _phase2_host_reconstruct,
)
from ..pipeline.vo import _index_draws, _step_pairs
from . import distributed as comm
from .mesh import DATA_AXIS, SEQ_AXIS
from .sharded import sharded_vo_step

__all__ = ["run_point_cloud_sharded", "run_point_cloud_batched"]


def _row_phase2(mesh, result, feats: OrbFeatures, intrinsics: CameraIntrinsics, config: PointCloudConfig,
                pose_dtype, t_total: int):
    """Phase 2 of this data row's clip on its seq rank 0: the seq ranks'
    features, relative poses and flags gathered there in one message, then
    the fused keyframe loop over all pairs and the host reconstruction.
    Returns the PointCloudResult on seq rank 0, None on the others."""
    local = [*(x[0] for x in feats), result.rotations[0], result.translations[0], result.is_keyframe[0],
             result.success[0]]
    gathered = comm.gather_to_first(mesh.get_group(SEQ_AXIS), comm.pack(local))
    if gathered is None:
        return None
    fields = [torch.cat(x) for x in zip(*(comm.unpack(row, local) for row in gathered))]  # along time
    n = len(OrbFeatures._fields)
    feats_all, (rot, trans, is_kf, success) = OrbFeatures(*fields[:n]), fields[n:]

    carry = _fused_carry_init(config, OrbFeatures(*[x[0] for x in feats_all]), pose_dtype)
    carry, outs = _fused_phase2_chunk(carry, OrbFeatures(*[x[1:] for x in feats_all]), rot[1:], trans[1:],
                                      is_kf[1:].cpu().numpy(), intrinsics, config)
    outs = _FusedStepOut(*[x.cpu().numpy() for x in outs])
    rot_np, trans_np, iskf_np = (x[1:].cpu().numpy() for x in (rot, trans, is_kf))
    trajectory = Trajectory()
    kf_rots, kf_trans, kf_frames, obs, ba_runs = _phase2_host_reconstruct(outs, rot_np, trans_np, iskf_np,
                                                                          trajectory, config)
    return PointCloudResult(
        map_state=carry.map_state,
        trajectory=trajectory,
        keyframe_rotations=np.stack(kf_rots),
        keyframe_translations=np.stack(kf_trans),
        keyframe_frame_idx=np.asarray(kf_frames),
        ba_runs=ba_runs,
        total_frames=t_total,
        successful_frames=int(success.sum()),
        observations=(np.asarray(obs[0], np.int32), np.asarray(obs[1], np.int32),
                      np.asarray(obs[2], np.float32).reshape(-1, 2), np.asarray(obs[3], np.int32)),
    )


def _map_to(result: PointCloudResult, dev) -> PointCloudResult:
    """`result` with its map on `dev` (results travel between ranks with
    the map on the CPU)."""
    return dataclasses.replace(result, map_state=type(result.map_state)(*[x.to(dev) for x in result.map_state]))


def _check_mesh(mesh, batch: int, t_total: int) -> None:
    _, n_data = comm.axis(mesh, DATA_AXIS)
    _, n_seq = comm.axis(mesh, SEQ_AXIS)
    if batch != n_data:
        raise ValueError(f"{batch} clips must equal the mesh's data size {n_data} (one map per data row)")
    if t_total % n_seq:
        raise ValueError(f"{t_total} frames do not shard evenly over the {n_seq}-way seq axis; pad or trim the clip")


def run_point_cloud_sharded(frames, intrinsics: CameraIntrinsics, mesh, config: PointCloudConfig = PointCloudConfig(),
                            seed: int = 0, chunk_size: int | None = None, uniforms=None,
                            pose_dtype: torch.dtype = torch.float32, device=None) -> PointCloudResult:
    """The flagship with its VO frontend sharded over `mesh` (data size 1:
    one clip; run_point_cloud_batched takes a clip per data row). Every
    rank calls it with the whole clip frames [T, H, W], T divisible by the
    mesh's size, and gets the same PointCloudResult as
    run_point_cloud_fused, its map on the rank's device.

    seed, uniforms ([T-1, ...] per pair) and pose_dtype: as for
    run_point_cloud_fused; chunk_size: frames per detector call on each
    rank (None = the rank's whole block). device: "cuda" when None."""
    dev = resolve_device(device)
    t_total = frames.shape[0]
    _check_mesh(mesh, 1, t_total)
    block = comm.from_process_local(mesh, frames[None])
    t0, t1 = comm.local_time_slice(mesh, t_total)
    draws = None
    if uniforms is not None:
        draws = PairDraws(*[None if x is None else x[None]
                            for x in _index_draws(as_draws(uniforms), _step_pairs(t0, t1 - t0))])
    result, feats = sharded_vo_step(mesh, block, intrinsics, config.vo, chunk_size=chunk_size, uniforms=draws,
                                    seed=seed, return_features=True, pose_dtype=pose_dtype, device=dev)
    out = _row_phase2(mesh, result, feats, intrinsics, config, pose_dtype, t_total)
    if torch.distributed.get_world_size() == 1:
        return out
    shared = comm.broadcast_object(None if out is None else _map_to(out, "cpu"), src=0)
    return out if out is not None else _map_to(shared, dev)


def run_point_cloud_batched(frames, intrinsics: CameraIntrinsics, mesh, config: PointCloudConfig = PointCloudConfig(),
                            seeds=None, chunk_size: int | None = None, pose_dtype: torch.dtype = torch.float32,
                            device=None) -> list:
    """Data-parallel flagship: B independent clips frames [B, T, H, W]
    (every rank is handed all of them), B == the mesh's data size, one
    clip per data row with its time axis sharded over `seq`. Phase 2 runs
    on each row's seq rank 0, one clip and one landmark map per row, with
    no cross-clip communication. Clip b draws from seeds[b] (default b), so
    it equals run_point_cloud_fused(frames[b], seed=seeds[b]).

    Returns on every rank the list of B PointCloudResults, maps on the
    rank's device."""
    dev = resolve_device(device)
    batch, t_total = frames.shape[:2]
    _check_mesh(mesh, batch, t_total)
    seeds = list(range(batch)) if seeds is None else [int(s) for s in seeds]
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} seeds for {batch} clips")
    result, feats = sharded_vo_step(mesh, comm.from_process_local(mesh, frames), intrinsics, config.vo,
                                    chunk_size=chunk_size, seed=seeds, return_features=True, pose_dtype=pose_dtype,
                                    device=dev)
    out = _row_phase2(mesh, result, feats, intrinsics, config, pose_dtype, t_total)
    row, _ = comm.axis(mesh, DATA_AXIS)
    mine = None if out is None else (row, _map_to(out, "cpu"))
    leaders = sorted((x for x in comm.all_gather_object(mine) if x is not None), key=lambda x: x[0])
    return [out if r == row and out is not None else _map_to(res, dev) for r, res in leaders]
