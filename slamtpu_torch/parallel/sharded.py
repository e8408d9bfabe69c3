"""Multi-device VO over the (data, seq) mesh (counterpart of
slamtpu/parallel/sharded.py).

Each rank holds its block of frames [B_local, T_local, H, W]: sequences
shard over `data`, the time axis over `seq`. Two collectives along `seq`
make the sharded step equal the serial `run_vo`:

  1. a one-frame HALO EXCHANGE: each rank sends its last frame's features
     (and, with refine_matches, its pixels) to the next seq rank, which
     pairs them with its first frame; seq rank 0 pairs its first frame with
     the all-masked seed features, and that step is masked as in run_vo;
  2. a CROSS-SHARD PREFIX PRODUCT for the trajectory: each rank composes its
     local relative transforms, all-gathers the per-rank totals and
     multiplies in the product of the totals before it.

Keyframe selection threads a tiny state through the whole sequence, so
every rank all-gathers the per-frame scan inputs (rotation, translation,
match count, success: 14 numbers a frame), runs the full-sequence scan and
keeps its own part: sharded == serial for every KeyframeConfig.

The frames go through the port's frontend in chunks of `chunk_size`, as in
run_vo: one launch of each kernel a chunk (the halo's features are the last
row of the rank's own detection), then matching, sub-pixel refinement,
sigma and RANSAC per chunk. RANSAC needs no collective: frame slot t of the
global clip forms pair t - 1 and draws from that pair's generator
(ops/ransac.py::pair_draws; slot 0 reuses pair 0 and is masked).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..feature.detector import OrbFeatures
from ..mapping.keyframe import KeyframeState
from ..odometry.camera import CameraIntrinsics
from ..odometry.trajectory import compose_relative_transforms
from ..ops.ransac import PairDraws, as_draws, pair_draws
from ..pipeline.vo import (
    VoConfig,
    _detect,
    _index_draws,
    _keyframe_scan,
    _keyframe_transforms,
    _pair_poses,
    _step_pairs,
    seed_features,
)
from . import distributed as comm
from .mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["sharded_vo_step", "ShardedVoResult"]


class ShardedVoResult(NamedTuple):
    rotations: torch.Tensor  # [B, T, 3, 3] per-frame relative pose (frame t vs t-1)
    translations: torch.Tensor  # [B, T, 3]
    success: torch.Tensor  # [B, T] bool (frame 0 of each sequence is False)
    is_keyframe: torch.Tensor  # [B, T] bool
    positions: torch.Tensor  # [B, T, 3] trajectory positions (reference composition)
    num_matches: torch.Tensor  # [B, T] int32


def _halo(seq_group, n_seq: int, last: OrbFeatures, last_frame, config: VoConfig, b: int, dev):
    """The previous seq rank's last features [B, K, ...] (and pixels
    [B, H, W] when refine_matches reads them), or, on seq rank 0, the seed
    features (and None: that pair is masked)."""
    send = list(last) + ([last_frame] if last_frame is not None else [])
    received = comm.shift_right(seq_group, comm.pack(send)) if n_seq > 1 else None
    if received is None:
        seed = OrbFeatures(*[x.expand(b, *x.shape).clone() for x in seed_features(config.orb, dev)])
        return seed, None
    parts = comm.unpack(received, send)
    return OrbFeatures(*parts[:len(last)]), (parts[-1] if last_frame is not None else None)


def _scan_exact(seq_group, config: VoConfig, rotation, translation, num_good, success, seq_rank: int):
    """This rank's keyframe flags [B, T_local] from the full-sequence scan
    over every seq rank's inputs (gathered as f64, which carries f32, int32
    and bool exactly)."""
    b, t_loc = success.shape
    packed = torch.cat([rotation.reshape(b, t_loc, 9).double(), translation.double(),
                        num_good[..., None].double(), success[..., None].double()], dim=-1)
    full = comm.all_gather(seq_group, packed)  # [S, B, T_local, 14]
    full = full.transpose(0, 1).reshape(b, -1, 14)
    state = KeyframeState(*[x.expand(b).clone() for x in KeyframeState.initial(success.device)])
    _, is_kf = _keyframe_scan(config.keyframe, state, full[..., :9].reshape(b, -1, 3, 3).to(rotation.dtype),
                              full[..., 9:12].to(translation.dtype), full[..., 12].to(num_good.dtype),
                              full[..., 13] > 0)
    return is_kf[:, seq_rank * t_loc:(seq_rank + 1) * t_loc]


def _global_positions(seq_group, rel, seq_rank: int):
    """Positions [B, T_local, 3] of the global prefix product of the relative
    transforms rel [B, T_local, 4, 4]: the local prefix, left-multiplied by
    the product of the earlier seq ranks' totals in rank order."""
    local_prefix = compose_relative_transforms(rel)
    totals = comm.all_gather(seq_group, local_prefix[:, -1])  # [S, B, 4, 4]
    offset = torch.eye(4, dtype=rel.dtype, device=rel.device).expand_as(totals[0])
    for s in range(seq_rank):
        offset = offset @ totals[s]
    return (offset[:, None] @ local_prefix)[..., :3, 3]


def sharded_vo_step(mesh, frames, intrinsics: CameraIntrinsics, config: VoConfig = VoConfig(),
                    chunk_size: int | None = None, uniforms=None, seed=0, return_features: bool = False,
                    pose_dtype: torch.dtype = torch.float32, device=None):
    """VO over this rank's block frames [B_local, T_local, H, W] (uint8 or
    float, numpy or tensor) of a [B, T, H, W] batch sharded over `mesh`
    (see parallel/distributed.py::from_process_local). Every rank of the
    mesh calls it with its own block.

    chunk_size: frames per detector call (None = the whole block), as in
    run_vo. RANSAC draws: global sequence b draws from seed + b (seed an
    int, as run_vo_batched) or seed[b] (a sequence of ints), one generator
    per global pair; or from uniforms, this rank's block [B_local, T_local,
    ...] of per-slot draws (slot t holds pair t - 1's, slot 0 is masked;
    a tensor for the essential stream or a PairDraws). pose_dtype: the
    dtype of the prefix product. device: what this rank computes on ("cuda"
    when None; raises without one).

    Returns this rank's ShardedVoResult block on its device; with
    return_features, (result, OrbFeatures [B_local, T_local, K, ...]).
    """
    dev = resolve_device(device)
    data_rank, _ = comm.axis(mesh, DATA_AXIS)
    seq_rank, n_seq = comm.axis(mesh, SEQ_AXIS)
    seq_group = mesh.get_group(SEQ_AXIS)
    b, t_loc = frames.shape[:2]
    t0, b0 = seq_rank * t_loc, data_rank * b
    seeds = [seed + b0 + i for i in range(b)] if isinstance(seed, int) else [int(seed[b0 + i]) for i in range(b)]
    chunk = chunk_size or t_loc
    given = as_draws(uniforms)

    # Detection, one call (one launch of each kernel) a chunk.
    blocks, feats = [], []
    for start in range(0, t_loc, chunk):
        blocks.append(torch.as_tensor(frames[:, start:start + chunk]).to(dev))  # uint8 crosses the bus
        feats.append(_detect(blocks[-1], config))

    prev, prev_frame = _halo(seq_group, n_seq, OrbFeatures(*[x[:, -1] for x in feats[-1]]),
                             blocks[-1][:, -1] if config.refine_matches else None, config, b, dev)
    if config.refine_matches and prev_frame is None:
        prev_frame = blocks[0][:, 0]  # seq rank 0: run_vo's first chunk refines its masked pair against frame 0

    parts = []
    for i, (block, f) in enumerate(zip(blocks, feats)):
        start = i * chunk
        c = block.shape[1]
        steps = _step_pairs(t0 + start, c)
        per_seq = [pair_draws(seeds[j], steps, config.ransac, config.orb.max_features, dev,
                              given=_index_draws(_index_draws(given, j), slice(start, start + c)))
                   for j in range(b)]
        draws = PairDraws(*[None if p[0] is None else torch.stack(p) for p in zip(*per_seq)])
        step_mask = torch.arange(t0 + start, t0 + start + c, device=dev) >= 1
        parts.append(_pair_poses(prev, f, block, intrinsics, config, step_mask, draws,
                                 prev_frame if config.refine_matches else None))
        prev = OrbFeatures(*[x[:, -1] for x in f])
        prev_frame = block[:, -1]
    rotation, translation, num_good, _, success = (torch.cat(p, dim=1) for p in zip(*parts))

    is_kf = _scan_exact(seq_group, config, rotation, translation, num_good, success, seq_rank)
    positions = _global_positions(seq_group, _keyframe_transforms(rotation, translation, is_kf, pose_dtype),
                                  seq_rank)
    result = ShardedVoResult(rotation, translation, success, is_kf, positions, num_good)
    if return_features:
        return result, OrbFeatures(*[torch.cat(x, dim=1) for x in zip(*feats)])
    return result
