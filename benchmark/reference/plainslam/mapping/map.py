"""Global landmark map as a fixed-capacity struct of tensors (counterpart of
slamtpu/mapping/map.py).

Positions, packed descriptors, observation counts, ids and a validity mask
of `capacity` slots. Insertion writes new points into free slots in index
order, pruning clears the mask, and re-association Hamming-matches the
map's descriptors (queries) against one frame's as a [capacity, K] matmul.

Reference semantics: projection visibility is z > 0 inside the rough
0 <= u < 4000, 0 <= v < 3000 bounds; matches are kept below
max(2 min_dist, 30); observations start at 1 and prune keeps
observations >= min_observations; ids are assigned sequentially.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..feature.matcher import FeatureMatcher
from ..odometry.camera import CameraIntrinsics
from ..ops.hamming import descriptor_bits
from .triangulation import MapPoint

__all__ = ["MapState", "Map", "map_insert", "map_find_matches", "map_update_observations", "map_prune"]

_BIG = float(1 << 20)


class MapState(NamedTuple):
    positions: torch.Tensor  # [C, 3]
    descriptors: torch.Tensor  # [C, 32] uint8
    observations: torch.Tensor  # [C] int32
    ids: torch.Tensor  # [C] int32 (-1 = empty slot)
    valid: torch.Tensor  # [C] bool
    next_id: torch.Tensor  # int32 scalar

    @staticmethod
    def empty(capacity: int, dtype=torch.float32, device=None) -> "MapState":
        return MapState(
            positions=torch.zeros((capacity, 3), dtype=dtype, device=device),
            descriptors=torch.zeros((capacity, 32), dtype=torch.uint8, device=device),
            observations=torch.zeros((capacity,), dtype=torch.int32, device=device),
            ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            next_id=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    def size(self):
        return torch.sum(self.valid, dtype=torch.int32)


def _set_rows(base: torch.Tensor, slot: torch.Tensor, values) -> torch.Tensor:
    """base with rows `slot` overwritten by `values` (a tensor or a Python
    scalar); slot == len(base) is a scratch row that is dropped (several
    dropped rows may land there). No host synchronization: a scalar is
    filled on the device, not copied from the host."""
    scratch = torch.cat([base, torch.zeros_like(base[:1])], dim=0)
    if torch.is_tensor(values):
        values = values.to(dtype=base.dtype, device=base.device)
    else:
        values = torch.full((), values, dtype=base.dtype, device=base.device)
    scratch[slot] = values
    return scratch[:-1]


def map_insert(state: MapState, positions, descriptors, mask) -> MapState:
    """Write the masked rows of positions [N, 3] / descriptors [N, 32] into
    the free slots in index order. Rows beyond the free-slot count are
    dropped (size the capacity generously)."""
    dev = state.valid.device
    positions = torch.as_tensor(positions).to(device=dev, dtype=state.positions.dtype)
    descriptors = torch.as_tensor(descriptors).to(device=dev, dtype=torch.uint8)
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.bool)
    cap = state.capacity

    # Free slots in index order without a sort: rank each free slot by a
    # cumsum and scatter its index into a rank -> slot table.
    free = ~state.valid
    free_rank = torch.cumsum(free, dim=0, dtype=torch.int32) - 1
    free_slots = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
    free_slots[torch.where(free, free_rank.long(), cap)] = torch.arange(cap, device=dev)
    free_slots = free_slots[:cap]
    n_free = cap - state.size()

    rank = torch.cumsum(mask, dim=0, dtype=torch.int32) - 1  # insertion rank
    insert_ok = mask & (rank < n_free)
    slot = torch.where(insert_ok, free_slots[torch.clamp(rank, 0, cap - 1).long()], cap)

    ids = state.next_id + rank
    return MapState(
        positions=_set_rows(state.positions, slot, positions),
        descriptors=_set_rows(state.descriptors, slot, descriptors),
        observations=_set_rows(state.observations, slot, 1),
        ids=_set_rows(state.ids, slot, ids),
        valid=_set_rows(state.valid, slot, True),
        next_id=state.next_id + torch.sum(mask, dtype=torch.int32),
    )


def map_find_matches(state: MapState, intrinsics: CameraIntrinsics, frame_descriptors, frame_mask,
                     rotation, translation, ratio: float = 2.0, map_bits=None, map_pops=None,
                     frame_xy=None):
    """Re-associate map points with one frame's features.

    Projects every landmark with the world-to-camera pose, keeps those in
    front of the camera and inside the rough bounds, Hamming-matches
    map -> frame and applies the reference ratio filter. Returns
    (train_idx [C] int64, good [C] bool) and, with frame_xy [K, 2], also
    dist [C]: the pixel distance between each slot's projection and its
    matched keypoint (inf behind the camera). map_bits/map_pops: optional
    pre-unpacked map descriptors (ops.hamming.descriptor_bits).

    Distances stay f32, exact integers <= 256; ties take the first minimum.
    """
    dev, dtype = state.positions.device, state.positions.dtype
    rotation = torch.as_tensor(rotation).to(device=dev, dtype=dtype)
    translation = torch.as_tensor(translation).to(device=dev, dtype=dtype)
    frame_mask = torch.as_tensor(frame_mask).to(device=dev, dtype=torch.bool)
    p_cam = state.positions @ rotation.T + translation
    z = p_cam[:, 2]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    u = intrinsics.fx * (p_cam[:, 0] / z_safe) + intrinsics.cx
    v = intrinsics.fy * (p_cam[:, 1] / z_safe) + intrinsics.cy
    visible = state.valid & (z > 0.0) & (u >= 0.0) & (u < 4000.0) & (v >= 0.0) & (v < 3000.0)

    if map_bits is None:
        map_bits, map_pops = descriptor_bits(state.descriptors)
    t_bits, t_pop = descriptor_bits(torch.as_tensor(frame_descriptors).to(dev))
    dots = torch.matmul(map_bits, t_bits.T).to(torch.float32)
    dist = map_pops[:, None] + t_pop[None, :] - 2.0 * dots  # [C, K]
    dist = torch.where(frame_mask[None, :], dist, torch.full_like(dist, _BIG))
    best = torch.amin(dist, dim=1)
    train_idx = torch.argmin(dist, dim=1)  # first minimum

    live = visible & frame_mask[train_idx]
    min_dist = torch.amin(torch.where(live, best, torch.full_like(best, _BIG)))
    threshold = torch.clamp(ratio * min_dist, min=FeatureMatcher.DIST_FLOOR)
    good = live & (best < threshold)
    if frame_xy is None:
        return train_idx, good
    kp = torch.as_tensor(frame_xy).to(device=dev, dtype=dtype)[train_idx]
    px_dist = torch.hypot(u - kp[:, 0], v - kp[:, 1])
    px_dist = torch.where(z > 1e-6, px_dist, torch.full_like(px_dist, float("inf")))
    return train_idx, good, px_dist


def map_update_observations(state: MapState, matched_mask) -> MapState:
    """observations += 1 for matched valid slots."""
    inc = torch.as_tensor(matched_mask).to(device=state.valid.device, dtype=torch.bool) & state.valid
    return state._replace(observations=state.observations + inc.to(torch.int32))


def map_prune(state: MapState, min_observations: int = 2) -> MapState:
    """Drop points with fewer than min_observations observations."""
    return state._replace(valid=state.valid & (state.observations >= min_observations))


class Map:
    """The reference's eager map API over a MapState on `device` ("cuda"
    when None)."""

    def __init__(self, intrinsics: CameraIntrinsics, capacity: int = 65536, min_observations: int = 2,
                 device=None):
        self.intrinsics = intrinsics
        self.min_observations = min_observations
        self.state = MapState.empty(capacity, device=resolve_device(device))

    def add_points(self, points) -> None:
        """Accepts a list of MapPoint or a MapPoints batch."""
        if hasattr(points, "positions"):
            self.state = map_insert(self.state, points.positions, points.descriptors, points.valid)
            return
        if not points:
            return
        pos = np.stack([np.asarray(p.position) for p in points])
        desc = np.stack([np.asarray(p.descriptor, np.uint8) if p.descriptor is not None
                         else np.zeros(32, np.uint8) for p in points])
        self.state = map_insert(self.state, torch.from_numpy(pos), torch.from_numpy(desc),
                                torch.ones(len(points), dtype=torch.bool))

    def find_matches(self, descriptors, pose, frame_mask=None, ratio: float = 2.0):
        """A list of (map_id, keypoint_idx)."""
        descriptors = torch.as_tensor(np.asarray(descriptors, np.uint8))
        if frame_mask is None:
            frame_mask = torch.ones((descriptors.shape[0],), dtype=torch.bool)
        train_idx, good = map_find_matches(self.state, self.intrinsics, descriptors, frame_mask,
                                           torch.as_tensor(np.asarray(pose[0])),
                                           torch.as_tensor(np.asarray(pose[1])), ratio)
        ids = self.state.ids.cpu().numpy()
        tr = train_idx.cpu().numpy()
        return [(int(ids[i]), int(tr[i])) for i in np.nonzero(good.cpu().numpy())[0]]

    def update_observations(self, matches) -> None:
        """matches: list of (map_id, kp_idx) from find_matches."""
        ids = self.state.ids.cpu().numpy()
        mask = np.isin(ids, [m[0] for m in matches]) & self.state.valid.cpu().numpy()
        self.state = map_update_observations(self.state, torch.from_numpy(mask))

    def prune_outliers(self) -> int:
        before = int(self.state.size())
        self.state = map_prune(self.state, self.min_observations)
        return before - int(self.state.size())

    def stable_points(self):
        keep = self.state.valid & (self.state.observations >= self.min_observations)
        return _to_points(self.state, keep)

    def points(self):
        return _to_points(self.state, self.state.valid)

    def size(self) -> int:
        return int(self.state.size())

    def clear(self) -> None:
        self.state = MapState.empty(self.state.capacity, device=self.state.valid.device)


def _to_points(state: MapState, mask) -> list:
    """MapPoints (host numpy) of the masked slots, in slot order."""
    pos = state.positions.cpu().numpy()
    desc = state.descriptors.cpu().numpy()
    obs = state.observations.cpu().numpy()
    ids = state.ids.cpu().numpy()
    return [MapPoint(position=pos[i], descriptor=desc[i], observations=int(obs[i]), id=int(ids[i]))
            for i in np.nonzero(torch.as_tensor(mask).cpu().numpy())[0]]
