"""Pipeline checkpoint and resume (counterpart of slamtpu/io/checkpoint.py).

The flagship's resumable state (landmark map, keyframe pose chain, keyframe
frames, the reference-style trajectory and its global pose, the BA
observation log with the landmark id of each observation) round-trips
through a directory holding one numpy `state.npz` and the trajectory as
`trajectory.json` (written by `Trajectory.to_json`, the JAX package's
format). An empty observation log is stored as empty arrays. The JAX
package's orbax checkpoints are not read here: JAX state crosses over
through `convert.point_cloud_result_from_numpy`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import resolve_device
from ..mapping.map import MapState
from ..odometry.trajectory import Trajectory, TrajectoryPoint

__all__ = ["save_map", "load_map", "save_pipeline_state", "load_pipeline_state"]

_STATE = "state.npz"
_TRAJECTORY = "trajectory.json"
_MAP_DTYPES = dict(positions=np.float32, descriptors=np.uint8, observations=np.int32, ids=np.int32,
                   valid=np.bool_, next_id=np.int32)


def _map_arrays(state: MapState) -> dict:
    return {"map_" + name: torch.as_tensor(getattr(state, name)).cpu().numpy().astype(dt)
            for name, dt in _MAP_DTYPES.items()}


def _map_from_arrays(arrays, device) -> MapState:
    return MapState(**{name: torch.from_numpy(np.asarray(arrays["map_" + name], dt)).to(device)
                       for name, dt in _MAP_DTYPES.items()})


def _load_arrays(path: str) -> dict:
    with np.load(os.path.join(path, _STATE), allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def save_map(path: str, state: MapState) -> None:
    """Persist a MapState into the directory `path` (created if needed)."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _STATE), **_map_arrays(state))


def load_map(path: str, device=None) -> MapState:
    """The MapState saved by `save_map`, on `device` ("cuda" when None)."""
    return _map_from_arrays(_load_arrays(path), resolve_device(device))


def save_pipeline_state(path: str, map_state: MapState, kf_rotations, kf_translations, kf_frames,
                        trajectory: Trajectory, observations=None) -> None:
    """Checkpoint the flagship's resumable state into the directory `path`.

    observations: (obs_kf, obs_pt, obs_px, obs_id) or None; a log without
    obs_id (three entries) is saved as a legacy log.
    """
    os.makedirs(path, exist_ok=True)
    arrays = _map_arrays(map_state)
    arrays.update(kf_rotations=np.asarray(kf_rotations), kf_translations=np.asarray(kf_translations),
                  kf_frames=np.asarray(kf_frames, np.int64), global_pose=np.asarray(trajectory.global_pose))
    if observations is not None:
        arrays.update(obs_kf=np.asarray(observations[0], np.int32).reshape(-1),
                      obs_pt=np.asarray(observations[1], np.int32).reshape(-1),
                      obs_px=np.asarray(observations[2], np.float32).reshape(-1, 2))
        if len(observations) > 3:
            arrays["obs_id"] = np.asarray(observations[3], np.int32).reshape(-1)
    np.savez(os.path.join(path, _STATE), **arrays)
    with open(os.path.join(path, _TRAJECTORY), "w") as f:
        f.write(trajectory.to_json())


def load_pipeline_state(path: str, device=None):
    """Returns (map_state on `device` ("cuda" when None), kf_rotations
    [N, 3, 3], kf_translations [N, 3], kf_frames [N] int64, trajectory,
    observations): observations is None when none were saved, else arrays
    (obs_kf [M] int32, obs_pt [M] int32, obs_px [M, 2] f32, obs_id [M]
    int32). A legacy log without obs_id takes the ids its slots hold now,
    as if no slot had been recycled since."""
    dev = resolve_device(device)
    arrays = _load_arrays(path)
    map_state = _map_from_arrays(arrays, dev)

    trajectory = Trajectory()
    with open(os.path.join(path, _TRAJECTORY)) as f:
        trajectory.points = [TrajectoryPoint(p["frame"], p["position"], p["timestamp"]) for p in json.load(f)]
    trajectory.global_pose = np.asarray(arrays["global_pose"], np.float64)

    observations = None
    if "obs_kf" in arrays:
        obs_pt = arrays["obs_pt"]
        obs_id = arrays["obs_id"] if "obs_id" in arrays else arrays["map_ids"][obs_pt]
        observations = (arrays["obs_kf"], obs_pt, arrays["obs_px"].reshape(-1, 2), np.asarray(obs_id, np.int32))
    return (map_state, arrays["kf_rotations"], arrays["kf_translations"], arrays["kf_frames"], trajectory,
            observations)
