"""Trajectory accumulation (counterpart of slamtpu/odometry/trajectory.py).

`compose_relative_transforms` is the whole-clip prefix product of 4x4
relative transforms, here a log-depth (Hillis-Steele) scan of batched
matmuls; `Trajectory` is the host-side frame-at-a-time accumulator whose
JSON output is byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np
import torch

from ..ops.lie import se3_matrix

__all__ = ["TrajectoryPoint", "Trajectory", "compose_relative_transforms", "positions_from_relative"]


def compose_relative_transforms(rel_transforms: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the step axis: [..., T, 4, 4] ->
    out[k] = T[0] @ T[1] @ ... @ T[k] (left-to-right composition order).
    ceil(log2 T) rounds of one batched matmul each."""
    out = rel_transforms
    d = 1
    while d < out.shape[-3]:
        out = torch.cat([out[..., :d, :, :], out[..., :-d, :, :] @ out[..., d:, :, :]], dim=-3)
        d *= 2
    return out


def positions_from_relative(rotations: torch.Tensor, translations: torch.Tensor) -> torch.Tensor:
    """[T, 3, 3], [T, 3] relative motions -> [T+1, 3] global positions,
    the origin first."""
    positions = compose_relative_transforms(se3_matrix(rotations, translations))[:, :3, 3]
    return torch.cat([torch.zeros_like(positions[:1]), positions], dim=0)


@dataclasses.dataclass
class TrajectoryPoint:
    """One trajectory sample."""

    frame: int
    position: List[float]
    timestamp: float


class Trajectory:
    """Stateful accumulator starting with an origin point for frame 0. The
    4x4 state is a small numpy array: per-frame composition is 16 FLOPs and
    does not belong on the device."""

    def __init__(self, dtype=np.float64):
        self._dtype = dtype
        self.global_pose = np.eye(4, dtype=dtype)
        self.points: List[TrajectoryPoint] = [TrajectoryPoint(0, [0.0, 0.0, 0.0], 0.0)]

    def update(self, rotation, translation, frame: int, timestamp: float) -> None:
        """Compose T_global = T_global @ T_rel and record the new position."""
        rel = np.eye(4, dtype=self._dtype)
        rel[:3, :3] = np.asarray(rotation, dtype=self._dtype)
        rel[:3, 3] = np.asarray(translation, dtype=self._dtype).reshape(3)
        self.global_pose = self.global_pose @ rel
        self.points.append(
            TrajectoryPoint(int(frame), [float(v) for v in self.global_pose[:3, 3]], float(timestamp))
        )

    def current_pose(self):
        return self.global_pose

    def current_pose_rt(self):
        return self.global_pose[:3, :3].copy(), self.global_pose[:3, 3].copy()

    def total_distance(self) -> float:
        pos = np.array([p.position for p in self.points])
        if len(pos) < 2:
            return 0.0
        return float(np.sum(np.linalg.norm(np.diff(pos, axis=0), axis=1)))

    def __len__(self) -> int:
        return len(self.points)

    def is_empty(self) -> bool:
        return not self.points

    def to_json(self) -> str:
        """Pretty JSON array: [{"frame": .., "position": [..], "timestamp": ..}]."""
        return json.dumps([dataclasses.asdict(p) for p in self.points], indent=2)

    def save_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
