"""Pinhole camera intrinsics (counterpart of slamtpu/odometry/camera.py)."""

from __future__ import annotations

import dataclasses

import torch

from ..utils.graphs import device_constant

__all__ = ["CameraIntrinsics"]


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """fx/fy focal lengths and cx/cy principal point, in pixels."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def kitti() -> "CameraIntrinsics":
        """KITTI odometry grayscale left camera."""
        return CameraIntrinsics(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)

    @staticmethod
    def webcam_vga() -> "CameraIntrinsics":
        """Generic 640x480 webcam."""
        return CameraIntrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0)

    def to_matrix(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """3x3 calibration matrix K, built once per (values, dtype, device)
        and shared: callers never write to it. Reading it copies nothing
        from the host, so the fused flagship's keyframe step, which reads it
        inside a CUDA graph, can be replayed."""
        return device_constant(((self.fx, 0.0, self.cx), (0.0, self.fy, self.cy), (0.0, 0.0, 1.0)), dtype,
                               torch.device("cpu" if device is None else device))

    def project(self, points_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D points [..., 3] -> pixels [..., 2] (no z <= 0
        rejection; callers apply their own cheirality masks)."""
        z = points_cam[..., 2]
        u = self.fx * (points_cam[..., 0] / z) + self.cx
        v = self.fy * (points_cam[..., 1] / z) + self.cy
        return torch.stack([u, v], dim=-1)

    def normalize(self, pixels: torch.Tensor) -> torch.Tensor:
        """Pixels [..., 2] -> normalized image coordinates (K^-1 applied)."""
        x = (pixels[..., 0] - self.cx) / self.fx
        y = (pixels[..., 1] - self.cy) / self.fy
        return torch.stack([x, y], dim=-1)
