"""KITTI odometry dataset plumbing (counterpart of slamtpu/io/kitti.py).

The dataset layout is read directly:

    sequences/<NN>/calib.txt   P0..P3 projection matrices (P0 = gray left)
    sequences/<NN>/times.txt   per-frame timestamps (seconds)
    sequences/<NN>/image_0/    grayscale left PNGs

Frames decode through the native C++ loader (io/native_loader.py), which
needs no image library; it raises if it cannot be built.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..odometry.camera import CameraIntrinsics

__all__ = ["load_calib", "load_times", "load_sequence", "load_poses"]


def load_calib(path: str, camera: int = 0) -> CameraIntrinsics:
    """Parse calib.txt; returns the pinhole intrinsics of camera `camera`."""
    with open(path) as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key.strip() == f"P{camera}":
                p = np.asarray([float(v) for v in rest.split()], np.float64).reshape(3, 4)
                return CameraIntrinsics(fx=p[0, 0], fy=p[1, 1], cx=p[0, 2], cy=p[1, 2])
    raise ValueError(f"P{camera} not found in {path}")


def load_times(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def load_poses(path: str) -> np.ndarray:
    """Ground-truth poses file (odometry devkit): [T, 3, 4] camera-to-world."""
    return np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)


def load_sequence(
    sequence_dir: str,
    camera: int = 0,
    max_frames: Optional[int] = None,
    threads: int = 4,
) -> Tuple[np.ndarray, CameraIntrinsics, np.ndarray]:
    """Returns (frames [T, H, W] uint8, intrinsics, timestamps [T])."""
    from .native_loader import NativeFrameLoader

    cam = load_calib(os.path.join(sequence_dir, "calib.txt"), camera)
    times_path = os.path.join(sequence_dir, "times.txt")
    times = load_times(times_path) if os.path.exists(times_path) else None

    image_dir = os.path.join(sequence_dir, f"image_{camera}")
    names = sorted(n for n in os.listdir(image_dir) if n.endswith(".png"))
    if max_frames:
        names = names[:max_frames]
    paths = [os.path.join(image_dir, n) for n in names]
    with NativeFrameLoader(paths, threads=threads) as loader:
        frames = loader.read(len(paths))

    if times is None:
        times = np.arange(len(names), dtype=np.float64) / 10.0  # KITTI is 10 Hz
    return frames, cam, times[: len(names)]
