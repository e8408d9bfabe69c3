"""Frame sources (counterpart of slamtpu/io/video.py), for the specs that
need no decoder:
  * "synthetic:<T>" or "synthetic:<T>x<H>x<W>" - a rendered scene with ground
    truth (io/synthetic.py);
  * a .npy file holding [T, H, W] uint8.
Video files, image directories and KITTI sequences come with the I/O slice
of the port (ROADMAP Queue 1 item 5) and raise NotImplementedError here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..odometry.camera import CameraIntrinsics

__all__ = ["load_frames"]


def load_frames(
    spec: str,
    max_frames: Optional[int] = None,
    skip_frames: int = 0,
) -> Tuple[np.ndarray, Optional[CameraIntrinsics], float]:
    """Returns (frames [T, H, W] uint8, intrinsics or None, fps)."""
    if spec.startswith("synthetic:"):
        dims = [int(v) for v in spec.split(":", 1)[1].split("x")]
        t = dims[0]
        h, w = (dims[1], dims[2]) if len(dims) == 3 else (376, 1241)
        from .synthetic import render_sequence

        scene = render_sequence(n_frames=t, height=h, width=w, n_points=max(600, (h * w) // 600))
        frames = scene.frames
        if max_frames:
            frames = frames[: max_frames * (skip_frames + 1)]
        return frames[:: skip_frames + 1], scene.intrinsics, 30.0

    if spec.endswith(".npy"):
        frames = np.load(spec)
        if frames.ndim != 3:
            raise ValueError(f"{spec}: expected [T, H, W], got shape {frames.shape}")
        return frames[:: skip_frames + 1][:max_frames], None, 30.0

    raise NotImplementedError(
        f"{spec!r}: video files, image directories and KITTI sequences are not ported yet "
        "(the I/O slice, ROADMAP Queue 1 item 5); use synthetic:<T>[x<H>x<W>] or a .npy [T, H, W] stack"
    )
