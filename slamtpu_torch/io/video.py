"""Frame sources (counterpart of slamtpu/io/video.py).

Input specs accepted by `load_frames`:
  * "synthetic:<T>" or "synthetic:<T>x<H>x<W>" - a rendered scene with ground
    truth (io/synthetic.py);
  * a .npy file holding [T, H, W] uint8;
  * a KITTI odometry sequence directory (calib.txt + image_0/), through
    io/kitti.py, with the intrinsics of P0 and the fps of times.txt;
  * a directory of images (sorted): PNG and PGM through the native loader
    (io/native_loader.py, no image library needed), other formats through
    cv2;
  * a video file, through cv2.
cv2 is imported only for the last two cases that need it: the GPU machine
has no cv2, so frames reach the pipeline there as PNG or PGM files.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..odometry.camera import CameraIntrinsics

__all__ = ["load_frames"]

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".pgm", ".bmp")


def _require_cv2():
    try:
        import cv2

        return cv2
    except ImportError as e:
        raise RuntimeError(
            "cv2 is required for video files and for image directories other than PNG/PGM; "
            "use synthetic:<T>, a .npy stack, or a PNG/PGM directory"
        ) from e


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

    if os.path.isdir(spec) and os.path.exists(os.path.join(spec, "calib.txt")):
        from .kitti import load_sequence

        frames, cam, times = load_sequence(spec, max_frames=max_frames)
        frames = frames[:: skip_frames + 1]
        fps = 1.0 / max(float(np.median(np.diff(times))), 1e-6) if len(times) > 1 else 10.0
        return frames, cam, fps

    if os.path.isdir(spec):
        names = sorted(f for f in os.listdir(spec) if f.lower().endswith(_IMAGE_EXTS))
        names = names[:: skip_frames + 1]
        if max_frames:
            names = names[:max_frames]
        if not names:
            raise ValueError(f"{spec}: no image files ({', '.join(_IMAGE_EXTS)})")
        paths = [os.path.join(spec, n) for n in names]
        if all(n.lower().endswith((".png", ".pgm")) for n in names):
            from .native_loader import NativeFrameLoader

            with NativeFrameLoader(paths) as loader:
                return loader.read(len(paths)), None, 30.0
        cv2 = _require_cv2()
        frames = [img for img in (cv2.imread(p, cv2.IMREAD_GRAYSCALE) for p in paths) if img is not None]
        return np.stack(frames), None, 30.0

    if not os.path.exists(spec):
        raise FileNotFoundError(spec)
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(spec)
    if not cap.isOpened():
        raise FileNotFoundError(spec)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if not (skip_frames and i % (skip_frames + 1)):
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        i += 1
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    return np.stack(frames), None, float(fps)
