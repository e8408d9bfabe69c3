"""Metrics, timing, and optional observability (counterpart of
slamtpu/utils/metrics.py).

  * `force_sync` - waits for the device work behind a result: one
    `torch.cuda.synchronize` per CUDA device its tensors live on; nothing
    on the CPU, where a tensor is ready when it is returned.
  * `StepTimer` - wall-clock FPS/latency counters that end in `force_sync`.
  * `MetricsLog` - structured per-step metric dicts with running summaries
    (the reference's every-30-frames progress lines, as data).
  * `RerunLogger` - optional Rerun logging of trajectory, points and frames,
    gated on the `rerun` package (a no-op stub without it).
  * `profile_trace` - a torch.profiler trace around a block, written as a
    Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["force_sync", "StepTimer", "MetricsLog", "RerunLogger", "draw_match_image", "profile_trace"]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def force_sync(tree):
    """Wait until the device work that produces `tree` (a tensor, or lists,
    tuples, dicts and dataclasses of them) has finished; returns `tree`."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


class StepTimer:
    """Accumulates per-step wall time; fps()/ms() summarize."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_output=None, items: int = 1):
        if sync_output is not None:
            force_sync(sync_output)
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.times.extend([dt / items] * items)
        self._t0 = None
        return dt

    def fps(self, skip: int = 1) -> float:
        t = self.times[skip:] or self.times
        return 1.0 / (sum(t) / len(t)) if t else 0.0

    def ms(self, skip: int = 1) -> float:
        t = self.times[skip:] or self.times
        return 1000.0 * sum(t) / len(t) if t else 0.0


class MetricsLog:
    """Append-only structured metrics with interval printing."""

    def __init__(self, print_every: int = 30):
        self.records: List[Dict] = []
        self.print_every = print_every

    def log(self, step: int, **values):
        rec = {"step": step, **values}
        self.records.append(rec)
        if self.print_every and step % self.print_every == 0:
            parts = " | ".join(f"{k}: {v}" for k, v in values.items())
            print(f"Step {step:5} | {parts}")

    def summary(self) -> Dict:
        if not self.records:
            return {}
        keys = [k for k in self.records[-1] if k != "step" and isinstance(self.records[-1][k], (int, float))]
        return {k: float(np.mean([r[k] for r in self.records if k in r])) for k in keys}


class RerunLogger:
    """Optional Rerun logging with the reference viewer's entity paths,
    colors, radii and per-frame time sequence. A no-op when the `rerun`
    package is unavailable.

    Cadence, as the JAX host loop logs: every frame logs the image; every
    keyframe the camera transform and the 2D and side-by-side match
    overlays; after every keyframe's BA and prune, the 3D map points and the
    trajectory strip.
    """

    def __init__(self, app_id: str = "slamtpu", enabled: bool = True, save_path: str | None = None):
        self._rr = None
        if not enabled:
            return
        try:
            import rerun as rr
        except ImportError:
            return
        rr.init(app_id, spawn=False)
        if save_path:
            rr.save(save_path)
        else:
            # Without a sink every log call lands in an unconnected in-memory
            # recording; spawn the viewer (a no-op sink on a headless machine,
            # where only save_path makes sense).
            try:
                rr.spawn()
            except Exception:
                pass
        self._rr = rr
        # Right-Up-Back view coordinates, static.
        try:
            rr.log("world", rr.ViewCoordinates.RUB, static=True)
        except (AttributeError, TypeError):
            pass  # older rerun API; view coordinates are cosmetic

    @property
    def active(self) -> bool:
        return self._rr is not None

    def set_frame(self, frame: int):
        if self._rr:
            self._rr.set_time_sequence("frame", int(frame))

    def log_trajectory(self, positions):
        """Green 3D line strip at world/trajectory; skipped below 2 points."""
        positions = np.asarray(positions, np.float32)
        if self._rr and positions.shape[0] >= 2:
            self._rr.log("world/trajectory", self._rr.LineStrips3D([positions], colors=[[0, 255, 0]], radii=[0.01]))

    def log_points(self, positions, colors=None):
        """Depth-colored Points3D at world/points; default colors use the
        blue->green->red 0..50 m ramp of the PLY exporter."""
        positions = np.asarray(positions, np.float32)
        if not self._rr or positions.shape[0] == 0:
            return
        if colors is None:
            colors = _depth_colors(positions[:, 2])
        self._rr.log("world/points", self._rr.Points3D(positions, colors=colors, radii=[0.02]))

    def log_camera(self, rotation, translation):
        """Camera-to-world Transform3D at world/camera (rotation and
        translation arrive world-to-camera, as stored)."""
        if self._rr:
            r_ctw = np.asarray(rotation, np.float32).T
            t_ctw = -r_ctw @ np.asarray(translation, np.float32)
            self._rr.log("world/camera", self._rr.Transform3D(translation=t_ctw, mat3x3=r_ctw))

    def log_frame(self, image):
        """Camera image at world/camera/image, grayscale expanded to RGB."""
        if self._rr:
            self._rr.log("world/camera/image", self._rr.Image(_to_rgb(image)))

    def log_matches_2d(self, pts_prev, pts_cur, max_points: int = 100):
        """Keyframe match keypoints over the camera image: previous keyframe
        green, current red, radius 3, at most 100 of each."""
        if not self._rr:
            return
        n = min(len(pts_prev), len(pts_cur), max_points)
        p1 = np.asarray(pts_prev, np.float32)[:n]
        p2 = np.asarray(pts_cur, np.float32)[:n]
        # Two child entities: two logs of one archetype to one path at one
        # timepoint overwrite each other under Rerun's latest-at semantics.
        self._rr.log("world/camera/image/kp_prev", self._rr.Points2D(p1, colors=[[0, 255, 0]], radii=[3.0]))
        self._rr.log("world/camera/image/kp_cur", self._rr.Points2D(p2, colors=[[255, 0, 0]], radii=[3.0]))

    def log_matches_image(self, prev_image, image, pts_prev, pts_cur):
        """Side-by-side keyframe match image at world/keyframe_matches."""
        if self._rr:
            canvas = draw_match_image(prev_image, image, pts_prev, pts_cur)
            self._rr.log("world/keyframe_matches", self._rr.Image(canvas))

    def log_depth(self, rgb_image, depth_colored, frame_idx: int):
        """The depth viewer surface: the input frame at camera/rgb, the
        colormapped disparity at camera/depth_colored, and a "Frame: N" text
        document at info."""
        if not self._rr:
            return
        self._rr.log("camera/rgb", self._rr.Image(_to_rgb(rgb_image)))
        self._rr.log("camera/depth_colored", self._rr.Image(np.asarray(depth_colored, np.uint8)))
        self._rr.log("info", self._rr.TextDocument(f"Frame: {int(frame_idx)}"))


def _depth_colors(depths) -> np.ndarray:
    """Vectorized blue->green->red 0..50 m ramp, with the truncating casts
    of io/export.py's PLY colors."""
    n = np.clip(np.asarray(depths, np.float64) / 50.0, 0.0, 1.0)
    t_lo = n * 2.0
    t_hi = (n - 0.5) * 2.0
    lo = n < 0.5
    r = np.where(lo, 0.0, 255.0 * t_hi)
    g = np.where(lo, 255.0 * t_lo, 255.0 * (1.0 - t_hi))
    b = np.where(lo, 255.0 * (1.0 - t_lo), 0.0)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def _to_rgb(image) -> np.ndarray:
    img = image.cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img


def draw_match_image(img1, img2, pts1, pts2, max_lines: int = 200) -> np.ndarray:
    """A numpy picture of cv2.drawMatches' kind: the frames side by side,
    green match segments, red keypoint dots."""
    a, b = _to_rgb(img1), _to_rgb(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b
    off = a.shape[1]
    p1 = np.asarray(pts1, np.float32).reshape(-1, 2)[:max_lines]
    p2 = np.asarray(pts2, np.float32).reshape(-1, 2)[:max_lines]
    n = min(len(p1), len(p2))
    for (x1, y1), (x2, y2) in zip(p1[:n], p2[:n]):
        steps = int(max(abs(x2 + off - x1), abs(y2 - y1), 1)) + 1
        xs = np.linspace(x1, x2 + off, steps).round().astype(int)
        ys = np.linspace(y1, y2, steps).round().astype(int)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < canvas.shape[1])
        canvas[ys[ok], xs[ok]] = (0, 255, 0)
    for pts, xoff in ((p1[:n], 0), (p2[:n], off)):
        for x, y in pts:
            yy, xx = int(round(y)), int(round(x)) + xoff
            y0, y1_ = max(yy - 1, 0), min(yy + 2, h)
            x0, x1_ = max(xx - 1, 0), min(xx + 2, canvas.shape[1])
            if y0 < y1_ and x0 < x1_:
                canvas[y0:y1_, x0:x1_] = (255, 0, 0)
    return canvas


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """torch.profiler around a block (CPU, and CUDA when a card is there);
    on exit the Chrome trace is written to <log_dir>/trace.json (open it in
    chrome://tracing or Perfetto). Yields log_dir; log_dir defaults to
    slamtpu_torch_trace under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "slamtpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
