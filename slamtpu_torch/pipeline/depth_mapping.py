"""Semi-dense depth mapping: MonoDepth2 fused with VO poses (counterpart of
slamtpu/pipeline/depth_mapping.py).

Run the VO frontend for keyframe poses, predict dense depth per keyframe,
optionally align the monocular scale against landmarks, and back-project a
subsampled depth grid into a world-frame semi-dense cloud. Each keyframe's
back-projection is one batched f32 device op; the clouds stay on the device
until one fetch at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..odometry.camera import CameraIntrinsics
from .vo import VoConfig, VoRun, run_vo

__all__ = ["disp_to_depth", "backproject_depth", "align_depth_scale", "run_depth_mapping", "DepthMappingResult"]


def disp_to_depth(disp, min_depth: float = 0.1, max_depth: float = 100.0):
    """MonoDepth2's sigmoid-disparity -> depth convention (upstream
    layers.disp_to_depth): depth = 1 / (1/max + (1/min - 1/max) * disp)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled = min_disp + (max_disp - min_disp) * disp
    return 1.0 / scaled


def backproject_depth(intrinsics: CameraIntrinsics, depth, rotation, translation, stride: int = 4):
    """Depth map [H, W] -> world points [(H/s)*(W/s), 3] + validity, f32 on
    the depth's device.

    rotation/translation are world-to-camera; points come back in world
    coordinates (p_w = R^T (p_c - t)). Zero/negative depths are masked.
    """
    depth = torch.as_tensor(depth, dtype=torch.float32)
    h, w = depth.shape
    dev = depth.device
    grid_y, grid_x = torch.meshgrid(torch.arange(0, h, stride, device=dev, dtype=torch.float32),
                                    torch.arange(0, w, stride, device=dev, dtype=torch.float32), indexing="ij")
    d = depth[::stride, ::stride].reshape(-1)
    x_n = (grid_x.reshape(-1) - intrinsics.cx) / intrinsics.fx
    y_n = (grid_y.reshape(-1) - intrinsics.cy) / intrinsics.fy
    p_cam = torch.stack([x_n * d, y_n * d, d], dim=-1)
    rotation = torch.as_tensor(rotation, dtype=torch.float32).to(dev)
    translation = torch.as_tensor(translation, dtype=torch.float32).to(dev)
    p_world = (p_cam - translation) @ rotation
    return p_world, d > 1e-6


def align_depth_scale(depth, landmark_points_cam, intrinsics: CameraIntrinsics):
    """Median-ratio scale alignment of a monocular depth map against sparse
    VO landmarks observed in the same camera (the classic fix for monocular
    scale ambiguity). landmark_points_cam: [N, 3] in CAMERA coordinates.
    Returns a scalar s so that s * depth matches the landmark scale."""
    pts = np.asarray(landmark_points_cam)
    pts = pts[pts[:, 2] > 0.5]
    if len(pts) == 0:
        return 1.0
    h, w = np.asarray(depth).shape
    u = np.clip((intrinsics.fx * pts[:, 0] / pts[:, 2] + intrinsics.cx).astype(int), 0, w - 1)
    v = np.clip((intrinsics.fy * pts[:, 1] / pts[:, 2] + intrinsics.cy).astype(int), 0, h - 1)
    d_pred = np.asarray(depth)[v, u]
    ok = d_pred > 1e-6
    if not ok.any():
        return 1.0
    return float(np.median(pts[ok, 2] / d_pred[ok]))


@dataclasses.dataclass
class DepthMappingResult:
    points: np.ndarray  # [N, 3] world-frame semi-dense cloud, f32
    keyframe_rotations: np.ndarray
    keyframe_translations: np.ndarray
    keyframe_frame_idx: np.ndarray
    vo_run: Optional[VoRun] = None  # the VO run the keyframes came from

    def save_ply(self, path: str = "semi_dense.ply"):
        from ..io.export import save_ply
        from ..mapping.triangulation import MapPoint

        save_ply([MapPoint(position=p) for p in self.points], path)


def run_depth_mapping(
    frames,
    intrinsics: CameraIntrinsics,
    depth_fn: Callable,
    vo_config: Optional[VoConfig] = None,
    stride: int = 4,
    keyframe_stride: int = 2,
    max_points: int = 200_000,
    seed: int = 0,
    scale_align: bool = False,
    landmarks_world=None,
    device=None,
) -> DepthMappingResult:
    """frames [T, H, W]; depth_fn maps one [H, W] frame to an [H, W] depth
    map (numpy or a tensor). VO and the back-projection run on `device`
    ("cuda" when None; raises without one).

    For MonoDepth2, cli/depth_estimation.py's `depth_fn_for(model, H, W)`:
    disp_to_depth of `predict_raw`, resized back to H x W. For tests, the
    renderer's ground-truth depth maps stand in. When `scale_align` is set,
    each keyframe's depth is median-aligned against `landmarks_world`
    ([N, 3], e.g. the VO point cloud).
    """
    dev = resolve_device(device)
    run = run_vo(frames, intrinsics, vo_config or VoConfig(), chunk_size=32, seed=seed, device=dev)

    # World-to-camera chain over keyframes (like pipeline/point_cloud).
    kf_rots: List[np.ndarray] = [np.eye(3)]
    kf_trans: List[np.ndarray] = [np.zeros(3)]
    kf_frames: List[int] = [0]
    for idx in np.nonzero(run.is_keyframe)[0]:
        kf_rots.append(run.rotations[idx] @ kf_rots[-1])
        kf_trans.append(run.rotations[idx] @ kf_trans[-1] + run.translations[idx])
        kf_frames.append(int(idx) + 1)

    points, valid = [], []
    for k in range(0, len(kf_frames), keyframe_stride):
        depth = torch.as_tensor(depth_fn(frames[kf_frames[k]]), dtype=torch.float32).to(dev)
        if scale_align and landmarks_world is not None and len(landmarks_world):
            pts_cam = np.asarray(landmarks_world) @ kf_rots[k].T + kf_trans[k]
            depth = depth * align_depth_scale(depth.cpu().numpy(), pts_cam, intrinsics)
        pts, ok = backproject_depth(intrinsics, depth, kf_rots[k], kf_trans[k], stride=stride)
        points.append(pts)
        valid.append(ok)

    if points:
        cloud = torch.cat(points)[torch.cat(valid)].cpu().numpy()
    else:
        cloud = np.zeros((0, 3), np.float32)
    if len(cloud) > max_points:
        sel = np.random.default_rng(0).choice(len(cloud), max_points, replace=False)
        cloud = cloud[sel]
    return DepthMappingResult(
        points=cloud,
        keyframe_rotations=np.stack(kf_rots),
        keyframe_translations=np.stack(kf_trans),
        keyframe_frame_idx=np.asarray(kf_frames),
        vo_run=run,
    )
