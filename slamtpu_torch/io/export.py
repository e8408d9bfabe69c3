"""Artifact export: ascii PLY and JSON point clouds (a copy of
slamtpu/io/export.py; the port imports nothing of that package).

Byte-compatible with the reference's outputs: save_ply with the depth
colormap and its truncating casts, save_json as serde's pretty JSON of the
map points. The trajectory JSON is odometry/trajectory.py's.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["depth_to_color_ply", "save_ply", "save_json", "point_cloud_json"]


def depth_to_color_ply(depth: float):
    """Blue -> green -> red over depth 0..50, truncating `as u8` casts."""
    normalized = min(max(depth / 50.0, 0.0), 1.0)
    if normalized < 0.5:
        t = normalized * 2.0
        return (0, int(255.0 * t), int(255.0 * (1.0 - t)))
    t = (normalized - 0.5) * 2.0
    return (int(255.0 * t), int(255.0 * (1.0 - t)), 0)


def save_ply(points, filename: str) -> None:
    """points: iterable of MapPoint (needs .position); ascii, xyz plus a
    depth-coloured uchar rgb per vertex."""
    points = list(points)
    with open(filename, "w") as f:
        f.write("ply\n")
        f.write("format ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\n")
        f.write("property float y\n")
        f.write("property float z\n")
        f.write("property uchar red\n")
        f.write("property uchar green\n")
        f.write("property uchar blue\n")
        f.write("end_header\n")
        for p in points:
            x, y, z = (float(v) for v in np.asarray(p.position))
            r, g, b = depth_to_color_ply(np.float32(z))
            f.write(f"{_fmt(x)} {_fmt(y)} {_fmt(z)} {r} {g} {b}\n")


def _fmt(v: float) -> str:
    """Rust's Display for f64: shortest round-trip representation, whole
    numbers without a trailing '.0'."""
    r = repr(v)
    return r[:-2] if r.endswith(".0") else r


def point_cloud_json(points) -> str:
    """Pretty JSON of the map points: position, descriptor, observations, id."""
    out = []
    for p in points:
        desc = p.descriptor
        out.append(
            {
                "position": [float(v) for v in np.asarray(p.position)],
                "descriptor": None if desc is None else [int(v) for v in np.asarray(desc)],
                "observations": int(p.observations),
                "id": int(p.id),
            }
        )
    return json.dumps(out, indent=2)


def save_json(points, filename: str) -> None:
    with open(filename, "w") as f:
        f.write(point_cloud_json(points))
