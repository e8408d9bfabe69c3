"""Headless visualization (counterpart of slamtpu/utils/viz.py): the
reference's GUI drawings as PNG writers.

`draw_trajectory` draws the reference's top-down X-Z plot on a white canvas
with a 20 px margin, trajectory segments colored on a blue(start)->red(end)
gradient, a green start dot and a red end dot. Colors are RGB. cv2 is
imported when a function is called, never at import (the GPU machine has
no cv2).
"""

from __future__ import annotations

import numpy as np

__all__ = ["draw_trajectory", "save_trajectory_plot"]


def _to_px(x, z, min_x, min_z, scale, height):
    # x maps left->right, z maps bottom->top.
    px = int((x - min_x) * scale + 20.0)
    py = int(height - (z - min_z) * scale - 20.0)
    return px, py


def draw_trajectory(trajectory, width: int = 800, height: int = 600) -> np.ndarray:
    """Render the trajectory's X-Z path to an RGB uint8 canvas.

    White background; fewer than 2 points returns the blank canvas; scale =
    min((w-40)/range_x, (h-40)/range_z) with ranges floored at 1.0; segment
    i colored (1-ratio)*blue + ratio*red with ratio = i/len; 5 px filled
    circles at the start (green) and end (red).
    """
    import cv2

    img = np.full((height, width, 3), 255, np.uint8)
    points = trajectory.points
    if len(points) < 2:
        return img

    pos = np.asarray([p.position for p in points], dtype=np.float64)
    x, z = pos[:, 0], pos[:, 2]
    min_x, min_z = float(x.min()), float(z.min())
    range_x = max(float(x.max()) - min_x, 1.0)
    range_z = max(float(z.max()) - min_z, 1.0)
    scale = min((width - 40.0) / range_x, (height - 40.0) / range_z)

    n = len(points)
    for i in range(1, n):
        pt1 = _to_px(x[i - 1], z[i - 1], min_x, min_z, scale, height)
        pt2 = _to_px(x[i], z[i], min_x, min_z, scale, height)
        ratio = i / n
        color = (int(255 * ratio), 0, int(255 * (1.0 - ratio)))  # RGB: blue->red
        cv2.line(img, pt1, pt2, color, 2, cv2.LINE_AA)

    cv2.circle(img, _to_px(x[0], z[0], min_x, min_z, scale, height), 5, (0, 255, 0), -1, cv2.LINE_AA)
    cv2.circle(img, _to_px(x[-1], z[-1], min_x, min_z, scale, height), 5, (255, 0, 0), -1, cv2.LINE_AA)
    return img


def save_trajectory_plot(trajectory, path: str, width: int = 800, height: int = 600) -> None:
    """Write the top-down trajectory plot as a PNG."""
    import cv2

    img = draw_trajectory(trajectory, width, height)
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
