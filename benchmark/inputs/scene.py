"""The benchmark's scene: a frozen copy of the port's synthetic renderer
(slamtpu_torch/io/synthetic.py::render_sequence) cut to what the cells use:
the forward (KITTI-like corridor) motion, procedural or plain sprites,
sensor noise and the ground-truth poses. It imports numpy only, so the
frames a seed gives do not change when the port does.

Poses are world-to-camera, p_cam = R @ p_world + t.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Scene", "render"]

KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)  # KITTI odometry grayscale left camera


@dataclasses.dataclass
class Scene:
    frames: np.ndarray  # [T, H, W] uint8
    rotations: np.ndarray  # [T, 3, 3] world-to-camera
    translations: np.ndarray  # [T, 3]


def _rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def forward_path(
    n_frames: int,
    step: float = 0.3,
    yaw_rate: float = 0.002,
    forward_dir=(0.0, 0.0, 1.0),
):
    """KITTI-like path: camera drives forward (+z in world) with gentle yaw.

    forward_dir is the motion direction in the CAMERA frame (normalized
    here): (0,0,1) drives exactly along the optical axis, which parks the
    epipole on the principal point and aligns the ground-truth flow field
    with the pixel grid — the forward analog of the lateral scene's
    axis-aligned degeneracy (integer keypoint quantization snaps minimal
    samples into exact consistency with the true essential matrix,
    flattering whichever pipeline quantizes harder). A slightly off-axis
    direction (e.g. (0.12, 0.06, 1.0)) keeps the epipole IN-IMAGE (the hard
    forward regime) but off the grid axes.

    Returns world-to-camera (R, t) per frame.
    """
    fwd = np.asarray(forward_dir, float)
    fwd = fwd / np.linalg.norm(fwd)
    rotations = np.zeros((n_frames, 3, 3))
    translations = np.zeros((n_frames, 3))
    heading = 0.0
    position = np.zeros(3)
    for i in range(n_frames):
        r_wc = _rot_y(heading).T  # world-to-camera
        rotations[i] = r_wc
        translations[i] = -r_wc @ position
        direction = _rot_y(heading) @ fwd
        position = position + step * direction
        heading += yaw_rate
    return rotations, translations


def _splat_sprites(img, dep, idxs, u, v, z, radius, intensities, tex, tex_img=None):
    """Max-paste Gaussian sprites into one frame.

    Bit-exact vectorization of the per-sprite loop this replaces (the loop
    cost ~330 s for a 257-frame KITTI-sized bench scene on a 1-core host,
    ~320 us of Python overhead per sprite x ~1M sprite-frames): the window
    values for all sprites are precomputed in grouped [G, S, S] batches
    (same elementwise float64 ops as the scalar loop, so identical bits),
    then pasted with a thin rectangle loop in the original sprite order —
    ordering only matters for the depth-map winner writes; float32 max
    itself is order-free.

    img: [H, W] float32 (mutated); dep: optional [H, W] float32 depth
    (mutated); idxs: visible sprite indices, ascending; u/v/z/radius:
    per-sprite float64 projections; tex: optional (k, phi, rk) procedural
    texture params; tex_img: optional (image01, cx, cy, ps) REAL-photo
    texture — each sprite is a fronto-parallel billboard carrying the
    image patch centered at (cx_i, cy_i): window offset w (in sprite sigma
    units w/rr) maps to source offset (w/rr)*ps_i, so the source footprint
    is a fixed +-3*ps_i pixels and approach/recede re-samples the SAME real
    patch at higher/lower resolution, exactly like a textured billboard.
    """
    height, width = img.shape
    if idxs.size == 0:
        return
    r_all = np.maximum(radius[idxs], 0.7)
    halves = np.ceil(3.0 * r_all).astype(np.int64)
    x0s = np.trunc(u[idxs]).astype(np.int64) - halves
    y0s = np.trunc(v[idxs]).astype(np.int64) - halves

    # Precompute each sprite's [S, S] float64 value window, grouped by equal
    # window size with a bounded element budget per batch.
    values_list = [None] * idxs.size
    order = np.argsort(halves, kind="stable")
    pos = 0
    while pos < order.size:
        h = int(halves[order[pos]])
        s = 2 * h + 1
        end = pos
        budget = 0
        # `end == pos` always admits at least one sprite per group: a single
        # window above the element budget (radius > ~236 px, e.g. a sprite
        # right in front of the camera at KITTI focal lengths) must form its
        # own batch, not spin this loop forever.
        while (
            end < order.size
            and halves[order[end]] == h
            and (end == pos or budget + s * s <= 2_000_000)
        ):
            budget += s * s
            end += 1
        grp = order[pos:end]
        pos = end
        gi = idxs[grp]
        offs = np.arange(s, dtype=np.float64)
        wy = (y0s[grp][:, None] + offs[None, :]) - v[gi][:, None]  # [G, S]
        wx = (x0s[grp][:, None] + offs[None, :]) - u[gi][:, None]
        rr = np.maximum(radius[gi], 0.7)
        d2 = (wy * wy)[:, :, None] + (wx * wx)[:, None, :]  # [G, S, S]
        splat = np.exp(-d2 / (2.0 * rr * rr)[:, None, None])
        if tex_img is not None:
            timg, tcx, tcy, tps = tex_img
            scale = (tps[gi] / rr)[:, None, None]
            sy = tcy[gi][:, None, None] + wy[:, :, None] * scale
            sx = tcx[gi][:, None, None] + wx[:, None, :] * scale
            # Real patches are arbitrary; keep the Gaussian envelope so
            # sprites stay localized, floor the modulation so every sprite
            # still splats something.
            pattern = 0.15 + 0.85 * _bilinear(timg, sy, sx)
            splat = splat * pattern
        elif tex is not None:
            tex_k, tex_phi, tex_rk = tex
            ang = np.arctan2(wy[:, :, None], wx[:, None, :])
            rad = np.sqrt(d2) / rr[:, None, None]
            pattern = (
                0.55 + 0.45 * np.cos(tex_k[gi][:, None, None] * ang + tex_phi[gi][:, None, None])
            ) * (0.6 + 0.4 * np.cos(tex_rk[gi][:, None, None] * rad))
            splat = splat * pattern
        vals = 96.0 + (intensities[gi] - 96.0)[:, None, None] * splat
        for j, v_arr in zip(grp, vals):
            values_list[j] = v_arr

    # Ordered rectangle paste (max against the accumulated image; depth-map
    # winners recorded per sprite exactly as the scalar loop did).
    for k in range(idxs.size):
        h = int(halves[k])
        s = 2 * h + 1
        x0, y0 = int(x0s[k]), int(y0s[k])
        sx0, sx1 = max(x0, 0), min(x0 + s, width)
        sy0, sy1 = max(y0, 0), min(y0 + s, height)
        if sx0 >= sx1 or sy0 >= sy1:
            continue
        vals = values_list[k][sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0]
        region = img[sy0:sy1, sx0:sx1]
        if dep is not None:
            won = vals > region
            dreg = dep[sy0:sy1, sx0:sx1]
            dreg[won] = z[idxs[k]]
        img[sy0:sy1, sx0:sx1] = np.maximum(region, vals)


def render(n_frames: int, height: int, width: int, camera: dict, n_points: int, step: float, seed: int,
           noise: float = 2.0, yaw_rate: float = 0.002, sprite_size=(0.05, 0.25), textured: bool = False) -> Scene:
    """A forward drive through a corridor of `n_points` landmarks that
    follows the path, `step` world units a frame, seen by a pinhole camera
    (`camera`: fx, fy, cx, cy). The same arguments give the same bits."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = (float(camera[k]) for k in ("fx", "fy", "cx", "cy"))
    forward_dir = (0.0, 0.0, 1.0)
    n_ext = n_frames + int(np.ceil(40.0 / max(step, 1e-6)))
    headings = yaw_rate * np.arange(n_ext + 1)
    directions = np.stack([np.sin(headings), np.zeros(n_ext + 1), np.cos(headings)], axis=1)
    path = np.concatenate([np.zeros((1, 3)), np.cumsum(step * directions[:-1], axis=0)])
    s_idx = rng.uniform(2.0 / max(step, 1e-6), n_ext, n_points)
    base = path[s_idx.astype(int)]
    frac = (s_idx - s_idx.astype(int))[:, None]
    base = base + frac * step * directions[s_idx.astype(int)]
    h = headings[s_idx.astype(int)]
    dx = rng.uniform(-12.0, 12.0, n_points)
    dy = rng.uniform(-6.0, 6.0, n_points)
    points = base + np.stack([dx * np.cos(h), dy, -dx * np.sin(h)], axis=1)
    rotations, translations = forward_path(n_frames, step, yaw_rate, forward_dir)

    intensities = rng.uniform(60.0, 255.0, n_points)
    sizes = rng.uniform(sprite_size[0], sprite_size[1], n_points)  # world radii
    tex_k = rng.integers(2, 6, n_points)
    tex_phi = rng.uniform(0.0, 2 * np.pi, n_points)
    tex_rk = rng.uniform(1.5, 3.5, n_points)

    frames = np.full((n_frames, height, width), 96.0, np.float32)
    tex = (tex_k, tex_phi, tex_rk) if textured else None
    for f in range(n_frames):
        p_cam = points @ rotations[f].T + translations[f]
        z = p_cam[:, 2]
        vis = z > 0.5
        u = fx * (p_cam[:, 0] / z) + cx
        v = fy * (p_cam[:, 1] / z) + cy
        radius = fx * sizes / z
        inside = vis & (u > -10) & (u < width + 10) & (v > -10) & (v < height + 10)
        _splat_sprites(frames[f], None, np.nonzero(inside)[0], u, v, z, radius, intensities, tex)
        if noise:
            frames[f] += rng.normal(0.0, noise, frames[f].shape).astype(np.float32)
    return Scene(np.clip(frames, 0, 255).astype(np.uint8), rotations, translations)
