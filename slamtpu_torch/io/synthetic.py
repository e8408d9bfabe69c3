"""Synthetic 3D scene renderer with ground-truth trajectories (a numpy copy
of slamtpu/io/synthetic.py's render_sequence, using the port's
CameraIntrinsics; the two render identical frames from the same arguments).

Test/bench data source: the environment has no KITTI sequences and no video
files, so end-to-end fidelity (ATE vs the cv2 oracle pipeline, SURVEY.md §6)
is measured on rendered sequences with exact ground truth. The renderer
splats Gaussian sprites from a fixed 3D landmark field through a moving
pinhole camera — enough parallax and corner texture for ORB/FAST while
staying a few lines of numpy.

Camera convention matches the rest of the stack: pose (R, t) is
world-to-camera, p_cam = R @ p_world + t; the camera path is returned as both
per-frame absolute poses and frame-to-frame relative motions (p2 = R_rel p1
+ t_rel, the OpenCV recoverPose convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..odometry.camera import CameraIntrinsics

__all__ = [
    "SyntheticScene",
    "render_sequence",
    "forward_path",
    "lateral_path",
    "orbit_path",
]


@dataclasses.dataclass
class SyntheticScene:
    frames: np.ndarray  # [T, H, W] uint8
    rotations: np.ndarray  # [T, 3, 3] world-to-camera
    translations: np.ndarray  # [T, 3]
    rel_rotations: np.ndarray  # [T-1, 3, 3] (p_next = R p_cur + t)
    rel_translations: np.ndarray  # [T-1, 3]
    points: np.ndarray  # [N, 3] world landmarks
    intrinsics: CameraIntrinsics
    depths: np.ndarray = None  # [T, H, W] f32 depth maps (0 = background), when requested


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


def lateral_path(n_frames: int, step: float = 0.1, direction=(1.0, 0.0, 0.0)):
    """Sideways-tracking path: the camera translates along `direction` (world
    frame, normalized here) while looking down +z. The epipole sits far
    outside the image — the well-conditioned geometry for essential-matrix
    estimation (unlike forward motion, where the epipole is at the principal
    point). A slightly off-axis direction (e.g. (1, 0.15, 0.08)) avoids the
    axis-aligned degeneracy where integer keypoint quantization snaps the
    flow field into EXACT consistency with the true essential matrix, which
    flatters whichever pipeline quantizes harder.

    Returns world-to-camera (R, t) per frame.
    """
    d = np.asarray(direction, float)
    d = d / np.linalg.norm(d)
    rotations = np.broadcast_to(np.eye(3), (n_frames, 3, 3)).copy()
    positions = step * np.arange(n_frames)[:, None] * d[None, :]
    translations = -positions  # R = I, so t = -R @ position = -position
    return rotations, translations


def orbit_path(n_frames: int, radius: float = 15.0, angle_step: float = 0.004):
    """Orbit path: the camera circles the world origin in the xz-plane,
    always looking at the center. Strong sideways parallax at every frame.

    Returns world-to-camera (R, t) per frame.
    """
    rotations = np.zeros((n_frames, 3, 3))
    translations = np.zeros((n_frames, 3))
    for i in range(n_frames):
        a = angle_step * i
        position = radius * np.array([np.sin(a), 0.0, -np.cos(a)])
        # Camera z-axis points from the camera toward the origin.
        fwd = -position / np.linalg.norm(position)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        r_cw = np.stack([right, up, fwd], axis=1)  # camera-to-world columns
        rotations[i] = r_cw.T
        translations[i] = -rotations[i] @ position
    return rotations, translations


def _bilinear(img, y, x):
    """Bilinear sample img [H, W] float64 at float coords (clipped)."""
    h, w = img.shape
    y = np.clip(y, 0.0, h - 1.000001)
    x = np.clip(x, 0.0, w - 1.000001)
    y0 = y.astype(np.int64)
    x0 = x.astype(np.int64)
    fy, fx = y - y0, x - x0
    a = img[y0, x0]
    b = img[y0, x0 + 1]
    c = img[y0 + 1, x0]
    d = img[y0 + 1, x0 + 1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


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


def render_sequence(
    n_frames: int = 30,
    height: int = 240,
    width: int = 320,
    n_points: int = 600,
    step: float = 0.3,
    yaw_rate: float = 0.002,
    intrinsics: CameraIntrinsics | None = None,
    seed: int = 0,
    noise: float = 2.0,
    render_depth: bool = False,
    motion: str = "forward",
    lateral_depth: tuple = (8.0, 30.0),
    sprite_size: tuple = (0.05, 0.25),
    lateral_dir: tuple = (1.0, 0.0, 0.0),
    forward_dir: tuple = (0.0, 0.0, 1.0),
    textured: bool = False,
    texture_image=None,
    repeat_texture: int = 0,
    motion_blur: float = 0.0,
) -> SyntheticScene:
    """Render a moving-camera sequence through a random landmark field.

    motion selects the camera path and a matching landmark layout:
      * "forward" — KITTI-like corridor drive (default; `step`/`yaw_rate`).
      * "lateral" — sideways tracking shot past a landmark wall (`step` is
        per-frame sideways motion); well-conditioned epipolar geometry.
      * "orbit" — circling the landmark cloud, always facing it (`step` is
        the per-frame angle in radians at radius 15).

    With render_depth=True, per-pixel ground-truth depth maps are produced
    alongside (depth of the sprite whose splat dominates the pixel; 0 where
    only background is visible) — the oracle for depth-fusion pipelines.

    texture_image (grayscale [H, W] array, e.g. io.real.grace_hopper())
    textures every sprite with a random patch of a REAL photograph instead
    of the procedural angular pattern — the frames then carry genuine
    natural-image statistics (real gradients, JPEG structure) while keeping
    exact ground truth, narrowing the synthetic-vs-real gap the environment
    otherwise forces (no datasets, no egress).

    Degradation knobs (the low-inlier robustness regime, VERDICT r3 item 5):
      * repeat_texture > 0 — sprites draw their texture identity from a
        pool of only that many distinct patterns (repeated texture:
        descriptors become ambiguous, Hamming matching produces genuine
        OUTLIER matches — brick walls / windows / foliage in the wild).
      * motion_blur > 0 — horizontal box blur of that many pixels applied
        to every frame (camera shake / fast motion), washing out FAST
        corners and blurring descriptors.
    """
    rng = np.random.default_rng(seed)
    cam = intrinsics or CameraIntrinsics(
        fx=0.9 * width, fy=0.9 * width, cx=width / 2.0, cy=height / 2.0
    )

    if motion == "forward":
        # Landmark corridor: a tube of points that FOLLOWS the camera path
        # (the path yaws, so a straight axis-aligned box would starve the
        # frustum on long sequences — the camera drifts laterally out of a
        # fixed corridor). Sample an arc-length position along the path
        # (extended 40 units past the final frame), then offset laterally/
        # vertically in that position's local heading frame; for a straight
        # path this reduces exactly to the uniform box corridor.
        n_ext = n_frames + int(np.ceil(40.0 / max(step, 1e-6)))
        headings = yaw_rate * np.arange(n_ext + 1)
        fwd = np.asarray(forward_dir, float)
        fwd = fwd / np.linalg.norm(fwd)
        # direction = Ry(heading) @ fwd (the same camera-frame drift
        # forward_path applies).
        directions = np.stack(
            [
                fwd[0] * np.cos(headings) + fwd[2] * np.sin(headings),
                np.full(n_ext + 1, fwd[1]),
                -fwd[0] * np.sin(headings) + fwd[2] * np.cos(headings),
            ],
            axis=1,
        )
        path = np.concatenate([np.zeros((1, 3)), np.cumsum(step * directions[:-1], axis=0)])
        s_idx = rng.uniform(2.0 / max(step, 1e-6), n_ext, n_points)
        base = path[s_idx.astype(int)]
        frac = (s_idx - s_idx.astype(int))[:, None]
        base = base + frac * step * directions[s_idx.astype(int)]
        h = headings[s_idx.astype(int)]
        dx = rng.uniform(-12.0, 12.0, n_points)
        dy = rng.uniform(-6.0, 6.0, n_points)
        points = base + np.stack(
            [dx * np.cos(h), dy, -dx * np.sin(h)], axis=1
        )
        rotations, translations = forward_path(n_frames, step, yaw_rate, forward_dir)
    elif motion == "lateral":
        # A deep landmark wall in front of the track: spans the whole travel
        # in x/y, depth lateral_depth for parallax diversity.
        d = np.asarray(lateral_dir, float)
        d = d / np.linalg.norm(d)
        travel = step * n_frames
        points = np.stack(
            [
                rng.uniform(min(0.0, travel * d[0]) - 8.0, max(0.0, travel * d[0]) + 8.0, n_points),
                rng.uniform(min(0.0, travel * d[1]) - 6.0, max(0.0, travel * d[1]) + 6.0, n_points),
                rng.uniform(lateral_depth[0], lateral_depth[1], n_points),
            ],
            axis=1,
        )
        points[:, 2] += travel * max(d[2], 0.0) * rng.uniform(0.0, 1.0, n_points)
        rotations, translations = lateral_path(n_frames, step, lateral_dir)
    elif motion == "orbit":
        # A landmark ball around the orbit center, kept inside the orbit.
        points = rng.normal(0.0, 3.0, (n_points, 3))
        points[:, 1] = rng.uniform(-4.0, 4.0, n_points)
        rotations, translations = orbit_path(n_frames, angle_step=step)
    else:
        raise ValueError(f"unknown motion {motion!r}")

    intensities = rng.uniform(60.0, 255.0, n_points)
    sizes = rng.uniform(sprite_size[0], sprite_size[1], n_points)  # world radii
    # Optional per-sprite texture: plain Gaussian splats are rotationally
    # symmetric, so every sprite yields a near-identical BRIEF descriptor and
    # brute-force Hamming matching (ours AND the cv2 oracle) degenerates to
    # chance. An angular + radial modulation unique to each sprite gives ORB
    # distinctive corners and discriminative descriptors.
    tex_k = rng.integers(2, 6, n_points)
    tex_phi = rng.uniform(0.0, 2 * np.pi, n_points)
    tex_rk = rng.uniform(1.5, 3.5, n_points)
    if repeat_texture and repeat_texture > 0:
        # Repeated-texture degradation: only `repeat_texture` distinct
        # identities; intensity pooled too (brightness otherwise still
        # disambiguates sprites through the BRIEF comparisons).
        pool = rng.integers(0, repeat_texture, n_points)
        tex_k = tex_k[pool]
        tex_phi = tex_phi[pool]
        tex_rk = tex_rk[pool]
        intensities = intensities[pool]

    tex_img = None
    if texture_image is not None:
        timg = np.asarray(texture_image, np.float64)
        span = float(timg.max() - timg.min())
        timg = (timg - timg.min()) / max(span, 1e-9)
        th, tw = timg.shape
        # Fixed +-3*ps source footprint per sprite (see _splat_sprites);
        # keep the whole footprint inside the photo.
        ps_hi = min(14.0, (min(th, tw) - 4) / 6.0)
        ps = rng.uniform(min(6.0, ps_hi), ps_hi, n_points)
        margin = 3.0 * ps + 1.0
        tcy = rng.uniform(margin, th - margin)
        tcx = rng.uniform(margin, tw - margin)
        tex_img = (timg, tcx, tcy, ps)

    frames = np.full((n_frames, height, width), 96.0, np.float32)
    depths = np.zeros((n_frames, height, width), np.float32) if render_depth else None
    tex = (tex_k, tex_phi, tex_rk) if textured and tex_img is None else None
    for f in range(n_frames):
        p_cam = points @ rotations[f].T + translations[f]
        z = p_cam[:, 2]
        vis = z > 0.5
        u = cam.fx * (p_cam[:, 0] / z) + cam.cx
        v = cam.fy * (p_cam[:, 1] / z) + cam.cy
        radius = cam.fx * sizes / z
        inside = vis & (u > -10) & (u < width + 10) & (v > -10) & (v < height + 10)
        img = frames[f]
        _splat_sprites(
            img,
            depths[f] if depths is not None else None,
            np.nonzero(inside)[0],
            u, v, z, radius, intensities, tex, tex_img,
        )
        if motion_blur and motion_blur > 1.0:
            # Horizontal box blur (optical, so applied before sensor noise).
            k = int(round(motion_blur))
            pad = np.pad(img, ((0, 0), (k // 2, k - 1 - k // 2)), mode="edge")
            c = np.concatenate(
                [np.zeros((img.shape[0], 1)), np.cumsum(pad, axis=1, dtype=np.float64)],
                axis=1,
            )
            img[:, :] = ((c[:, k:] - c[:, :-k]) / k).astype(np.float32)
        if noise:
            img += rng.normal(0.0, noise, img.shape).astype(np.float32)

    frames = np.clip(frames, 0, 255).astype(np.uint8)

    # Frame-to-frame relative motion: T_rel = T_next @ T_cur^-1 restricted to
    # (R, t): R_rel = R_next R_cur^T, t_rel = t_next - R_rel t_cur.
    rel_r = np.einsum("tij,tkj->tik", rotations[1:], rotations[:-1])
    rel_t = translations[1:] - np.einsum("tij,tj->ti", rel_r, translations[:-1])

    return SyntheticScene(
        frames=frames,
        rotations=rotations,
        translations=translations,
        rel_rotations=rel_r,
        rel_translations=rel_t,
        points=points,
        intrinsics=cam,
        depths=depths,
    )
