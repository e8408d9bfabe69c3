#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (slamtpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compiles every kernel under slamtpu_torch/csrc/ (one nvcc per
               source, in parallel) and prints ptxas's register /
               shared-memory summary;
  2. kernels - at the VO chunk's shapes (32 frames, 8 pyramid levels of
               1241x376), holds each kernel against its plain PyTorch version
               on the same CUDA tensors and times kernel, plain version and,
               where one exists, the single PyTorch call computing the same
               function (CUDA events, median over distinct inputs);
  3. vo      - runs slamtpu_torch.pipeline.vo.run_vo with VoConfig() defaults
               on bench.py's clip (257 rendered 1241x376 frames) in chunks of
               32, VO_REPEATS times; checks in every run that both kernels
               were launched, the same number of times; prints the median
               frames/s and the spread; gates pose success >= 0.8 and
               median rotation error <= 1 deg against ground truth; and
               checks the CUDA path against the plain CPU path on a small
               clip.
Then it prints one JSON line with every kernel's numbers, the card's name
and power limit (nvidia-smi), and, last, {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device or without the slamtpu_torch package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
# f32 operations K1 does per output pixel: FAST 192 (16 differences, 16
# negations, two 64-min/15-max arc trees, max, threshold), NMS 10, Sobel 14,
# gradient products 3, two 7-tap box sums for three products 36, Harris 8,
# select 1.
K1_OPS_PER_PIXEL = 264
N_FRAMES = 257  # bench.py's clip
VO_REPEATS = 5
CHUNK = 32
HEIGHT, WIDTH = 376, 1241


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def time_ms(torch, fn, inputs, reps: int = 1) -> float:
    """Median over `inputs` (distinct tensors) of one call's device time."""
    fn(inputs[0])  # warm-up
    times = []
    for _ in range(reps):
        for x in inputs:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
    return statistics.median(times)


def render():
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    return render_sequence(
        n_frames=N_FRAMES, height=HEIGHT, width=WIDTH, n_points=4000, step=0.8,
        intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0,
    )


def kernel_phase(torch, frames):
    """K1 and K2 against their plain versions at the VO chunk's shapes."""
    from slamtpu_torch.feature.detector import OrbConfig, _select_level, features_per_level
    from slamtpu_torch.ops.brief import PATCH_RADIUS
    from slamtpu_torch.ops.corner import corner_response, corner_response_plain
    from slamtpu_torch.ops.patch import extract_patches_batched, extract_patches_plain
    from slamtpu_torch.ops.pyramid import build_pyramid, gaussian_blur

    cfg = OrbConfig()
    quotas = features_per_level(cfg.max_features, cfg.n_levels, cfg.scale_factor)
    subpix = [lv <= cfg.subpixel_max_octave for lv in range(cfg.n_levels)]
    base = torch.as_tensor(frames[:CHUNK]).cuda().float()
    # Distinct inputs for timing: the same frames under small intensity shifts.
    variants = [build_pyramid(base + 0.25 * i, cfg.n_levels, cfg.scale_factor) for i in range(5)]
    levels = variants[0]

    # --- K1 agreement ------------------------------------------------------
    k1_err, starts, blurred = 0.0, [], []
    for lv, img in enumerate(levels):
        img = img.contiguous()
        rk, hk = corner_response(img, cfg.fast_threshold, with_harris=True)
        rn = corner_response(img, cfg.fast_threshold, with_harris=False)
        rp, hp = corner_response_plain(img, cfg.fast_threshold, with_harris=True)
        torch.cuda.synchronize()
        m = 10
        fk, fp = torch.isfinite(rk[:, m:-m, m:-m]), torch.isfinite(rp[:, m:-m, m:-m])
        n_diff = int((fk != fp).sum())
        if n_diff or not torch.equal(rk, rn):
            raise AssertionError(f"K1 level {lv}: corner sets differ at {n_diff} interior pixels")
        a, b = hk[:, m:-m, m:-m], hp[:, m:-m, m:-m]
        err = (a - b).abs()
        tol = 1e-4 * b.abs() + 1e-6 * b.abs().max()
        if not bool((err <= tol).all()):
            raise AssertionError(f"K1 level {lv}: Harris outside rtol 1e-4 (max abs err {float(err.max())})")
        k1_err = max(k1_err, float(err.max()))
        log(f"K1 level {lv} {tuple(img.shape)}: {int(fk.sum())} corners, identical sets, "
            f"Harris max abs err {float(err.max()):.3g}")
        xy_int = _select_level(rk, quotas[lv], cfg.edge_threshold, hk if subpix[lv] else None)[0]
        starts.append((torch.round(xy_int).to(torch.int32) - PATCH_RADIUS).contiguous())
        blurred.append(gaussian_blur(img))

    # --- K2 agreement ------------------------------------------------------
    k2_err = 0.0
    for lv, (img, st) in enumerate(zip(blurred, starts)):
        pk = extract_patches_batched(img, st, PATCH_RADIUS)
        pp = extract_patches_plain(img, st, PATCH_RADIUS)
        k2_err = max(k2_err, float((pk - pp).abs().max()))
        if not torch.equal(pk, pp):
            raise AssertionError(f"K2 level {lv}: windows differ from the plain version")
    log(f"K2: all levels bit-identical to the plain version (max abs err {k2_err})")

    # --- timing (per 32-frame chunk: all 8 levels) ---------------------------
    def k1(pyr, fn):
        for lv, img in enumerate(pyr):
            fn(img, cfg.fast_threshold, with_harris=subpix[lv])

    blurred_variants = [[gaussian_blur(img) for img in pyr] for pyr in variants]

    def k2(blur, fn):
        for img, st in zip(blur, starts):
            fn(img, st, PATCH_RADIUS)

    size = 2 * PATCH_RADIUS + 1

    def gather_lib(blur):
        for img, st in zip(blur, starts):
            b, h, w = img.shape
            x0 = st[..., 0].clamp(0, w - size).long()
            y0 = st[..., 1].clamp(0, h - size).long()
            r = torch.arange(size, device=img.device)
            bi = torch.arange(b, device=img.device)[:, None, None, None]
            img[bi, (y0[..., None] + r)[..., :, None], (x0[..., None] + r)[..., None, :]]

    launches_before = (corner_response.launches, extract_patches_batched.launches)
    times = dict(
        k1=time_ms(torch, lambda p: k1(p, corner_response), variants, reps=3),
        k1_plain=time_ms(torch, lambda p: k1(p, corner_response_plain), variants[:3]),
        k2=time_ms(torch, lambda bl: k2(bl, extract_patches_batched), blurred_variants, reps=3),
        k2_plain=time_ms(torch, lambda bl: k2(bl, extract_patches_plain), blurred_variants[:3]),
        k2_lib=time_ms(torch, gather_lib, blurred_variants, reps=3),
    )
    # Comparison and timing launches do not count as main-path launches.
    corner_response.launches, extract_patches_batched.launches = launches_before

    # --- bounds from this run's shapes and data -------------------------------
    px = sum(img.numel() for img in levels)
    px_harris = sum(img.numel() for lv, img in enumerate(levels) if subpix[lv])
    k1_bytes = 4 * (2 * px + px_harris)
    k1_ops = K1_OPS_PER_PIXEL * px
    k2_write = sum(st.shape[0] * st.shape[1] * size * size * 4 for st in starts)
    k2_read = 0
    for img, st in zip(blurred, starts):  # distinct window pixels this data reads
        b, h, w = img.shape
        covered = torch.zeros((b, h + 1, w + 1), dtype=torch.int32, device=img.device)
        x0 = st[..., 0].clamp(0, w - size).long()
        y0 = st[..., 1].clamp(0, h - size).long()
        bi = torch.arange(b, device=img.device)[:, None].expand_as(x0)
        one = torch.ones_like(x0, dtype=torch.int32)
        for yy, xx, sgn in ((y0, x0, 1), (y0, x0 + size, -1), (y0 + size, x0, -1), (y0 + size, x0 + size, 1)):
            covered.index_put_((bi, yy, xx), sgn * one, accumulate=True)
        covered = covered.cumsum(1).cumsum(2)
        k2_read += 4 * int((covered[:, :h, :w] > 0).sum())
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_FLOP_PER_S) * 1e3
    k2_bound = (k2_read + k2_write) / HBM_BYTES_PER_S * 1e3
    log(f"K1 per chunk: kernel {times['k1']:.4f} ms, plain {times['k1_plain']:.4f} ms, bound "
        f"{k1_bound:.4f} ms ({k1_bytes / 1e6:.1f} MB, {k1_ops / 1e9:.2f} GFLOP)")
    log(f"K2 per chunk: kernel {times['k2']:.4f} ms, plain {times['k2_plain']:.4f} ms, gather "
        f"{times['k2_lib']:.4f} ms, bound {k2_bound:.4f} ms ({(k2_read + k2_write) / 1e6:.1f} MB)")
    return [
        dict(name="corner_response", route="cuda", source="slamtpu_torch/csrc/corner_response.cu",
             replaces="slamtpu/ops/pallas_corner.py:165", launches=None, max_abs_err=k1_err,
             ms=times["k1"], plain_ms=times["k1_plain"], bound_ms=k1_bound,
             bound_by="operations" if k1_ops / FP32_FLOP_PER_S > k1_bytes / HBM_BYTES_PER_S else "bytes",
             library_ms=None),
        dict(name="extract_patches_batched", route="cuda", source="slamtpu_torch/csrc/extract_patches.cu",
             replaces="slamtpu/ops/pallas_patch.py:80", launches=None, max_abs_err=k2_err,
             ms=times["k2"], plain_ms=times["k2_plain"], bound_ms=k2_bound, bound_by="bytes",
             library_ms=times["k2_lib"]),
    ]


def vo_phase(torch, scene):
    """The main path: run_vo on the card at full width, gated on ground truth."""
    import numpy as np

    from slamtpu_torch.ops.corner import corner_response
    from slamtpu_torch.ops.patch import extract_patches_batched
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo

    config = VoConfig()
    run_vo(scene.frames[: CHUNK + 1], scene.intrinsics, config, chunk_size=CHUNK, device="cuda")  # warm-up

    elapsed, launches = [], None
    for _ in range(VO_REPEATS):
        corner_response.launches = 0
        extract_patches_batched.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_vo(scene.frames, scene.intrinsics, config, chunk_size=CHUNK, seed=0, device="cuda")
        elapsed.append(time.perf_counter() - t0)
        counts = {"corner_response": corner_response.launches,
                  "extract_patches_batched": extract_patches_batched.launches}
        for name, n in counts.items():
            if n == 0:
                raise AssertionError(f"the VO run never launched kernel {name}")
        if launches is not None and counts != launches:
            raise AssertionError(f"launch counts changed between runs: {launches} vs {counts}")
        launches = counts

    if run.rotations.shape != (N_FRAMES - 1, 3, 3) or not np.isfinite(run.rotations).all():
        raise AssertionError("VO rotations are not finite [T-1, 3, 3]")
    tr = np.einsum("tij,tij->t", run.rotations, scene.rel_rotations)
    rot_err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    ok = run.success.astype(bool)
    success_rate = float(ok.mean())
    rot_med = float(np.median(rot_err[ok])) if ok.any() else float("inf")
    fps = sorted(N_FRAMES / e for e in elapsed)
    fps_med = statistics.median(fps)
    log(f"VO: {N_FRAMES} frames {WIDTH}x{HEIGHT}, {VO_REPEATS} runs in {[round(e, 4) for e in elapsed]} s -> "
        f"median {fps_med:.2f} frames/s (min {fps[0]:.2f}, max {fps[-1]:.2f}); "
        f"success {success_rate:.4f}, median rot err {rot_med:.4f} deg; launches per run {launches}")
    if success_rate < 0.8 or rot_med > 1.0:
        raise AssertionError(f"VO gates failed: success {success_rate} (>= 0.8), median rot err {rot_med} (<= 1.0)")
    return launches, dict(frames=N_FRAMES, fps_median=fps_med, fps_min=fps[0], fps_max=fps[-1],
                          elapsed_s=elapsed, success_rate=success_rate, rot_err_deg_median=rot_med)


def reference_phase(torch):
    """The CUDA path against the plain CPU path on a small clip: detector
    outputs and match counts agree; the pose solver agrees in f64 given the
    same correspondences and draws; both VO runs meet the ground-truth gate.
    (In f32 the two devices round differently inside the five-point solver,
    which can change a RANSAC winner, so f32 poses are held to ground truth,
    not to each other.)"""
    import numpy as np

    from slamtpu_torch.feature.detector import OrbConfig, detect_and_compute
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.odometry.pose import estimate_relative_pose
    from slamtpu_torch.ops.ransac import RansacConfig
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo

    scene = render_sequence(n_frames=8, height=160, width=240, n_points=600, step=0.3, seed=3, textured=True)
    config = VoConfig(orb=OrbConfig(max_features=128, n_levels=4), ransac=RansacConfig(iters=32, min_solver="5pt"))

    frames = torch.from_numpy(scene.frames)
    fg = detect_and_compute(frames.cuda(), config.orb)
    fc = detect_and_compute(frames, config.orb)
    xy_diff = float((fg.xy.cpu() - fc.xy).abs().max())
    desc_same = float((fg.descriptors.cpu() == fc.descriptors).float().mean())
    if not torch.equal(fg.mask.cpu(), fc.mask) or xy_diff > 1e-3 or desc_same < 0.99:
        raise AssertionError(f"detector: CUDA vs CPU masks/xy/descriptors disagree ({xy_diff}, {desc_same})")

    # f64 correspondences: the scene's landmarks seen from frames 0 and 1,
    # with 0.5 px noise.
    cam = scene.intrinsics
    pix = []
    for f in (0, 1):
        pc = scene.points @ scene.rotations[f].T + scene.translations[f]
        pix.append(np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1))
    noise = np.random.default_rng(0).normal(0.0, 0.5, (2,) + pix[0].shape)
    p1, p2 = (torch.from_numpy(pix[f][:300] + noise[f][:300]) for f in (0, 1))
    u = torch.rand((32, p1.shape[0]), generator=torch.Generator().manual_seed(0))
    ref = estimate_relative_pose(scene.intrinsics, p1, p2, config=config.ransac, uniforms=u)
    gpu = estimate_relative_pose(scene.intrinsics, p1.cuda(), p2.cuda(), config=config.ransac, uniforms=u.cuda())
    pose_diff = float((gpu.rotation.cpu() - ref.rotation).abs().max())
    if not torch.equal(gpu.inliers.cpu(), ref.inliers) or pose_diff > 1e-6:
        raise AssertionError(f"f64 pose: CUDA vs CPU disagree (rotation diff {pose_diff})")

    runs = {dev: run_vo(scene.frames, scene.intrinsics, config, chunk_size=4, device=dev) for dev in ("cuda", "cpu")}
    errs = {}
    for dev, run in runs.items():
        tr = np.einsum("tij,tij->t", run.rotations, scene.rel_rotations)
        err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
        errs[dev] = float(np.median(err[run.success])) if run.success.any() else float("inf")
    same = np.array_equal(runs["cuda"].num_matches, runs["cpu"].num_matches) and np.array_equal(
        runs["cuda"].success, runs["cpu"].success)
    log(f"reference (8x240x160): detector xy diff {xy_diff:.3g}, descriptor bytes equal {desc_same:.4f}; "
        f"f64 pose rotation diff {pose_diff:.3g}; VO matches {runs['cuda'].num_matches.tolist()} vs "
        f"{runs['cpu'].num_matches.tolist()}, median rot err CUDA {errs['cuda']:.3f} / CPU {errs['cpu']:.3f} deg")
    if not same or max(errs.values()) > 1.0:
        raise AssertionError("VO: CUDA and CPU runs disagree on match counts or miss the ground-truth gate")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from slamtpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        log(f"--- nvcc {name} ---")
        for line in text.splitlines():
            if "ptxas" in line or "error" in line.lower():
                log(line)
    log(f"build: {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scene = render()
    log(f"rendered {scene.frames.shape} in {time.perf_counter() - t0:.1f} s")
    card = gpu_name_and_power()
    log(f"device: {torch.cuda.get_device_name(0)} ({card})")

    kernels = kernel_phase(torch, scene.frames)
    launches, vo = vo_phase(torch, scene)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    reference_phase(torch)

    log(json.dumps({"vo": vo, "card": card}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
