#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (slamtpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compiles every kernel under slamtpu_torch/csrc/ (one nvcc per
               source, in parallel) and prints ptxas's register /
               shared-memory summary;
  2. kernels - at the VO chunk's shapes (32 frames, 8 pyramid levels of
               1241x376), holds each kernel against its plain PyTorch version
               on the same CUDA tensors, through both entry points (one
               launch over all levels, and one launch per level): K1's corner
               sets identical and its Harris map bit-identical 4 px in, K2
               bit-exact. Times each kernel per chunk and per level (CUDA
               events around the replay of a CUDA graph of many back-to-back
               launches, divided by their count), its plain version and, where
               one exists, the PyTorch call computing the same function;
               counts K1's compass candidates for its operation bound;
  3. compass - the share of the clip's pixels (all chunks and levels) that
               pass K1's compass pre-test, and that have a FAST score;
  4. vo      - runs slamtpu_torch.pipeline.vo.run_vo with VoConfig() defaults
               on bench.py's clip (257 rendered 1241x376 frames) in chunks of
               32, VO_REPEATS times; checks in every run that each kernel was
               launched once per chunk (9 times); prints the median
               frames/s and the spread; gates pose success >= 0.8 and
               median rotation error <= 1 deg against ground truth; and
               checks the CUDA path against the plain CPU path on a small
               clip;
  5. flagship - runs slamtpu_torch.pipeline.point_cloud.run_point_cloud at
               bench.py's flagship configuration (PointCloudConfig(): 500
               features, keyframes (0.03, 0.03, 0.7, 3), a 16384-slot map,
               BA every 5 keyframes over 5, prune every 10) on the same clip in
               chunks of 32, FLAGSHIP_REPEATS times after a warm-up on a
               33-frame prefix; checks in every run that each kernel was
               launched once per chunk plus once for frame 0 (9 times); gates
               success >= 0.8, BA runs > 0 and orthonormal keyframe
               rotations; requires the runs to agree on keyframes, BA runs and
               the map's ids and validity (and reports their largest pose
               difference); then run_global_ba on the result, gated on an
               error that is finite and not raised;
  6. fused   - runs slamtpu_torch.pipeline.point_cloud.run_point_cloud_fused
               (the program bench.py's flagship metric times) at the same
               configuration on the same clip, FUSED_REPEATS times after a
               warm-up; the host-loop phase's gates, the runs identical, 9
               launches of each kernel per run; the keyframe schedule equal
               to the host loop's and the census within the JAX package's
               fused-vs-host bars (both BA-run counts printed); one BA-off
               phase-2 chunk must make no synchronizing call (run under
               torch.cuda.set_sync_debug_mode, every place that synchronizes
               is printed); the synchronizing calls per run with BA on
               (fused and host loop); peak device memory, and memory back
               within 64 MB of where it was once the result is deleted;
  7. ba       - ba_solve on the card against the CPU at f64: a window-sized
               problem (5 poses, 2048 landmarks, 4096 observations, gather
               mode) and a global-sized one (100 poses, 4096 landmarks, dense
               Schur in chunks of 2048, 2 iterations); times both at f32;
  8. flagship reference - the flagship on the card against the CPU on a
               small clip with the same RANSAC draws and a 30-round polish,
               host loop and fused runner: identical keyframes and BA runs.
Then it prints one JSON line with every kernel's numbers (launches: the
fused flagship run's, equal to the VO and host-loop runs'), the card's
name and power limit (nvidia-smi), and, last, {"ok": true, "device": {...}}.
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
# f32 operations K1's work needs on these inputs: per output pixel, the
# compass pre-test 12 (4 differences, 8 compares), Sobel 14, gradient
# products 3, vertical and horizontal 7-sums of three products 36, Harris 7,
# NMS 8 maxima and 2 compares, select 1; per compass candidate, the full
# FAST score 179 (16 differences, two 9-arc trees of 64 minima or maxima
# and 16 of the other, negation, max, threshold compare).
K1_OPS_PER_PIXEL = 83
K1_OPS_PER_CANDIDATE = 179
N_FRAMES = 257  # bench.py's clip
VO_REPEATS = 5
FLAGSHIP_REPEATS = 3
FUSED_REPEATS = 3
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


def device_ms(torch, fn, inputs, reps: int) -> float:
    """Device time of one call of `fn`: reps x len(inputs) back-to-back calls
    captured into one CUDA graph, CUDA events around its replay, divided by
    the count. A replay runs no host code, so neither the host's launch gaps
    nor its allocations enter the window."""
    fn(inputs[0])  # warm-up: module load and one-time set-up happen outside the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for x in inputs:
                fn(x)
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * len(inputs))


def render():
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    return render_sequence(
        n_frames=N_FRAMES, height=HEIGHT, width=WIDTH, n_points=4000, step=0.8,
        intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0,
    )


def kernel_phase(torch, frames):
    """K1 and K2 against their plain versions at the VO chunk's shapes, then
    their device times per level and per chunk."""
    from slamtpu_torch.feature.detector import OrbConfig, _select_level, features_per_level
    from slamtpu_torch.ops.brief import PATCH_RADIUS
    from slamtpu_torch.ops.corner import (
        corner_response,
        corner_response_levels,
        corner_response_levels_plain,
        corner_response_plain,
    )
    from slamtpu_torch.ops.fast import fast_candidates
    from slamtpu_torch.ops.patch import (
        extract_patches_batched,
        extract_patches_levels,
        extract_patches_levels_plain,
        extract_patches_plain,
    )
    from slamtpu_torch.ops.pyramid import build_pyramid, gaussian_blur

    cfg = OrbConfig()
    quotas = features_per_level(cfg.max_features, cfg.n_levels, cfg.scale_factor)
    subpix = [lv <= cfg.subpixel_max_octave for lv in range(cfg.n_levels)]
    thr = cfg.fast_threshold
    base = torch.as_tensor(frames[:CHUNK]).cuda().float()
    # Distinct inputs for timing: the same frames under small intensity shifts.
    variants = [[x.contiguous() for x in build_pyramid(base + 0.25 * i, cfg.n_levels, cfg.scale_factor)]
                for i in range(5)]
    levels = variants[0]
    launches_before = (corner_response.launches, extract_patches_batched.launches)

    # --- K1 agreement: one launch over all levels, and the per-level entry --
    ranked, harris = corner_response_levels(levels, thr, with_harris=True)
    k1_err, starts, blurred = 0.0, [], []
    m = 4  # the kernel clamps its halo where the plain version wraps: Harris differs only within 4 px
    for lv, img in enumerate(levels):
        rk, hk = corner_response(img, thr, with_harris=True)
        rn = corner_response(img, thr, with_harris=False)
        rp, hp = corner_response_plain(img, thr, with_harris=True)
        torch.cuda.synchronize()
        fk, fp = torch.isfinite(ranked[lv]), torch.isfinite(rp)
        n_diff = int((fk != fp).sum())
        if n_diff or not (torch.equal(rk, rn) and torch.equal(rk, ranked[lv]) and torch.equal(hk, harris[lv])):
            raise AssertionError(f"K1 level {lv}: corner sets differ at {n_diff} pixels, or the entry points differ")
        inner = (slice(None), slice(m, -m), slice(m, -m))
        err = float((harris[lv][inner] - hp[inner]).abs().max())
        if not torch.equal(harris[lv][inner], hp[inner]) or not torch.equal(ranked[lv][inner], rp[inner]):
            raise AssertionError(f"K1 level {lv}: Harris not bit-identical {m} px in (max abs err {err})")
        k1_err = max(k1_err, err)
        log(f"K1 level {lv} {tuple(img.shape)}: {int(fk.sum())} corners, identical sets, "
            f"Harris max abs err {err} ({m} px in)")
        xy_int = _select_level(ranked[lv], quotas[lv], cfg.edge_threshold, harris[lv] if subpix[lv] else None)[0]
        starts.append((torch.round(xy_int).to(torch.int32) - PATCH_RADIUS).contiguous())
        blurred.append(gaussian_blur(img))

    # --- K2 agreement ----------------------------------------------------------
    pk = extract_patches_levels(blurred, starts, PATCH_RADIUS)
    pp = extract_patches_levels_plain(blurred, starts, PATCH_RADIUS)
    k2_err = float((pk - pp).abs().max())
    if not torch.equal(pk, pp):
        raise AssertionError("K2: windows differ from the plain version")
    for lv, (img, st) in enumerate(zip(blurred, starts)):
        if not torch.equal(extract_patches_batched(img, st, PATCH_RADIUS), extract_patches_plain(img, st, PATCH_RADIUS)):
            raise AssertionError(f"K2 level {lv}: windows differ from the plain version")
    log(f"K2: {tuple(pk.shape)} windows of all levels bit-identical to the plain version (max abs err {k2_err})")

    # --- timing -----------------------------------------------------------------
    blurred_variants = [[gaussian_blur(img) for img in pyr] for pyr in variants]
    size = 2 * PATCH_RADIUS + 1

    def gather_lib(blur):
        for img, st in zip(blur, starts):
            b, h, w = img.shape
            x0 = st[..., 0].clamp(0, w - size).long()
            y0 = st[..., 1].clamp(0, h - size).long()
            r = torch.arange(size, device=img.device)
            bi = torch.arange(b, device=img.device)[:, None, None, None]
            img[bi, (y0[..., None] + r)[..., :, None], (x0[..., None] + r)[..., None, :]]

    times = dict(
        k1=device_ms(torch, lambda p: corner_response_levels(p, thr, subpix), variants, reps=4),
        k1_levels=[device_ms(torch, lambda p, lv=lv: corner_response(p[lv], thr, subpix[lv]), variants, reps=4)
                   for lv in range(cfg.n_levels)],
        k1_plain=time_ms(torch, lambda p: corner_response_levels_plain(p, thr, subpix), variants[:3]),
        k2=device_ms(torch, lambda bl: extract_patches_levels(bl, starts, PATCH_RADIUS), blurred_variants, reps=10),
        k2_levels=[device_ms(torch, lambda bl, lv=lv: extract_patches_batched(bl[lv], starts[lv], PATCH_RADIUS),
                             blurred_variants, reps=10) for lv in range(cfg.n_levels)],
        k2_plain=time_ms(torch, lambda bl: extract_patches_levels_plain(bl, starts, PATCH_RADIUS),
                         blurred_variants[:3]),
        k2_lib=device_ms(torch, gather_lib, blurred_variants, reps=4),
    )
    # Comparison and timing launches do not count as main-path launches.
    corner_response.launches, extract_patches_batched.launches = launches_before

    # --- bounds from this run's shapes and data ----------------------------------
    px = sum(img.numel() for img in levels)
    px_harris = sum(img.numel() for lv, img in enumerate(levels) if subpix[lv])
    n_cand = sum(int(fast_candidates(img, thr).sum()) for img in levels)
    k1_bytes = 4 * (2 * px + px_harris)
    k1_ops = K1_OPS_PER_PIXEL * px + K1_OPS_PER_CANDIDATE * n_cand
    k2_write = pk.numel() * 4
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
    k1_bytes_ms, k1_ops_ms = k1_bytes / HBM_BYTES_PER_S * 1e3, k1_ops / FP32_FLOP_PER_S * 1e3
    k1_bound = max(k1_bytes_ms, k1_ops_ms)
    k2_bound = (k2_read + k2_write) / HBM_BYTES_PER_S * 1e3
    log(f"K1 per chunk: one launch {times['k1']:.4f} ms; per-level launches "
        f"{[round(t, 4) for t in times['k1_levels']]} (sum {sum(times['k1_levels']):.4f} ms); plain "
        f"{times['k1_plain']:.4f} ms; bound {k1_bound:.4f} ms by "
        f"{'operations' if k1_ops_ms > k1_bytes_ms else 'bytes'} (bytes {k1_bytes / 1e6:.1f} MB = "
        f"{k1_bytes_ms:.4f} ms; operations {k1_ops / 1e9:.3f} GFLOP = {k1_ops_ms:.4f} ms: {px} px, "
        f"{n_cand} compass candidates = {n_cand / px:.4f} of pixels)")
    log(f"K2 per chunk: one launch {times['k2']:.4f} ms; per-level launches "
        f"{[round(t, 4) for t in times['k2_levels']]} (sum {sum(times['k2_levels']):.4f} ms); plain "
        f"{times['k2_plain']:.4f} ms; gather {times['k2_lib']:.4f} ms; bound {k2_bound:.4f} ms "
        f"({(k2_read + k2_write) / 1e6:.1f} MB)")
    return [
        dict(name="corner_response", route="cuda", source="slamtpu_torch/csrc/corner_response.cu",
             replaces="slamtpu/ops/pallas_corner.py:165", launches=None, max_abs_err=k1_err,
             ms=times["k1"], plain_ms=times["k1_plain"], bound_ms=k1_bound,
             bound_by="operations" if k1_ops_ms > k1_bytes_ms else "bytes", library_ms=None),
        dict(name="extract_patches_batched", route="cuda", source="slamtpu_torch/csrc/extract_patches.cu",
             replaces="slamtpu/ops/pallas_patch.py:80", launches=None, max_abs_err=k2_err,
             ms=times["k2"], plain_ms=times["k2_plain"], bound_ms=k2_bound, bound_by="bytes",
             library_ms=times["k2_lib"]),
    ], times


def compass_phase(torch, frames):
    """Share of the clip's pixels (all chunks, all levels) that pass K1's
    compass pre-test, and of those with a FAST score."""
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.ops.fast import fast_candidates, fast_score
    from slamtpu_torch.ops.pyramid import build_pyramid

    cfg = OrbConfig()
    px = cand = scored = 0
    for start in range(0, len(frames), CHUNK):
        chunk = torch.as_tensor(frames[start : start + CHUNK]).cuda().float()
        for img in build_pyramid(chunk, cfg.n_levels, cfg.scale_factor):
            px += img.numel()
            cand += int(fast_candidates(img, cfg.fast_threshold).sum())
            scored += int((fast_score(img, cfg.fast_threshold) > 0).sum())
    if scored > cand:
        raise AssertionError("more pixels have a FAST score than pass the compass pre-test")
    log(f"compass pre-test on the clip ({len(frames)} frames, {cfg.n_levels} levels, {px} px): "
        f"{cand} candidates = {cand / px:.4f} of pixels; FAST score > 0 at {scored} = {scored / px:.4f}")
    return dict(pixels=px, candidates=cand, candidate_share=cand / px, scored=scored, scored_share=scored / px)


def vo_phase(torch, scene):
    """The main path: run_vo on the card at full width, gated on ground truth."""
    import numpy as np

    from slamtpu_torch.ops.corner import corner_response
    from slamtpu_torch.ops.patch import extract_patches_batched
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo

    config = VoConfig()
    run_vo(scene.frames[: CHUNK + 1], scene.intrinsics, config, chunk_size=CHUNK, device="cuda")  # warm-up

    elapsed, launches = [], None
    n_chunks = -(-N_FRAMES // CHUNK)
    for _ in range(VO_REPEATS):
        corner_response.launches = 0
        extract_patches_batched.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_vo(scene.frames, scene.intrinsics, config, chunk_size=CHUNK, seed=0, device="cuda")
        elapsed.append(time.perf_counter() - t0)
        counts = {"corner_response": corner_response.launches,
                  "extract_patches_batched": extract_patches_batched.launches}
        _check_launches(counts, n_chunks, "the VO run")
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


def _check_launches(counts: dict, expected: int, what: str) -> None:
    for name, n in counts.items():
        if n != expected:
            raise AssertionError(f"{what} launched kernel {name} {n} times, not {expected}")


def _drive_flagship(torch, scene, runner, repeats: int, what: str):
    """`repeats` timed runs of a flagship runner at bench.py's flagship
    configuration after a warm-up on a 33-frame prefix: 9 launches of each
    kernel per run, bench.py's gates, the runs identical. Returns (first
    result, launches per run, summary)."""
    import numpy as np

    from slamtpu_torch.ops.corner import corner_response
    from slamtpu_torch.ops.patch import extract_patches_batched
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig

    config = PointCloudConfig()  # == bench.py:687-695
    runner(scene.frames[: CHUNK + 1], scene.intrinsics, config, chunk_size=CHUNK, device="cuda")  # warm-up
    n_pairs = N_FRAMES - 1
    expected = -(-n_pairs // CHUNK) + 1  # one launch per chunk, one for frame 0
    elapsed, runs, launches = [], [], None
    for _ in range(repeats):
        corner_response.launches = 0
        extract_patches_batched.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runner(scene.frames, scene.intrinsics, config, chunk_size=CHUNK, seed=0, device="cuda")
        torch.cuda.synchronize()
        elapsed.append(time.perf_counter() - t0)
        counts = {"corner_response": corner_response.launches,
                  "extract_patches_batched": extract_patches_batched.launches}
        _check_launches(counts, expected, f"the {what} run")
        launches = counts
        runs.append(res)

    res = runs[0]
    n_kf = len(res.keyframe_frame_idx)
    success = res.successful_frames / n_pairs
    rot = res.keyframe_rotations.astype(np.float64)
    ortho = float(np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max())
    valid = res.map_state.valid
    stable = int((valid & (res.map_state.observations >= config.min_observations)).sum())
    pose_diff = 0.0
    for other in runs[1:]:
        same = (np.array_equal(other.keyframe_frame_idx, res.keyframe_frame_idx) and other.ba_runs == res.ba_runs
                and torch.equal(other.map_state.ids, res.map_state.ids)
                and torch.equal(other.map_state.valid, res.map_state.valid))
        if not same:
            raise AssertionError(f"two {what} runs disagree on keyframes, BA runs or the map's ids/validity")
        pose_diff = max(pose_diff, float(np.abs(other.keyframe_rotations - res.keyframe_rotations).max()),
                        float(np.abs(other.keyframe_translations - res.keyframe_translations).max()))
    fps = sorted(n_pairs / e for e in elapsed)
    kfs = sorted(n_kf / e for e in elapsed)
    log(f"{what}: {N_FRAMES} frames {WIDTH}x{HEIGHT}, {repeats} runs in {[round(e, 4) for e in elapsed]} s "
        f"-> median {statistics.median(fps):.2f} frames/s (min {fps[0]:.2f}, max {fps[-1]:.2f}; frame pairs over "
        f"wall time, as bench.py counts), {statistics.median(kfs):.2f} keyframes/s (min {kfs[0]:.2f}, max "
        f"{kfs[-1]:.2f}); {n_kf} keyframes, {res.ba_runs} BA runs, landmarks {int(valid.sum())} valid / {stable} "
        f"stable, {len(res.observations[0])} logged observations; success {success:.4f}; rotations orthonormal "
        f"to {ortho:.2e}; largest pose difference between runs {pose_diff}; launches per run {launches}")
    if success < 0.8 or res.ba_runs == 0 or not np.isfinite(rot).all() or ortho > 1e-4:
        raise AssertionError(f"{what} gates failed: success {success} (>= 0.8), BA runs {res.ba_runs} (> 0), "
                             f"orthonormality {ortho} (<= 1e-4)")
    return res, launches, dict(
        frames=N_FRAMES, fps_median=statistics.median(fps), fps_min=fps[0], fps_max=fps[-1],
        kf_per_s_median=statistics.median(kfs), kf_per_s_min=kfs[0], kf_per_s_max=kfs[-1], elapsed_s=elapsed,
        keyframes=n_kf, ba_runs=res.ba_runs, landmarks=int(valid.sum()), stable_landmarks=stable,
        observations=len(res.observations[0]), success_rate=success, pose_diff_between_runs=pose_diff)


def flagship_phase(torch, scene):
    """The host loop run_point_cloud on the card at bench.py's flagship
    configuration, then run_global_ba on its result."""
    import numpy as np

    from slamtpu_torch.pipeline.point_cloud import run_global_ba, run_point_cloud

    res, launches, summary = _drive_flagship(torch, scene, run_point_cloud, FLAGSHIP_REPEATS, "flagship")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, err_before, err_after = run_global_ba(res, scene.intrinsics, device="cuda")
    torch.cuda.synchronize()
    global_s = time.perf_counter() - t0
    log(f"global BA over {summary['keyframes']} keyframes: {global_s:.4f} s, error {err_before} -> {err_after}")
    if not (np.isfinite(err_after) and err_after <= err_before):
        raise AssertionError(f"global BA raised the error or gave a non-finite one: {err_before} -> {err_after}")
    return res, launches, dict(summary, global_ba_s=global_s, global_err_before=err_before, global_err_after=err_after)


def _sync_calls(torch, fn):
    """Where `fn` makes synchronizing CUDA calls: a Counter of "file:line"
    of the Python frame that made each (torch.cuda.set_sync_debug_mode
    "warn" warns once per call)."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                               if "synchroniz" in str(w.message) and "prototype" not in str(w.message))


def fused_phase(torch, scene, host):
    """The fused flagship run_point_cloud_fused (bench.py's flagship metric):
    the host-loop phase's gates and run-to-run identity, then against the
    host loop's result `host`, host syncs and device memory."""
    import gc

    import numpy as np

    from slamtpu_torch.pipeline import point_cloud as pc
    from slamtpu_torch.pipeline.vo import vo_frontend

    res, launches, summary = _drive_flagship(torch, scene, pc.run_point_cloud_fused, FUSED_REPEATS, "fused flagship")

    # Against the host loop: the same frontend gives the same schedule; the
    # census within the JAX package's fused-vs-host bars
    # (tests/test_point_cloud.py). BA counts are printed, not gated: the
    # fused runner counts a window as run when its ring holds an
    # observation, the host loop when one still holds its landmark.
    census = {name: (int(r.map_state.valid.sum()), len(r.observations[0])) for name, r in (("fused", res),
                                                                                            ("host", host))}
    (n_f, o_f), (n_h, o_h) = census["fused"], census["host"]
    log(f"fused vs host loop: keyframes identical {np.array_equal(res.keyframe_frame_idx, host.keyframe_frame_idx)}; "
        f"landmarks {n_f} vs {n_h}, observations {o_f} vs {o_h}; BA runs {res.ba_runs} vs {host.ba_runs} "
        f"(difference {res.ba_runs - host.ba_runs})")
    if not np.array_equal(res.keyframe_frame_idx, host.keyframe_frame_idx):
        raise AssertionError("the fused runner's keyframe schedule differs from the host loop's")
    if abs(n_f - n_h) > max(3, 0.02 * n_h) or abs(o_f - o_h) > 0.05 * o_h:
        raise AssertionError(f"fused vs host-loop census outside max(3, 2 %) landmarks / 5 % observations: {census}")

    # One BA-off phase-2 chunk must make no synchronizing call; is_kf is
    # handed in as host data, as the runner reads it once per chunk.
    config = pc.PointCloudConfig(ba_interval=0)
    feats0 = pc._first_features(scene.frames, config, torch.device("cuda"))
    carry2 = pc._fused_carry_init(config, feats0, torch.float32)
    carry1 = (feats0, pc.KeyframeState.initial("cuda"), torch.eye(4, dtype=torch.float64, device="cuda"))
    block = torch.as_tensor(scene.frames[1 : CHUNK + 1]).cuda()
    _, fres, feats = vo_frontend(*carry1, block, scene.intrinsics, config.vo, first_step=1)
    is_kf = fres.is_keyframe.cpu().numpy()
    where = _sync_calls(torch, lambda: pc._fused_phase2_chunk(carry2, feats, fres.rotations, fres.translations, is_kf,
                                                              scene.intrinsics, config))
    log(f"one BA-off phase-2 chunk ({int(is_kf.sum())} keyframes of {CHUNK} steps, prune steps included): "
        f"synchronizing calls {dict(where) or 'none'} (torch.cuda.set_sync_debug_mode)")
    if where:
        raise AssertionError(f"a BA-off phase-2 chunk made synchronizing calls: {dict(where)}")

    cfg = pc.PointCloudConfig()
    syncs = {name: _sync_calls(torch, lambda fn=fn: fn(scene.frames, scene.intrinsics, cfg, chunk_size=CHUNK,
                                                       device="cuda"))
             for name, fn in (("fused", pc.run_point_cloud_fused), ("host", pc.run_point_cloud))}
    log(f"synchronizing calls per run with BA on: fused {sum(syncs['fused'].values())}, host loop "
        f"{sum(syncs['host'].values())} ({summary['keyframes']} keyframes, {res.ba_runs} / {host.ba_runs} BA runs); "
        f"by place: fused {dict(syncs['fused'].most_common(12))}; host loop {dict(syncs['host'].most_common(12))}")
    syncs = {name: sum(c.values()) for name, c in syncs.items()}

    # Device memory of one run, and none left behind once the result goes.
    del res
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = pc.run_point_cloud_fused(scene.frames, scene.intrinsics, cfg, chunk_size=CHUNK, seed=0, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    log(f"fused run device memory: peak {peak / 2**20:.1f} MiB allocated ({(peak - before) / 2**20:.1f} MiB above "
        f"the {before / 2**20:.1f} MiB held before the run); {left / 2**20:.3f} MiB left once the result is deleted")
    if left > 64 * 2**20:
        raise AssertionError(f"the fused run left {left / 2**20:.1f} MiB allocated (bar 64 MiB)")
    return launches, dict(summary, census=census, host_ba_runs=host.ba_runs, sync_calls_per_run=syncs,
                          peak_allocated_mib=peak / 2**20, peak_above_start_mib=(peak - before) / 2**20,
                          left_after_delete_mib=left / 2**20)


def _ba_problem(torch, n_poses, n_points, per_point, seed, dtype, device):
    """A seeded BA problem: each landmark seen by `per_point` consecutive
    poses (once each), 0.5 px noise, a perturbed start; the first two poses
    are frozen as the flagship's anchors."""
    import numpy as np

    from slamtpu_torch.mapping.bundle_adjustment import ObservationBatch
    from slamtpu_torch.ops.lie import so3_exp

    rng = np.random.default_rng(seed)
    gt = np.stack([rng.uniform(-2, 2 + 0.4 * n_poses, n_points), rng.uniform(-1.5, 1.5, n_points),
                   rng.uniform(6, 12, n_points)], 1)
    rots = so3_exp(torch.from_numpy(rng.normal(scale=0.02, size=(n_poses, 3)))).numpy()
    trans = np.stack([[-0.4 * i, 0.0, 0.0] for i in range(n_poses)]) + rng.normal(scale=0.02, size=(n_poses, 3))
    first = rng.integers(0, n_poses - per_point + 1, n_points)
    kf = np.concatenate([first + d for d in range(per_point)])
    pt = np.tile(np.arange(n_points), per_point)
    pc = np.einsum("mij,mj->mi", rots[kf], gt[pt]) + trans[kf]
    px = np.stack([500.0 * pc[:, 0] / pc[:, 2] + 320.0, 500.0 * pc[:, 1] / pc[:, 2] + 240.0], 1)
    px += rng.normal(scale=0.5, size=px.shape)
    start = [so3_exp(torch.from_numpy(rng.normal(scale=0.003, size=(n_poses, 3)))).numpy() @ rots,
             trans + rng.normal(scale=0.01, size=trans.shape), gt + rng.normal(scale=0.05, size=gt.shape)]
    obs = ObservationBatch(torch.from_numpy(kf).to(device), torch.from_numpy(pt).to(device),
                           torch.from_numpy(px).to(device=device, dtype=dtype),
                           torch.ones(len(kf), dtype=torch.bool, device=device))
    mask = torch.ones(n_poses, dtype=torch.bool, device=device)
    mask[:2] = False
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in start], obs, mask


def ba_phase(torch):
    """ba_solve on the card against the CPU at f64 (window and global
    sizes), then the card's time per solve at f32."""
    from slamtpu_torch.mapping.bundle_adjustment import BaConfig, ba_solve
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    cam = CameraIntrinsics(500.0, 500.0, 320.0, 240.0)
    cases = dict(
        window=dict(shape=(5, 2048, 2), kw=dict(segment_method="gather", gather_k_pt=5), cpu_kw={}),
        # 100 poses x 4096 landmarks; CUDA "auto" counts the observer bound
        # and takes the gather mode; the CPU takes the scatter path.
        global_=dict(shape=(100, 4096, 4), kw=dict(landmark_chunk=2048, config=BaConfig(max_iterations=2)),
                     cpu_kw=dict(landmark_chunk=2048, config=BaConfig(max_iterations=2))),
    )
    out = {}
    for name, case in cases.items():
        (start, obs, mask) = _ba_problem(torch, *case["shape"], seed=1, dtype=torch.float64, device="cpu")
        t0 = time.perf_counter()
        ref = ba_solve(cam, *start, obs, fix_first_pose=False, pose_mask=mask, **case["cpu_kw"])
        cpu_s = time.perf_counter() - t0
        gstart, gobs, gmask = _ba_problem(torch, *case["shape"], seed=1, dtype=torch.float64, device="cuda")
        got = ba_solve(cam, *gstart, gobs, fix_first_pose=False, pose_mask=gmask, **case["kw"])
        scale = max(float(ref[2].abs().max()), 1.0)
        diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(got[:3], ref[:3])) / scale
        err_rel = abs(float(got[3]) - float(ref[3])) / float(ref[3])
        if got[4] != ref[4] or diff > 1e-8 or err_rel > 1e-8:
            raise AssertionError(f"BA {name}: CUDA vs CPU at f64 disagree (iterations {got[4]} vs {ref[4]}, "
                                 f"state {diff:.3g}, error {err_rel:.3g}; tolerance 1e-8 relative)")
        # The card's time at f32, CUDA events around REPS solves.
        fstart, fobs, fmask = _ba_problem(torch, *case["shape"], seed=1, dtype=torch.float32, device="cuda")
        solve = lambda: ba_solve(cam, *fstart, fobs, fix_first_pose=False, pose_mask=fmask, **case["kw"])  # noqa: E731
        iters = solve()[4]
        reps = 10 if name == "window" else 3
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(reps):
            solve()
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1) / reps
        n_obs = int(obs.mask.sum())
        log(f"BA {name.rstrip('_')} ({case['shape'][0]} poses, {case['shape'][1]} landmarks, {n_obs} observations): "
            f"CUDA vs CPU at f64: {got[4]} iterations each, state diff {diff:.3g} (relative to the largest "
            f"coordinate), error diff {err_rel:.3g} (tolerance 1e-8); error {float(ref[3]):.6g}; CPU f64 solve "
            f"{cpu_s * 1e3:.1f} ms; card f32 {ms:.3f} ms per solve ({iters} iterations)")
        out[name.rstrip("_")] = dict(poses=case["shape"][0], landmarks=case["shape"][1], observations=n_obs,
                                     f64_state_diff=diff, f64_err_diff=err_rel, iterations=got[4],
                                     f32_ms_per_solve=ms, f32_iterations=iters, cpu_f64_ms=cpu_s * 1e3)
    return out


def flagship_reference_phase(torch):
    """The flagship on the card against the CPU on a small clip with the
    same RANSAC draws and a 30-round polish: the fused runner, then the
    host loop."""
    import numpy as np

    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.ops.ransac import RansacConfig
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig, run_point_cloud, run_point_cloud_fused
    from slamtpu_torch.pipeline.vo import VoConfig

    scene = render_sequence(n_frames=17, height=160, width=200, n_points=600, step=0.3, seed=8, textured=True)
    config = PointCloudConfig(vo=VoConfig(orb=OrbConfig(max_features=96, n_levels=4),
                                          ransac=RansacConfig(iters=16, min_solver="5pt", refine_rounds=30),
                                          keyframe=PointCloudConfig().vo.keyframe), map_capacity=2048)
    draws = torch.rand((16, 16, 96), generator=torch.Generator().manual_seed(0))
    fused = {dev: run_point_cloud_fused(scene.frames, scene.intrinsics, config, chunk_size=8, device=dev,
                                        uniforms=draws.to(dev)) for dev in ("cuda", "cpu")}
    log(f"fused flagship reference (17x200x160): keyframes identical "
        f"{np.array_equal(fused['cuda'].keyframe_frame_idx, fused['cpu'].keyframe_frame_idx)}, BA runs "
        f"{fused['cuda'].ba_runs} / {fused['cpu'].ba_runs}; landmarks / logged observations CUDA "
        f"{(int(fused['cuda'].map_state.valid.sum()), len(fused['cuda'].observations[0]))} vs CPU "
        f"{(int(fused['cpu'].map_state.valid.sum()), len(fused['cpu'].observations[0]))}")
    if (not np.array_equal(fused["cuda"].keyframe_frame_idx, fused["cpu"].keyframe_frame_idx)
            or fused["cuda"].ba_runs != fused["cpu"].ba_runs):
        raise AssertionError("fused flagship: CUDA and CPU runs disagree on keyframes or BA runs")
    runs = {dev: run_point_cloud(scene.frames, scene.intrinsics, config, chunk_size=8, device=dev,
                                 uniforms=draws.to(dev)) for dev in ("cuda", "cpu")}
    g, c = runs["cuda"], runs["cpu"]
    census = {dev: (int(r.map_state.valid.sum()), len(r.observations[0])) for dev, r in runs.items()}
    dr = float(np.abs(g.keyframe_rotations - c.keyframe_rotations).max()) if len(g.keyframe_rotations) == len(
        c.keyframe_rotations) else float("inf")
    dt = float(np.abs(g.keyframe_translations - c.keyframe_translations).max()) if np.isfinite(dr) else float("inf")
    log(f"flagship reference (17x200x160): keyframes {g.keyframe_frame_idx.tolist()} (CPU identical: "
        f"{np.array_equal(g.keyframe_frame_idx, c.keyframe_frame_idx)}), BA runs {g.ba_runs} / {c.ba_runs}, "
        f"successes {g.successful_frames} / {c.successful_frames}; landmarks / logged observations CUDA "
        f"{census['cuda']} vs CPU {census['cpu']}; keyframe pose differences: rotation {dr:.3g}, translation {dt:.3g}")
    if not np.array_equal(g.keyframe_frame_idx, c.keyframe_frame_idx) or g.ba_runs != c.ba_runs:
        raise AssertionError("flagship: CUDA and CPU runs disagree on keyframes or BA runs")
    return dict(census=census, rot_diff=dr, trans_diff=dt)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from slamtpu_torch import _build

    t_start = t0 = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        log(f"--- nvcc {name} ---")
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line or "error" in line.lower():
                log(line)
    log(f"build: {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scene = render()
    log(f"rendered {scene.frames.shape} in {time.perf_counter() - t0:.1f} s")
    card = gpu_name_and_power()
    log(f"device: {torch.cuda.get_device_name(0)} ({card})")

    kernels, times = kernel_phase(torch, scene.frames)
    compass = compass_phase(torch, scene.frames)
    vo_launches, vo = vo_phase(torch, scene)
    reference_phase(torch)
    host, host_launches, flagship = flagship_phase(torch, scene)
    launches, fused = fused_phase(torch, scene, host)
    del host
    paths = {"vo": vo_launches, "flagship": host_launches, "fused_flagship": launches}
    if not all(counts == vo_launches for counts in paths.values()):
        raise AssertionError(f"the main paths launched the kernels differently: {paths}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    ba = ba_phase(torch)
    flagship_ref = flagship_reference_phase(torch)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the kernels' build included")
    log(json.dumps({"vo": vo, "flagship": flagship, "fused_flagship": fused, "ba": ba,
                    "flagship_reference": flagship_ref, "compass": compass, "kernel_times_ms": times,
                    "launches_by_path": paths, "card": card}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
