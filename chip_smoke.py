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
               bit-exact, also with the raw levels' windows in the same
               launch (descriptor_bins=0). Times each kernel per chunk and
               per level (CUDA events around the replay of a CUDA graph of
               many back-to-back launches, divided by their count), K2's
               16-level launch, its plain version and, where
               one exists, the PyTorch call computing the same function;
               counts K1's compass candidates for its operation bound;
               the 5-point null space kernel (csrc/nullspace4.cu) against
               torch.linalg.qr at the vo-clip257 and vo-batch4 chunks'
               shapes (32 x 64 and 4 x 32 x 64 systems), timed the same way
               beside the library QR, with its bound;
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
               host loop and fused runner: identical keyframes and BA runs;
  9. depth   - MonoDepth2 at bench.py's configuration (random weights from a
               seed, 640x192, scale-0 disparity, fed three distinct clips of
               the rendered clip's frames from frame 1, gray repeated to RGB,
               one warm-up): ms/frame (median, min, max) at f32 (TF32 off)
               and bf16, at batch 8 (bench.py's) and 64 (the CLI's default);
               GFLOP/frame counted from the convolutions' shapes, TFLOP/s
               against the card's peaks, peak memory at batch 64; gates on
               the output (shape, finite, inside (0, 1)), bf16 against f32
               (max |d| < 0.05, correlation > 0.97) and the card against the
               CPU on one full-size frame (atol 5e-4); then run_depth_mapping
               on the 257-frame clip with the CLI's --fuse-vo depth function
               (stride 8, keyframe stride 2): 9 launches of each kernel, a
               finite non-empty cloud, VO success >= 0.8; and on a small
               rendered clip with its true depth maps, median relative error
               of the cloud < 0.15 (tests/test_depth_mapping.py's bar);
 10. cli     - writes the clip as a KITTI odometry sequence directory
               (image_0/%06d.png by a stdlib zlib writer, calib.txt,
               times.txt at 10 Hz, a camera-to-world poses.txt) and reads it
               back through load_frames and the native loader, byte-exact,
               with its decode rate; drives the CLIs in-process on it: the
               VO CLI at its defaults (1000 features, chunk 32, seed 0;
               trajectory equal to a direct run_vo, printed ATE equal to
               evaluate.ate_rmse, 9 launches of each kernel), the
               point-cloud CLI at its defaults (3000 features, a 65536-slot
               map, --global-ba, --checkpoint) fused and as the host loop
               (artifacts written, BA runs > 0, identical keyframes,
               landmarks within max(3, 2 %) and observations within 5 %, the
               host log capped at the fused runner's 1024 a keyframe; 9
               launches each), the BA demo (error lowered), cli.main and
               visualize_features (9 launches each); then the RANSAC draws
               of one seed bit-identical on the card and the CPU, StepTimer
               around run_vo, and a non-empty profile_trace.
 11. vo_options - on the same clip, run_vo (chunk 32, seed 0) with each VO
               option in turn: refine_matches, the homography fallback,
               the IRLS refit, prescore_subset=128, descriptor_bins=0
               (continuous BRIEF: raw and blurred windows in one K2
               launch) and VoConfig.robust(); each OPTION_REPEATS
               times with the VO gates and 9 launches of each kernel per
               run, median frames/s; then run_vo_batched on 4 windows of
               128 frames (offsets 0, 43, 86, 129): one launch of each
               kernel a chunk for all four, each sequence equal to run_vo
               of its window at seed + b (success, matches, keyframes;
               rotations within 1e-5) and gated; then one pair through the
               root package's OrbDetector, PoseEstimator and
               KeyframeSelector (a finite pose, >= 8 inliers).
 12. parallel - the multi-device layer (slamtpu_torch/parallel/). One NCCL
               rank (initialize_multihost(), make_mesh() -> (1, 1)):
               sharded_vo_step on the clip against run_vo in turns
               (success, matches, keyframes, rotations and translations
               identical, positions within 1e-5 relative; the VO gates; 9
               launches of each kernel), run_point_cloud_sharded against
               run_point_cloud_fused (keyframes, BA runs and successful
               frames identical, landmarks within max(15, 15 %)) and
               run_point_cloud_batched with B = 1 against the sharded
               runner (identical), 9 launches each, frames/s of each.
               Then PARALLEL_RANKS Gloo ranks sharing the card
               (torch.multiprocessing, spawn): on the clip's first 256
               frames, each rank's block of sharded_vo_step on a (1, 4)
               mesh against run_vo (success, matches, keyframes identical;
               rotations within 1e-5, positions within 1e-4 relative; 2
               launches a rank); run_point_cloud_batched on a (2, 2) mesh
               over frames 0-127 and 129-256 (seeds 0 and 1) against
               run_point_cloud_fused of each at the bars above; the wall
               time and rank 0's collectives (host clock around each).
Then it prints one JSON line with every kernel's numbers (launches: the
fused flagship run's, equal to those of every other path: VO, host-loop,
depth mapping, the CLIs and every VO option; the parallel paths' counts
are in it too, held to their own),
the card's name and power limit (nvidia-smi), and, last, {"ok": true,
"device": {...}}.
Exits non-zero without a CUDA device or without the slamtpu_torch package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
# f32 operations K1's work needs on these inputs: per output pixel, the
# compass pre-test 12 (4 differences, 8 compares), Sobel 14, gradient
# products 3, vertical and horizontal 7-sums of three products 36, Harris 7,
# NMS 8 maxima and 2 compares, select 1; per compass candidate, the full
# FAST score 179 (16 differences, two 9-arc trees of 64 minima or maxima
# and 16 of the other, negation, max, threshold compare).
K1_OPS_PER_PIXEL = 83
K1_OPS_PER_CANDIDATE = 179
# The null space kernel, per 5x9 system (an FMA counted as two): 45 products
# to build A^T, 440 operations of Householder QR, 150 for the block
# reflector's T, 380 to form Q's last four columns; f32 bytes in (two [5, 2]
# samples) and out (a [4, 3, 3] basis).
NULLSPACE_OPS_PER_SYSTEM = 1015
NULLSPACE_BYTES_PER_SYSTEM = 80 + 144
NULLSPACE_CHUNKS = {"vo-clip257": (32, 64), "vo-batch4": (4, 32, 64)}  # hypotheses of one pose chunk
N_FRAMES = 257  # bench.py's clip
VO_REPEATS = 5
OPTION_REPEATS = 3
BATCH_OFFSETS = (0, 43, 86, 129)  # run_vo_batched's four windows of the clip
BATCH_FRAMES = 128
FLAGSHIP_REPEATS = 3
FUSED_REPEATS = 3
DEPTH_BATCHES = (8, 64)  # bench.py's, the CLI's default on CUDA
CHUNK = 32
PARALLEL_RANKS = 4
PARALLEL_FRAMES = 256  # the four-rank VO: rank r's 64 frames are run_vo's chunks 2r and 2r + 1
PARALLEL_CLIPS = ((0, 128), (129, 257))  # the four-rank batched flagship's clips, at seeds 0 and 1
PARALLEL_TIMEOUT_S = 600
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
    """bench.py's clip, through the port's disk cache (.scene_cache): a
    second run on the same machine reloads it instead of rendering."""
    from slamtpu_torch.io.synthetic import render_sequence_cached
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    return render_sequence_cached(
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
    # descriptor_bins=0 adds the raw levels' windows to the same launch (16 levels).
    if not torch.equal(extract_patches_levels(levels + blurred, starts + starts, PATCH_RADIUS),
                       extract_patches_levels_plain(levels + blurred, starts + starts, PATCH_RADIUS)):
        raise AssertionError("K2: the 16-level launch (raw and blurred windows) differs from the plain version")
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
        k2_raw_and_blurred=device_ms(torch, lambda vb: extract_patches_levels(vb[0] + vb[1], starts + starts,
                                                                              PATCH_RADIUS),
                                     list(zip(variants, blurred_variants)), reps=10),
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
        f"({(k2_read + k2_write) / 1e6:.1f} MB); raw and blurred windows in one launch (descriptor_bins=0, "
        f"16 levels, bit-identical to the plain version) {times['k2_raw_and_blurred']:.4f} ms, twice the bytes: "
        f"bound {2 * k2_bound:.4f} ms")
    nullspace, times["nullspace"] = nullspace_kernel_phase(torch)
    return [
        dict(name="corner_response", route="cuda", source="slamtpu_torch/csrc/corner_response.cu",
             replaces="slamtpu/ops/pallas_corner.py:165", launches=None, max_abs_err=k1_err,
             ms=times["k1"], plain_ms=times["k1_plain"], bound_ms=k1_bound,
             bound_by="operations" if k1_ops_ms > k1_bytes_ms else "bytes", library_ms=None),
        dict(name="extract_patches_batched", route="cuda", source="slamtpu_torch/csrc/extract_patches.cu",
             replaces="slamtpu/ops/pallas_patch.py:80", launches=None, max_abs_err=k2_err,
             ms=times["k2"], plain_ms=times["k2_plain"], bound_ms=k2_bound, bound_by="bytes",
             library_ms=times["k2_lib"]),
        nullspace,
    ], times


def _design_matrix(p1, p2):
    """[..., 5, 2] samples -> [..., 5, 9] rows x2 (x) x1 of homogeneous points."""
    x1, x2 = (p.new_ones((*p.shape[:-1], 3)) for p in (p1, p2))
    x1[..., :2], x2[..., :2] = p1, p2
    return (x2[..., :, :, None] * x1[..., :, None, :]).reshape(*p1.shape[:-1], 9)


def nullspace_kernel_phase(torch):
    """The 5-point null space kernel against torch.linalg.qr (its plain
    version) on the card at each VO cell's chunk of hypotheses, on
    independent uniform samples and on samples of two nearby views (small
    parallax, ill-conditioned A): bit-identical to the library's basis;
    orthonormal, ||A basis|| <= 1e-5 ||A|| and batch-invariant on the
    nearby views. Times by CUDA-graph replay; the library QR, which does not
    capture, by CUDA events around eager calls."""
    import numpy as np

    from slamtpu_torch.ops import five_point

    launches_before = five_point._nullspace4.launches
    rng = np.random.default_rng(0)
    out, err = {}, 0.0
    for cell, shape in NULLSPACE_CHUNKS.items():
        uni = [torch.from_numpy(rng.uniform(-0.8, 0.8, (*shape, 5, 2)).astype(np.float32)).cuda() for _ in range(2)]
        got, ref = five_point._nullspace4(*uni), five_point._nullspace4_plain(*uni)
        cell_err = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"null space kernel at {shape}: not bit-identical to torch.linalg.qr "
                                 f"(max abs err {cell_err})")
        err = max(err, cell_err)
        near = []
        for i in range(5):  # distinct inputs for timing; near[0] also for the checks
            x = np.stack([rng.uniform(-0.85, 0.9, (*shape, 5)), rng.uniform(-0.27, 0.27, (*shape, 5))], -1)
            near.append([torch.from_numpy(v.astype(np.float32)).cuda()
                         for v in (x, x + rng.normal(0.0, 0.01, x.shape))])
        got = five_point._nullspace4(*near[0])
        near_ref = five_point._nullspace4_plain(*near[0])
        near_err = float((got - near_ref).abs().max())
        if not torch.equal(got, near_ref):
            raise AssertionError(f"null space kernel at {shape}, nearby views: not bit-identical to "
                                 f"torch.linalg.qr (max abs err {near_err})")
        b = got.reshape(-1, 4, 9).double()
        a = _design_matrix(*near[0]).double().reshape(-1, 5, 9)
        ortho = float((b @ b.transpose(-1, -2) - torch.eye(4, dtype=torch.float64, device=b.device)).abs().max())
        resid = float((torch.linalg.matrix_norm(a @ b.transpose(-1, -2)) / torch.linalg.matrix_norm(a)).max())
        alone = five_point._nullspace4(near[0][0].reshape(-1, 5, 2)[-1:].contiguous(),
                                       near[0][1].reshape(-1, 5, 2)[-1:].contiguous())
        if ortho > 1e-5 or resid > 1e-5 or not torch.equal(alone[0], got.reshape(-1, 4, 3, 3)[-1]):
            raise AssertionError(f"null space kernel at {shape}: orthonormality {ortho}, residual {resid}, or "
                                 f"the last system differs alone")
        m = int(np.prod(shape))
        lib_inputs = [_design_matrix(*p).transpose(-1, -2).contiguous() for p in near]  # A^T, as the plain version
        bytes_ms = NULLSPACE_BYTES_PER_SYSTEM * m / HBM_BYTES_PER_S * 1e3
        ops_ms = NULLSPACE_OPS_PER_SYSTEM * m / FP32_FLOP_PER_S * 1e3
        out[cell] = dict(
            systems=m, max_abs_err=cell_err, near_views_max_abs_err=near_err, orthonormality=ortho,
            residual=resid,
            ms=device_ms(torch, lambda p: five_point._nullspace4(*p), near, reps=20),
            eager_ms=time_ms(torch, lambda p: five_point._nullspace4(*p), near, reps=4),
            plain_ms=time_ms(torch, lambda p: five_point._nullspace4_plain(*p), near, reps=2),
            library_ms=time_ms(torch, lambda at: torch.linalg.qr(at, mode="complete"), lib_inputs, reps=2),
            bound_ms=max(bytes_ms, ops_ms), bound_by="operations" if ops_ms > bytes_ms else "bytes",
        )
        t = out[cell]
        log(f"null space kernel, {cell} chunk {shape} ({m} systems): max abs err {cell_err:.3g} against "
            f"torch.linalg.qr (uniform samples), {near_err:.3g} on two nearby views (orthonormal to {ortho:.3g}, "
            f"residual {resid:.3g}, batch-invariant); one launch {t['ms']:.4f} ms (graph replay), eager "
            f"{t['eager_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; torch.linalg.qr {t['library_ms']:.4f} ms; "
            f"bound {t['bound_ms']:.6f} ms by {t['bound_by']} ({NULLSPACE_BYTES_PER_SYSTEM * m / 1e6:.3f} MB = "
            f"{bytes_ms:.6f} ms; {NULLSPACE_OPS_PER_SYSTEM * m / 1e6:.2f} MFLOP = {ops_ms:.6f} ms)")
    five_point._nullspace4.launches = launches_before
    big = out["vo-batch4"]
    return dict(name="nullspace4", route="cuda", source="slamtpu_torch/csrc/nullspace4.cu", replaces=None,
                launches=None, max_abs_err=err, ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
                bound_by=big["bound_by"], library_ms=big["library_ms"]), out


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

    from slamtpu_torch.pipeline.vo import VoConfig, run_vo

    config = VoConfig()
    run_vo(scene.frames[: CHUNK + 1], scene.intrinsics, config, chunk_size=CHUNK, device="cuda")  # warm-up

    elapsed, launches = [], None
    n_chunks = -(-N_FRAMES // CHUNK)
    for _ in range(VO_REPEATS):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_vo(scene.frames, scene.intrinsics, config, chunk_size=CHUNK, seed=0, device="cuda")
        elapsed.append(time.perf_counter() - t0)
        counts = _counts()
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
    t_err = translation_errors(run, scene)
    log(f"VO: {N_FRAMES} frames {WIDTH}x{HEIGHT}, {VO_REPEATS} runs in {[round(e, 4) for e in elapsed]} s -> "
        f"median {fps_med:.2f} frames/s (min {fps[0]:.2f}, max {fps[-1]:.2f}); "
        f"success {success_rate:.4f}, median rot err {rot_med:.4f} deg; translation direction error {t_err}; "
        f"launches per run {launches}")
    if success_rate < 0.8 or rot_med > 1.0:
        raise AssertionError(f"VO gates failed: success {success_rate} (>= 0.8), median rot err {rot_med} (<= 1.0)")
    return launches, dict(frames=N_FRAMES, fps_median=fps_med, fps_min=fps[0], fps_max=fps[-1],
                          elapsed_s=elapsed, success_rate=success_rate, rot_err_deg_median=rot_med,
                          t_dir_err_deg=t_err)


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


def _reset_counts() -> None:
    from slamtpu_torch.ops.corner import corner_response
    from slamtpu_torch.ops.patch import extract_patches_batched

    corner_response.launches = 0
    extract_patches_batched.launches = 0


def _counts() -> dict:
    """Each kernel's launches since the last _reset_counts."""
    from slamtpu_torch.ops.corner import corner_response
    from slamtpu_torch.ops.patch import extract_patches_batched

    return {"corner_response": corner_response.launches, "extract_patches_batched": extract_patches_batched.launches}


def translation_errors(run, scene) -> dict:
    """Angles (degrees) between each successful pair's unit translation and
    the ground truth's direction: the median, the largest, and the pairs
    off by more than 10 and 90 degrees (a cheirality-flipped winner)."""
    import numpy as np

    gt = scene.rel_translations / np.linalg.norm(scene.rel_translations, axis=1, keepdims=True)
    err = np.degrees(np.arccos(np.clip((run.translations * gt).sum(1), -1.0, 1.0)))[run.success.astype(bool)]
    return dict(median=float(np.median(err)), max=float(err.max()), over_10=int((err > 10).sum()),
                over_90=int((err > 90).sum()))


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

    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig

    config = PointCloudConfig()  # == bench.py:687-695
    runner(scene.frames[: CHUNK + 1], scene.intrinsics, config, chunk_size=CHUNK, device="cuda")  # warm-up
    n_pairs = N_FRAMES - 1
    expected = -(-n_pairs // CHUNK) + 1  # one launch per chunk, one for frame 0
    elapsed, runs, launches = [], [], None
    for _ in range(repeats):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runner(scene.frames, scene.intrinsics, config, chunk_size=CHUNK, seed=0, device="cuda")
        torch.cuda.synchronize()
        elapsed.append(time.perf_counter() - t0)
        counts = _counts()
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


def depth_phase(torch, scene):
    """MonoDepth2 at bench.py's configuration on the card, then the
    depth-mapping pipeline on the clip and on ground-truth depth."""
    import numpy as np

    from benchmark.inputs.depth_counts import flop_per_frame
    from slamtpu_torch.cli.depth_estimation import depth_fn_for
    from slamtpu_torch.depth.monodepth2 import MonoDepth2
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.ops.ransac import RansacConfig
    from slamtpu_torch.pipeline.depth_mapping import run_depth_mapping
    from slamtpu_torch.pipeline.vo import VoConfig

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on after importing slamtpu_torch")
    models = {"f32": MonoDepth2(seed=0, device="cuda")}
    weights = dict(encoder=models["f32"].encoder.state_dict(), decoder=models["f32"].decoder.state_dict())
    models["bf16"] = MonoDepth2(**weights, compute_dtype=torch.bfloat16, device="cuda")
    flop = flop_per_frame(models["f32"].height, models["f32"].width)
    peaks = {"f32": FP32_FLOP_PER_S, "bf16": BF16_FLOP_PER_S}

    out, timing = {}, {}
    for batch in DEPTH_BATCHES:
        # Three distinct clips from frame 1, gray repeated to RGB, f32 on the
        # card (bench.py:612-617).
        clips = [torch.as_tensor(scene.frames[1 + i * batch : 1 + (i + 1) * batch]).cuda()[..., None]
                 .expand(-1, -1, -1, 3).float().contiguous() for i in range(3)]
        for name, model in models.items():
            model._forward(clips[0] + 0.25)  # warm-up on a perturbed clip
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            samples = []
            for _ in range(3):
                for clip in clips:
                    t0 = time.perf_counter()
                    disp = model._forward(clip)
                    torch.cuda.synchronize()
                    samples.append((time.perf_counter() - t0) * 1e3 / batch)
            peak = torch.cuda.max_memory_allocated()
            samples.sort()
            ms = statistics.median(samples)
            rate = flop / (ms * 1e-3)
            timing[f"{name}_batch{batch}"] = dict(
                ms_per_frame=ms, ms_min=samples[0], ms_max=samples[-1], samples=samples, tflop_per_s=rate / 1e12,
                peak_share=rate / peaks[name], peak_allocated_mib=peak / 2**20,
                peak_above_inputs_mib=(peak - held) / 2**20)
            log(f"MonoDepth2 {name} batch {batch} ({model.width}x{model.height} from {WIDTH}x{HEIGHT}): median "
                f"{ms:.4f} ms/frame (min {samples[0]:.4f}, max {samples[-1]:.4f}, {len(samples)} calls) = "
                f"{rate / 1e12:.2f} TFLOP/s "
                f"at {flop / 1e9:.3f} GFLOP/frame, {rate / peaks[name]:.2%} of the {peaks[name] / 1e12:.0f} TFLOP/s "
                f"{name} peak; peak memory {peak / 2**20:.1f} MiB allocated ({(peak - held) / 2**20:.1f} MiB above "
                f"the inputs)")
            if batch == DEPTH_BATCHES[0]:
                out[name] = disp
        del clips

    # Gates: the output, bf16 against f32, the card against the CPU.
    d32, d16 = out["f32"], out["bf16"]
    shape = (DEPTH_BATCHES[0], models["f32"].height, models["f32"].width)
    for name, d in out.items():
        if d.shape != shape or not bool(torch.isfinite(d).all()) or not bool(((d > 0) & (d < 1)).all()):
            raise AssertionError(f"MonoDepth2 {name}: output {tuple(d.shape)} not finite inside (0, 1)")
    diff16 = float((d16 - d32).abs().max())
    corr = float(np.corrcoef(d32.cpu().numpy().ravel(), d16.cpu().numpy().ravel())[0, 1])
    cpu = MonoDepth2(**weights, device="cpu")
    frame = scene.frames[1]
    t0 = time.perf_counter()
    ref = cpu.predict_raw(frame)
    cpu_s = time.perf_counter() - t0
    diff_cpu = float((models["f32"].predict_raw(frame).cpu() - ref).abs().max())
    log(f"MonoDepth2 gates: outputs {list(shape)} finite inside (0, 1); disparity std {float(d32.std()):.4f}; "
        f"bf16 vs f32 max |d| {diff16:.4g} (bar 0.05), correlation {corr:.6f} (bar 0.97); card f32 vs CPU on "
        f"one {WIDTH}x{HEIGHT} frame max |d| {diff_cpu:.3g} (bar 5e-4; CPU {cpu_s:.2f} s)")
    if diff16 >= 0.05 or corr <= 0.97 or diff_cpu > 5e-4:
        raise AssertionError("MonoDepth2: bf16 vs f32 or card vs CPU outside the bars")

    # The depth-mapping path on the clip, with the CLI's --fuse-vo depth function.
    depth_fn = depth_fn_for(models["bf16"], HEIGHT, WIDTH)
    run_depth_mapping(scene.frames[: CHUNK + 1], scene.intrinsics, depth_fn, stride=8, device="cuda")  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_depth_mapping(scene.frames, scene.intrinsics, depth_fn, stride=8, device="cuda")
    wall = time.perf_counter() - t0
    launches = _counts()
    _check_launches(launches, -(-N_FRAMES // CHUNK), "the depth-mapping run")
    success = res.vo_run.successful_frames / (N_FRAMES - 1)
    n_kf = len(res.keyframe_frame_idx)
    log(f"depth mapping ({N_FRAMES} frames {WIDTH}x{HEIGHT}, bf16 MonoDepth2, stride 8, keyframe stride 2): "
        f"{wall:.4f} s, {len(res.points)} points from {-(-n_kf // 2)} of {n_kf} keyframes; VO success {success:.4f}; "
        f"launches {launches}")
    if not len(res.points) or not np.isfinite(res.points).all() or success < 0.8:
        raise AssertionError(f"depth mapping gates failed: {len(res.points)} points, finite "
                             f"{bool(np.isfinite(res.points).all())}, success {success} (>= 0.8)")

    # Ground truth: the renderer's depth maps in place of the network.
    gt = render_sequence(n_frames=12, height=192, width=256, n_points=500, step=1.0, seed=6, render_depth=True)
    lookup = {gt.frames[i].tobytes(): gt.depths[i] for i in range(len(gt.frames))}
    cfg = VoConfig(orb=OrbConfig(max_features=250), ransac=RansacConfig(iters=200))
    res_gt = run_depth_mapping(gt.frames, gt.intrinsics, lambda f: lookup[np.asarray(f).tobytes()], vo_config=cfg,
                               stride=6, keyframe_stride=2, device="cuda")
    d = np.linalg.norm(res_gt.points[:, None, :] - gt.points[None, :, :], axis=-1)
    rel = float(np.median(d.min(axis=1) / np.maximum(np.linalg.norm(res_gt.points, axis=1), 1.0)))
    log(f"depth mapping on true depth (12x256x192): {len(res_gt.points)} points, median relative error {rel:.4f} "
        f"(bar 0.15)")
    if len(res_gt.points) <= 300 or rel >= 0.15:
        raise AssertionError(f"depth mapping on true depth: {len(res_gt.points)} points, median error {rel}")
    return launches, dict(gflop_per_frame=flop / 1e9, timing=timing, bf16_vs_f32_max_abs=diff16,
                          bf16_vs_f32_corr=corr, cuda_vs_cpu_max_abs=diff_cpu, mapping_wall_s=wall,
                          mapping_points=len(res.points), mapping_keyframes=n_kf, mapping_vo_success=success,
                          gt_points=len(res_gt.points), gt_median_rel_err=rel)


def write_png_gray(path: str, image) -> None:
    """An 8-bit grayscale PNG with the standard library alone (zlib and
    struct; every row filter 0): the GPU machine has no cv2 and no PIL."""
    import numpy as np

    h, w = image.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(image, np.uint8)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_kitti_sequence(directory: str, scene):
    """The scene as a KITTI odometry sequence directory: image_0/%06d.png,
    calib.txt (P0..P3 from the scene's intrinsics; P1 and P3 with a stereo
    baseline), times.txt at 10 Hz, and beside it the ground truth poses.txt
    (camera-to-world [T, 3, 4] rows, converted from the scene's
    world-to-camera poses). Returns (sequence directory, poses path)."""
    import numpy as np

    os.makedirs(os.path.join(directory, "image_0"), exist_ok=True)
    for i, frame in enumerate(scene.frames):
        write_png_gray(os.path.join(directory, "image_0", f"{i:06d}.png"), frame)
    cam = scene.intrinsics
    with open(os.path.join(directory, "calib.txt"), "w") as f:
        for i, baseline in enumerate((0.0, -0.54, 0.0, -0.54)):
            p = [cam.fx, 0.0, cam.cx, baseline * cam.fx, 0.0, cam.fy, cam.cy, 0.0, 0.0, 0.0, 1.0, 0.0]
            f.write(f"P{i}: " + " ".join(f"{v:.17g}" for v in p) + "\n")
    with open(os.path.join(directory, "times.txt"), "w") as f:
        f.write("".join(f"{0.1 * i:.6e}\n" for i in range(len(scene.frames))))
    r_c2w = np.transpose(scene.rotations, (0, 2, 1))
    t_c2w = -np.einsum("tij,tj->ti", r_c2w, scene.translations)
    poses = os.path.join(os.path.dirname(os.path.abspath(directory)), "poses.txt")
    np.savetxt(poses, np.concatenate([r_c2w, t_c2w[:, :, None]], axis=2).reshape(-1, 12), fmt="%.17g")
    return directory, poses


def _run_cli(main_fn, argv) -> str:
    """A CLI's main(argv) in this process; its standard output is returned
    and logged."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    text = buf.getvalue()
    log("\n".join(f"  | {line}" for line in text.rstrip().splitlines()))
    return text


def _vo_gates(run, scene, what: str):
    """The VO phase's ground-truth gates on a run of `scene`'s frames:
    (success rate, median rotation error in degrees)."""
    import numpy as np

    n = len(run.success)
    if run.rotations.shape != (n, 3, 3) or not np.isfinite(run.rotations).all():
        raise AssertionError(f"{what}: rotations are not finite [T-1, 3, 3]")
    tr = np.einsum("tij,tij->t", run.rotations, scene.rel_rotations[:n])
    rot_err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    ok = run.success.astype(bool)
    success_rate, rot_med = float(ok.mean()), float(np.median(rot_err[ok])) if ok.any() else float("inf")
    if success_rate < 0.8 or rot_med > 1.0:
        raise AssertionError(f"{what}: gates failed: success {success_rate} (>= 0.8), median rot err {rot_med} "
                             f"(<= 1.0)")
    return success_rate, rot_med


def vo_options_phase(torch, scene, device: str = "cuda"):
    """Every VO option on the clip, run_vo_batched on four windows of it,
    and one pair through the root package's eager wrappers."""
    import dataclasses

    import numpy as np

    import slamtpu_torch
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.feature.matcher import FeatureMatcher
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo, run_vo_batched

    base = VoConfig()
    configs = {
        "refine_matches": VoConfig(refine_matches=True),
        "homography_fallback": VoConfig(ransac=dataclasses.replace(base.ransac, homography_fallback=True)),
        "irls": VoConfig(ransac=dataclasses.replace(base.ransac, refit_method="irls")),
        "prescore_subset=128": VoConfig(ransac=dataclasses.replace(base.ransac, prescore_subset=128)),
        "descriptor_bins=0": VoConfig(orb=dataclasses.replace(OrbConfig(), descriptor_bins=0)),
        "robust": VoConfig.robust(),
    }
    n_chunks = -(-N_FRAMES // CHUNK)
    out, launches = {}, {}
    for name, config in configs.items():
        run_vo(scene.frames[: CHUNK + 1], scene.intrinsics, config, chunk_size=CHUNK, device=device)  # warm-up
        elapsed = []
        for _ in range(OPTION_REPEATS):
            _reset_counts()
            _sync(torch, device)
            t0 = time.perf_counter()
            run = run_vo(scene.frames, scene.intrinsics, config, chunk_size=CHUNK, seed=0, device=device)
            elapsed.append(time.perf_counter() - t0)
            counts = _counts()
            _check_launches(counts, n_chunks, f"run_vo with {name}")
        launches[f"vo:{name}"] = counts
        success, rot_med = _vo_gates(run, scene, f"run_vo with {name}")
        fps = statistics.median(N_FRAMES / e for e in elapsed)
        out[name] = dict(fps_median=fps, elapsed_s=elapsed, success_rate=success, rot_err_deg_median=rot_med,
                         t_dir_err_deg=translation_errors(run, scene))
        log(f"vo option {name}: {N_FRAMES} frames, {OPTION_REPEATS} runs in {[round(e, 4) for e in elapsed]} s -> "
            f"median {fps:.2f} frames/s; success {success:.4f}, median rot err {rot_med:.4f} deg; translation "
            f"direction error {out[name]['t_dir_err_deg']}; launches per run {counts}")

    # --- run_vo_batched: four windows in one pass, against run_vo of each -----------------
    windows = np.stack([scene.frames[o : o + BATCH_FRAMES] for o in BATCH_OFFSETS])
    run_vo_batched(windows[:, : CHUNK + 1], scene.intrinsics, base, chunk_size=CHUNK, device=device)  # warm-up
    _reset_counts()
    _sync(torch, device)
    t0 = time.perf_counter()
    runs = run_vo_batched(windows, scene.intrinsics, base, chunk_size=CHUNK, seed=0, device=device)
    batched_s = time.perf_counter() - t0
    counts = _counts()
    _check_launches(counts, -(-BATCH_FRAMES // CHUNK), "run_vo_batched (one launch a chunk for all sequences)")
    solo_s, worst = 0.0, 0.0
    for b, (offset, run) in enumerate(zip(BATCH_OFFSETS, runs)):
        _sync(torch, device)
        t0 = time.perf_counter()
        solo = run_vo(windows[b], scene.intrinsics, base, chunk_size=CHUNK, seed=b, device=device)
        solo_s += time.perf_counter() - t0
        for field in ("success", "num_matches", "is_keyframe"):
            if not np.array_equal(getattr(run, field), getattr(solo, field)):
                raise AssertionError(f"run_vo_batched sequence {b}: {field} differs from run_vo of its window")
        diff = float(np.abs(run.rotations - solo.rotations).max())
        worst = max(worst, diff)
        if diff > 1e-5:
            raise AssertionError(f"run_vo_batched sequence {b}: rotations differ from run_vo by {diff} (> 1e-5)")
        _vo_gates(run, dataclasses.replace(scene, rel_rotations=scene.rel_rotations[offset:]),
                  f"run_vo_batched sequence {b}")
    n_frames = len(BATCH_OFFSETS) * BATCH_FRAMES
    out["batched"] = dict(sequences=len(BATCH_OFFSETS), frames_each=BATCH_FRAMES, fps=n_frames / batched_s,
                          solo_fps=n_frames / solo_s, rotation_max_abs_diff=worst, launches=counts)
    log(f"run_vo_batched: {len(BATCH_OFFSETS)} windows of {BATCH_FRAMES} frames (offsets {list(BATCH_OFFSETS)}) in "
        f"{batched_s:.4f} s = {n_frames / batched_s:.2f} frames/s, against {n_frames / solo_s:.2f} frames/s for "
        f"run_vo of each window in turn; success, matches and keyframes equal, rotations within {worst:.3g}; "
        f"launches {counts}")

    # --- the root package's eager wrappers on one pair -----------------------------------------
    cam = scene.intrinsics
    det = slamtpu_torch.OrbDetector(max_features=base.orb.max_features, device=device)
    f1, f2 = det.detect_and_compute(scene.frames[0]), det.detect(scene.frames[1])
    matcher = FeatureMatcher()
    good = matcher.filter_good_matches(matcher.match_descriptors(f1.descriptors, f2.descriptors, f1.mask, f2.mask))
    est = slamtpu_torch.PoseEstimator(cam, device=device)
    p1, p2 = est.extract_matched_points(f1.xy.cpu().numpy(), f2.xy.cpu().numpy(), good)
    res = est.compute_essential_matrix(p1, p2, config=base.ransac)
    rot, trans = est.recover_pose(res, p1, p2)
    is_kf = slamtpu_torch.KeyframeSelector(device=device).should_be_keyframe(rot, trans, len(p1))
    n_inl = int(res.num_inliers)
    if not (np.isfinite(rot).all() and np.isfinite(trans).all()) or n_inl < 8:
        raise AssertionError(f"eager wrappers: pose not finite or {n_inl} inliers (< 8)")
    err = float(np.degrees(np.arccos(np.clip((np.trace(rot.T @ scene.rel_rotations[0]) - 1) / 2, -1, 1))))
    out["eager"] = dict(matches=len(p1), inliers=n_inl, rot_err_deg=err, keyframe=bool(is_kf))
    log(f"eager wrappers (OrbDetector, PoseEstimator, KeyframeSelector) on pair 0: {len(p1)} matches, {n_inl} inliers, "
        f"rotation error {err:.4f} deg, keyframe {is_kf}")
    return launches, out


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cli_phase(torch, scene, device: str = "cuda", workdir: str | None = None):
    """The CLIs driven in-process from a KITTI-layout directory of the
    clip: the native loader reads it back byte-exact; the VO CLI at its
    defaults (1000 features, chunk 32, seed 0) equals a direct run_vo and
    prints the ATE that evaluate.ate_rmse gives; the point-cloud CLI at its
    defaults (3000 features, a 65536-slot map), fused and host loop, with
    --global-ba and --checkpoint; cli.main and visualize_features; the BA
    demo; then F1's draws card vs CPU, StepTimer around run_vo and
    profile_trace. Returns (launches by CLI path, summary)."""
    import numpy as np

    from slamtpu_torch.cli import bundle_adjustment, main as cli_main, point_cloud, visual_odometry, visualize_features
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.checkpoint import load_pipeline_state
    from slamtpu_torch.io.video import load_frames
    from slamtpu_torch.ops.ransac import pair_uniforms
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo
    from slamtpu_torch.utils.evaluate import ate_rmse
    from slamtpu_torch.utils.metrics import StepTimer, force_sync, profile_trace

    n = len(scene.frames)
    expected = -(-n // CHUNK)
    dev = ["--device", device]
    out, launches = {}, {}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        t0 = time.perf_counter()
        seq, poses = write_kitti_sequence(os.path.join(tmp, "00"), scene)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        frames, cam, fps = load_frames(seq)
        load_s = time.perf_counter() - t0
        if not np.array_equal(frames, scene.frames) or cam != scene.intrinsics or abs(fps - 10.0) > 1e-9:
            raise AssertionError("the KITTI directory does not read back byte-equal with its intrinsics and 10 Hz")
        out["decode_frames_per_s"] = n / load_s
        log(f"KITTI directory of {n} {frames.shape[2]}x{frames.shape[1]} PNG frames: written in {write_s:.2f} s "
            f"(stdlib zlib writer), read back byte-equal through the native loader in {load_s:.4f} s = "
            f"{n / load_s:.1f} frames/s")

        # --- the VO CLI at its defaults -------------------------------------------------
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            traj_path = os.path.join(tmp, "vo_trajectory.json")
            _reset_counts()
            text = _run_cli(visual_odometry.main, [seq, "--gt", poses, "--output", traj_path] + dev)
            launches["vo_cli"] = _counts()
            _check_launches(launches["vo_cli"], expected, "the VO CLI")
            run = run_vo(frames, cam, VoConfig(orb=OrbConfig(max_features=1000), fps=fps), chunk_size=CHUNK, seed=0,
                         device=device)
            if open(traj_path).read() != run.trajectory.to_json():
                raise AssertionError("the VO CLI's trajectory differs from a direct run_vo's")
            gt = np.loadtxt(poses).reshape(-1, 3, 4)
            est = np.asarray([p.position for p in run.trajectory.points])
            ref_ate = ate_rmse(est, gt[[max(p.frame - 1, 0) for p in run.trajectory.points], :, 3])
            ate = float(text.split("keyframes):")[1].split("m")[0])
            if not np.isfinite(ate) or f"{ref_ate:.3f}" != f"{ate:.3f}":
                raise AssertionError(f"the VO CLI's ATE {ate} is not evaluate.ate_rmse's {ref_ate}")
            out["vo_cli"] = dict(fps=float(text.split("Average FPS:")[1].split()[0]), ate_m=ref_ate,
                                 success=run.successful_frames / (n - 1), keyframes=run.keyframe_count,
                                 t_dir_err_deg=translation_errors(run, scene))
            log(f"VO CLI: trajectory equal to run_vo's, ATE {ref_ate:.6f} m (Sim3) over {len(est)} keyframes, "
                f"{out['vo_cli']['fps']} frames/s as printed; translation direction error "
                f"{out['vo_cli']['t_dir_err_deg']}; launches {launches['vo_cli']}")

            # --- the point-cloud CLI at its defaults, fused and host loop ----------------
            # The fused runner logs at most max_obs_per_kf observations a
            # keyframe, the host loop all of them: at 3000 features the cap
            # binds, so the census compares the host log capped the same way.
            cap = PointCloudConfig().max_obs_per_kf
            pc = {}
            for mode in ("fused", "host"):
                ckpt = os.path.join(tmp, f"ckpt_{mode}")
                _reset_counts()
                text = _run_cli(point_cloud.main, [seq, "--global-ba", "--checkpoint", ckpt] + dev
                                + (["--fused"] if mode == "fused" else []))
                launches[f"point_cloud_cli_{mode}"] = _counts()
                _check_launches(launches[f"point_cloud_cli_{mode}"], expected, f"the point-cloud CLI ({mode})")
                for artifact in ("point_cloud.ply", "point_cloud.json", "trajectory_output.json"):
                    if not os.path.getsize(artifact):
                        raise AssertionError(f"the point-cloud CLI ({mode}) wrote no {artifact}")
                map_state, _, _, kf_frames, _, obs = load_pipeline_state(ckpt, device=device)
                per_kf = np.bincount(np.asarray(obs[0]), minlength=len(kf_frames)) if obs else np.zeros(1, int)
                pc[mode] = dict(fps=float(text.split("Avg FPS:")[1].split()[0]),
                                ba_runs=int(text.split("Bundle Adjustment runs:")[1].split()[0]),
                                keyframes=np.asarray(kf_frames).tolist(), landmarks=int(map_state.valid.sum()),
                                observations=int(per_kf.sum()),
                                observations_capped=int(np.minimum(per_kf, cap).sum()),
                                kf_at_cap=int((per_kf >= cap).sum()),
                                global_ba=text.split("Global BA: reprojection error")[1].split("\n")[0].strip())
                if pc[mode]["ba_runs"] <= 0:
                    raise AssertionError(f"the point-cloud CLI ({mode}) ran no BA")
            f, h = pc["fused"], pc["host"]
            log(f"point-cloud CLI: fused {f['fps']} / host loop {h['fps']} frames/s as printed; keyframes "
                f"{len(f['keyframes'])} / {len(h['keyframes'])} (identical {f['keyframes'] == h['keyframes']}); BA runs "
                f"{f['ba_runs']} / {h['ba_runs']}; landmarks {f['landmarks']} / {h['landmarks']}; observations "
                f"{f['observations']} / {h['observations']} ({h['observations_capped']} with the host log capped at "
                f"{cap} a keyframe; keyframes at the cap {f['kf_at_cap']} / {h['kf_at_cap']}); global BA "
                f"{f['global_ba']} / {h['global_ba']}; launches {launches['point_cloud_cli_fused']} / "
                f"{launches['point_cloud_cli_host']}")
            if (f["keyframes"] != h["keyframes"] or abs(f["landmarks"] - h["landmarks"]) > max(3, 0.02 * h["landmarks"])
                    or abs(f["observations"] - h["observations_capped"]) > 0.05 * h["observations_capped"]):
                raise AssertionError("point-cloud CLI: fused vs host loop outside the JAX package's bars")
            out["point_cloud_cli"] = {k: {kk: vv for kk, vv in v.items() if kk != "keyframes"} | {
                "keyframes": len(v["keyframes"])} for k, v in pc.items()}

            # --- the small CLIs ---------------------------------------------------------------
            text = _run_cli(bundle_adjustment.main, dev)
            initial = float(text.split("Initial reprojection error:")[1].split()[0])
            final = float(text.split("Final reprojection error:")[1].split()[0])
            if not final < initial:
                raise AssertionError(f"the BA demo did not lower the error: {initial} -> {final}")
            _reset_counts()
            text = _run_cli(cli_main.main, [seq] + dev)
            launches["main_cli"] = _counts()
            _reset_counts()
            text += _run_cli(visualize_features.main, [seq, "--max-frames", str(n)] + dev)
            launches["features_cli"] = _counts()
            for name in ("main_cli", "features_cli"):
                _check_launches(launches[name], expected, f"the {name}")
            if float(text.split("mean features/frame:")[1].split()[0]) < 100 or float(
                    text.split("Mean good matches/pair:")[1].split()[0]) < 50:
                raise AssertionError("cli.main / visualize_features found too few features or matches")
            out["ba_demo"] = dict(initial=initial, final=final)
        finally:
            os.chdir(cwd)

        # --- F1 and the metrics ---------------------------------------------------------------
        ids = list(range(n - 1))
        if not torch.equal(pair_uniforms(0, ids, 64, 500, device).cpu(), pair_uniforms(0, ids, 64, 500, "cpu")):
            raise AssertionError(f"pair_uniforms draws differ between {device} and the CPU")
        timer = StepTimer()
        timer.start()
        force_sync(run_vo(frames, cam, VoConfig(), chunk_size=CHUNK, seed=0, device=device))
        timer.stop()
        with profile_trace(os.path.join(tmp, "trace")) as trace_dir:
            run_vo(frames[: CHUNK + 1], cam, VoConfig(), chunk_size=CHUNK, device=device)
        trace_bytes = os.path.getsize(os.path.join(trace_dir, "trace.json"))
        if not trace_bytes:
            raise AssertionError("profile_trace wrote an empty trace")
        out.update(step_timer_vo_fps=n / timer.times[0], trace_bytes=trace_bytes)
        log(f"F1: pair_uniforms(0, {n - 1} pairs, 64 x 500) bit-identical on {device} and the CPU; StepTimer "
            f"around run_vo: {timer.times[0]:.4f} s = {n / timer.times[0]:.2f} frames/s; profile_trace: "
            f"{trace_bytes} bytes of Chrome trace")
    return launches, out


def _timed(torch, device, fn, expected: int, what: str):
    """One run of `fn` with the host clock around it, ending in a sync, and
    the kernels' launches in it checked against `expected`. Returns
    (result, seconds, launches)."""
    _reset_counts()
    _sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, device)
    seconds = time.perf_counter() - t0
    counts = _counts()
    if torch.device(device).type == "cuda":  # a rehearsal on the CPU launches no kernel
        _check_launches(counts, expected, what)
    return out, seconds, counts


def _vo_block(result) -> dict:
    """A sharded_vo_step result's first sequence as numpy arrays."""
    return {k: v[0].cpu().numpy() for k, v in result._asdict().items()}


def _check_sharded_vo(got: dict, run, what: str, rot_tol: float, pos_tol: float) -> dict:
    """Slots [1, T) of a sharded step against run_vo's pairs: success,
    matches and keyframes identical, rotations within rot_tol (0 =
    identical, then translations too), keyframe positions within pos_tol of
    run_vo's trajectory relative to its extent. Returns the gaps."""
    import numpy as np

    for field, ours in (("success", got["success"]), ("num_matches", got["num_matches"]),
                        ("is_keyframe", got["is_keyframe"])):
        if not np.array_equal(ours[1:], getattr(run, field)):
            raise AssertionError(f"{what}: {field} differs from run_vo's")
    rot = float(np.abs(got["rotations"][1:] - run.rotations).max())
    trans = float(np.abs(got["translations"][1:] - run.translations).max())
    serial = np.array([p.position for p in run.trajectory.points])[1:]
    pos = float(np.abs(got["positions"][1:][run.is_keyframe] - serial).max() / max(1.0, np.abs(serial).max()))
    if rot > rot_tol or (rot_tol == 0 and trans > 0) or pos > pos_tol:
        raise AssertionError(f"{what}: rotations {rot} (bar {rot_tol}), translations {trans}, positions {pos} "
                             f"relative (bar {pos_tol}) off run_vo")
    return dict(rotation_max_abs_diff=rot, translation_max_abs_diff=trans, position_rel_gap=pos)


def _check_flagship(got, ref, what: str, exact: bool = False) -> dict:
    """tests/test_sharding.py's flagship bars (keyframes, BA runs and
    successful frames identical; landmarks within max(15, 15 %)); with
    `exact`, the maps' validity identical too. Returns the differences."""
    import numpy as np

    n_got, n_ref = int(got.map_state.valid.sum()), int(ref.map_state.valid.sum())
    diff = dict(landmarks=(n_got, n_ref), ba_runs=(got.ba_runs, ref.ba_runs),
                successful=(got.successful_frames, ref.successful_frames),
                keyframe_rotation_max_abs_diff=float(np.abs(got.keyframe_rotations - ref.keyframe_rotations).max())
                if len(got.keyframe_rotations) == len(ref.keyframe_rotations) else None)
    same = (np.array_equal(got.keyframe_frame_idx, ref.keyframe_frame_idx) and got.ba_runs == ref.ba_runs
            and got.successful_frames == ref.successful_frames and abs(n_got - n_ref) <= max(15, 0.15 * n_ref))
    if exact:
        same = same and np.array_equal(got.map_state.valid.cpu().numpy(), ref.map_state.valid.cpu().numpy())
    if not same:
        raise AssertionError(f"{what}: outside the flagship bars: {diff}")
    return diff


def parallel_one_rank(torch, scene, device: str = "cuda"):
    """The multi-device runners on a one-rank group (NCCL on the card): the
    sharded VO step against run_vo, the sharded flagship against the fused
    runner and the batched one (B = 1) against the sharded one, each timed
    in turns with its serial counterpart."""
    import types

    from slamtpu_torch.parallel.distributed import initialize_multihost
    from slamtpu_torch.parallel.flagship import run_point_cloud_batched, run_point_cloud_sharded
    from slamtpu_torch.parallel.mesh import make_mesh
    from slamtpu_torch.parallel.sharded import sharded_vo_step
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig, run_point_cloud_fused
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo

    rank_world = initialize_multihost(device=device)
    try:
        mesh = make_mesh()
        backend = torch.distributed.get_backend()
        frames, cam, config = scene.frames, scene.intrinsics, VoConfig()
        n = frames.shape[0]
        n_chunks = -(-n // CHUNK)
        sharded_vo_step(mesh, frames[None, : CHUNK + 1], cam, config, chunk_size=CHUNK, device=device)  # warm-up

        vo = lambda: run_vo(frames, cam, config, chunk_size=CHUNK, seed=0, device=device)  # noqa: E731
        sh = lambda: sharded_vo_step(mesh, frames[None], cam, config, chunk_size=CHUNK, seed=0,  # noqa: E731
                                     device=device)
        times = {"run_vo": [], "sharded_vo_step": []}
        for name, fn in (("run_vo", vo), ("sharded_vo_step", sh), ("sharded_vo_step", sh), ("run_vo", vo)):
            out, seconds, counts = _timed(torch, device, fn, n_chunks, name)
            times[name].append(seconds)
            if name == "run_vo":
                run = out
            else:
                got, vo_launches = _vo_block(out), counts
        gaps = _check_sharded_vo(got, run, "one-rank sharded_vo_step", 0.0, 1e-5)
        success, rot_med = _vo_gates(types.SimpleNamespace(success=got["success"][1:], rotations=got["rotations"][1:]),
                                     scene, "one-rank sharded_vo_step")
        fps = {k: [n / s for s in v] for k, v in times.items()}
        log(f"parallel, one {backend} rank, mesh {tuple(mesh.shape)}: sharded_vo_step on {n} frames "
            f"{[round(f, 2) for f in fps['sharded_vo_step']]} frames/s against run_vo "
            f"{[round(f, 2) for f in fps['run_vo']]} in turns; success, matches and keyframes identical, rotations "
            f"and translations identical, positions {gaps['position_rel_gap']:.3g} relative; success {success:.4f}, "
            f"median rot err {rot_med:.4f} deg; launches {vo_launches}")

        pc = PointCloudConfig()
        run_point_cloud_sharded(frames[: CHUNK + 1], cam, mesh, pc, chunk_size=CHUNK, device=device)  # warm-up
        fused = lambda: run_point_cloud_fused(frames, cam, pc, chunk_size=CHUNK, seed=0, device=device)  # noqa: E731
        shf = lambda: run_point_cloud_sharded(frames, cam, mesh, pc, seed=0, chunk_size=CHUNK,  # noqa: E731
                                              device=device)
        bat = lambda: run_point_cloud_batched(frames[None], cam, mesh, pc, seeds=[0], chunk_size=CHUNK,  # noqa: E731
                                              device=device)[0]
        times = {"fused": [], "sharded": [], "batched": []}
        results, launches = {}, {}
        for name, fn in (("fused", fused), ("sharded", shf), ("batched", bat), ("fused", fused)):
            results[name], seconds, launches[name] = _timed(torch, device, fn, n_chunks, f"the {name} flagship")
            times[name].append(seconds)
        vs_fused = _check_flagship(results["sharded"], results["fused"], "run_point_cloud_sharded vs fused")
        vs_sharded = _check_flagship(results["batched"], results["sharded"], "batched (B = 1) vs sharded", exact=True)
        ffps = {k: [(n - 1) / s for s in v] for k, v in times.items()}
        log(f"parallel, one {backend} rank: flagship frames/s (pairs over wall) in turns fused "
            f"{[round(f, 2) for f in ffps['fused']]}, sharded {[round(f, 2) for f in ffps['sharded']]}, batched "
            f"{[round(f, 2) for f in ffps['batched']]}; sharded vs fused {vs_fused}; batched vs sharded {vs_sharded}; "
            f"launches {launches['sharded']} / {launches['batched']}")
    finally:
        torch.distributed.destroy_process_group()
    paths = {"parallel_sharded_vo": vo_launches, "parallel_sharded_flagship": launches["sharded"],
             "parallel_batched_flagship": launches["batched"]}
    return paths, dict(rank_world=rank_world, backend=backend, mesh=tuple(mesh.shape), vo_fps=fps, vo_gaps=gaps,
                       vo_success_rate=success, vo_rot_err_deg_median=rot_med, flagship_fps=ffps,
                       sharded_vs_fused=vs_fused, batched_vs_sharded=vs_sharded)


def _time_collectives(torch, device, pdist) -> dict:
    """Wrap the package's collective helpers with the host clock (after a
    sync, so that pending device work stays out of the window); returns
    name -> list of seconds, filled as the helpers run."""
    times = {}
    for name in ("shift_right", "all_gather", "gather_to_first", "all_gather_object", "broadcast_object"):
        def timed(*args, _fn=getattr(pdist, name), _name=name, **kwargs):
            _sync(torch, device)
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            times.setdefault(_name, []).append(time.perf_counter() - t0)
            return out
        setattr(pdist, name, timed)
    return times


def _parallel_rank(rank: int, world: int, port: int, out_dir: str, device: str, cam, n_frames: int, clips,
                   chunk: int) -> None:
    """One of `world` Gloo ranks sharing the card: its block of the sharded
    VO step on a (1, world) mesh over the first n_frames frames of the clip
    in <out_dir>/frames.npy, then run_point_cloud_batched on a (2, world /
    2) mesh over `clips` ([start, stop) each, clip b at seed b); its
    results, times and launches pickled to out_dir."""
    import pickle

    import numpy as np
    import torch

    from slamtpu_torch.parallel import distributed as pdist
    from slamtpu_torch.parallel.flagship import run_point_cloud_batched
    from slamtpu_torch.parallel.mesh import make_mesh
    from slamtpu_torch.parallel.sharded import sharded_vo_step
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig
    from slamtpu_torch.pipeline.vo import VoConfig

    pdist.initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device, backend="gloo")
    try:
        collectives = _time_collectives(torch, device, pdist)
        clip = np.load(os.path.join(out_dir, "frames.npy"))
        mesh = make_mesh(data=1)
        frames = clip[:n_frames]
        block = pdist.from_process_local(mesh, frames[None])
        sharded_vo_step(mesh, pdist.from_process_local(mesh, frames[None, : 8 * world]), cam, VoConfig(),
                        chunk_size=chunk, device=device)  # warm-up
        collectives.clear()
        res, vo_s, vo_launches = _timed(torch, device, lambda: sharded_vo_step(
            mesh, block, cam, VoConfig(), chunk_size=chunk, seed=0, device=device), -(-block.shape[1] // chunk),
            f"rank {rank}'s sharded_vo_step")
        out = dict(rank=rank, slice=pdist.local_time_slice(mesh, n_frames), vo=_vo_block(res), vo_s=vo_s,
                   vo_launches=vo_launches, vo_collectives={k: list(v) for k, v in collectives.items()})

        mesh22 = make_mesh(data=2)
        clip_frames = np.stack([clip[a:b] for a, b in clips])
        per_rank = clip_frames.shape[1] // (world // 2)
        collectives.clear()
        results, batched_s, batched_launches = _timed(torch, device, lambda: run_point_cloud_batched(
            clip_frames, cam, mesh22, PointCloudConfig(), seeds=list(range(len(clips))), chunk_size=chunk,
            device=device), -(-per_rank // chunk), f"rank {rank}'s run_point_cloud_batched")
        out.update(batched_s=batched_s, batched_launches=batched_launches,
                   batched_collectives={k: list(v) for k, v in collectives.items()},
                   batched=[dict(keyframe_frame_idx=r.keyframe_frame_idx, ba_runs=r.ba_runs,
                                 successful_frames=r.successful_frames, keyframe_rotations=r.keyframe_rotations,
                                 valid=r.map_state.valid.cpu()) for r in results])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def parallel_four_ranks(torch, scene, device: str = "cuda"):
    """PARALLEL_RANKS Gloo ranks on the one card (torch.multiprocessing,
    spawn): each rank's block of the sharded VO step against run_vo of the
    clip's first PARALLEL_FRAMES frames, and the batched flagship on a (2, 2)
    mesh against run_point_cloud_fused of each clip."""
    import pickle
    import types

    import numpy as np
    import torch.multiprocessing as mp

    from slamtpu_torch.parallel.distributed import _free_port
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig, run_point_cloud_fused
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo

    frames, cam = scene.frames, scene.intrinsics
    run = run_vo(frames[:PARALLEL_FRAMES], cam, VoConfig(), chunk_size=CHUNK, seed=0, device=device)
    fused = [run_point_cloud_fused(frames[a:b], cam, PointCloudConfig(), chunk_size=CHUNK, seed=i, device=device)
             for i, (a, b) in enumerate(PARALLEL_CLIPS)]

    with tempfile.TemporaryDirectory() as out_dir:
        np.save(os.path.join(out_dir, "frames.npy"), frames)
        t0 = time.perf_counter()
        ctx = mp.start_processes(_parallel_rank, args=(PARALLEL_RANKS, _free_port(), out_dir, device, cam,
                                                       PARALLEL_FRAMES, PARALLEL_CLIPS, CHUNK),
                                 nprocs=PARALLEL_RANKS, join=False, start_method="spawn")
        deadline = time.perf_counter() + PARALLEL_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):  # raises when a rank fails
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"the {PARALLEL_RANKS} ranks did not finish in {PARALLEL_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        wall_s = time.perf_counter() - t0
        ranks = []
        for r in range(PARALLEL_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))

    per_rank = PARALLEL_FRAMES // PARALLEL_RANKS
    got = {k: np.concatenate([r["vo"][k] for r in ranks]) for k in ranks[0]["vo"]}
    gaps = _check_sharded_vo(got, run, f"{PARALLEL_RANKS}-rank sharded_vo_step", 1e-5, 1e-4)
    for r in ranks:
        if r["slice"] != (r["rank"] * per_rank, (r["rank"] + 1) * per_rank):
            raise AssertionError(f"rank {r['rank']} covers {r['slice']}")
    batched = []
    for b, ref in enumerate(fused):
        mine = types.SimpleNamespace(**ranks[0]["batched"][b])
        mine.map_state = types.SimpleNamespace(valid=mine.valid)
        batched.append(_check_flagship(mine, ref, f"{PARALLEL_RANKS}-rank batched clip {b} vs fused"))
    r0 = ranks[0]
    coll = {phase: {k: sum(v) for k, v in r0[f"{phase}_collectives"].items()} for phase in ("vo", "batched")}
    share = {phase: sum(coll[phase].values()) / r0[f"{phase}_s"] for phase in ("vo", "batched")}
    log(f"parallel, {PARALLEL_RANKS} Gloo ranks sharing the card: {wall_s:.2f} s from spawn to the last exit; "
        f"sharded_vo_step (1, {PARALLEL_RANKS}) on {PARALLEL_FRAMES} frames in {[round(r['vo_s'], 4) for r in ranks]} s "
        f"a rank = {PARALLEL_FRAMES / max(r['vo_s'] for r in ranks):.2f} frames/s; each block equal to run_vo's "
        f"(success, matches, keyframes; rotations within {gaps['rotation_max_abs_diff']:.3g}, positions "
        f"{gaps['position_rel_gap']:.3g} relative); rank 0's collectives {coll['vo']} s, "
        f"{100 * share['vo']:.1f} % of its step; batched flagship (2, 2) on clips {list(PARALLEL_CLIPS)} in "
        f"{[round(r['batched_s'], 4) for r in ranks]} s, vs fused {batched}; rank 0's collectives "
        f"{coll['batched']} s, {100 * share['batched']:.1f} %; launches per rank "
        f"{[r['vo_launches'] for r in ranks]} / {[r['batched_launches'] for r in ranks]}")
    paths = {"parallel_4rank_sharded_vo_per_rank": r0["vo_launches"],
             "parallel_4rank_batched_flagship_per_rank": r0["batched_launches"]}
    return paths, dict(wall_s=wall_s, vo_s=[r["vo_s"] for r in ranks], batched_s=[r["batched_s"] for r in ranks],
                       vo_gaps=gaps, batched_vs_fused=batched, rank0_collectives_s=coll, rank0_collective_share=share,
                       rank0_collective_calls={k: {n: len(v) for n, v in r0[f"{k}_collectives"].items()}
                                               for k in ("vo", "batched")})


def parallel_phase(torch, scene, device: str = "cuda"):
    """The multi-device layer on the card: one NCCL rank, then four Gloo
    ranks sharing it."""
    t0 = time.perf_counter()
    paths, one = parallel_one_rank(torch, scene, device)
    paths4, four = parallel_four_ranks(torch, scene, device)
    seconds = time.perf_counter() - t0
    log(f"parallel phase: {seconds:.1f} s")
    return {**paths, **paths4}, dict(one_rank=one, four_ranks=four, seconds=seconds)


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
    depth_launches, depth = depth_phase(torch, scene)
    cli_launches, cli = cli_phase(torch, scene)
    option_launches, vo_options = vo_options_phase(torch, scene)
    paths = {"vo": vo_launches, "flagship": host_launches, "fused_flagship": launches,
             "depth_mapping": depth_launches, **cli_launches, **option_launches}
    if not all(counts == vo_launches for counts in paths.values()):
        raise AssertionError(f"the main paths launched the kernels differently: {paths}")
    for k in kernels:
        k["launches"] = launches.get(k["name"])
    parallel_launches, parallel = parallel_phase(torch, scene)
    paths.update(parallel_launches)  # held to their own counts: 9 for one rank, 2 a rank for four
    ba = ba_phase(torch)
    flagship_ref = flagship_reference_phase(torch)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the kernels' build included")
    log(json.dumps({"vo": vo, "flagship": flagship, "fused_flagship": fused, "depth": depth, "cli": cli,
                    "vo_options": vo_options, "parallel": parallel, "ba": ba,
                    "flagship_reference": flagship_ref, "compass": compass, "kernel_times_ms": times,
                    "launches_by_path": paths, "card": card}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
