#!/usr/bin/env python3
"""Device time of each hand-written kernel a chunk against its least time,
on one card.

    python3 tools/time_kernels.py [--repo PATH]

Imports `slamtpu_torch` from PATH (default: this checkout), so that two
versions can be compared in one call (parent, change, change, parent).
Renders the 257-frame 1241x376 clip of the VO cells' size (KITTI
intrinsics, 4000 landmarks, step 0.8, seed 0, noise 2.0; cached in
.scene_cache) and times, at its first 32-frame chunk's shapes:
  * K1 over the chunk's 8-level pyramid in one launch
    (`corner_response_levels`) and per level (`corner_response`);
  * K2 over the windows the detector selects on the 8 blurred levels in
    one launch (`extract_patches_levels`), per level
    (`extract_patches_batched`), and over the raw and blurred levels'
    windows in one 16-level launch (descriptor_bins=0);
  * N1 (`ops/five_point.py::_nullspace4`) on one pose chunk's hypotheses of
    each VO cell, systems of two nearby views.
A time is CUDA events around the replay of a CUDA graph of back-to-back
launches on distinct inputs, divided by their count (`device_ms`): a replay
runs no host code, so neither launch gaps nor allocations enter it. A bound
is the least time, the larger of bytes over HBM bandwidth and operations
over the FP32 peak, with K1's and K2's bytes and operations counted by
benchmark/inputs/kernel_counts.py from the launch's shapes and, for K1, the
compass candidates of these frames. Prints one JSON line: times and bounds
in ms, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# N1 per 5x9 system (an FMA counted as two): 45 products to build A^T, 440
# operations of Householder QR, 150 for the block reflector's T, 380 to form
# Q's last four columns; f32 bytes in (two [5, 2] samples) and out (a
# [4, 3, 3] basis).
NULLSPACE_OPS_PER_SYSTEM = 1015
NULLSPACE_BYTES_PER_SYSTEM = 80 + 144
NULLSPACE_CHUNKS = {"vo-clip257": (32, 64), "vo-batch4": (4, 32, 64)}  # hypotheses of one pose chunk
REPS = {"k1": 4, "k2": 10, "n1": 20}  # graph repetitions of the inputs, longer for the shorter kernels


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


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


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from benchmark.inputs import kernel_counts as kc

    sys.path.insert(0, str(Path(args.repo).resolve()))
    from slamtpu_torch import _build
    from slamtpu_torch.feature.detector import OrbConfig, _select_level, features_per_level
    from slamtpu_torch.io.synthetic import render_sequence_cached
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.ops import corner, five_point, patch
    from slamtpu_torch.ops.brief import PATCH_RADIUS
    from slamtpu_torch.ops.pyramid import build_pyramid, gaussian_blur

    def bound(n_bytes: float, ops: float = 0.0) -> dict:
        t_bytes, t_ops = n_bytes / kc.HBM_BYTES_PER_S * 1e3, ops / kc.FP32_FLOP_PER_S * 1e3
        return dict(bound_ms=max(t_bytes, t_ops), bound_by="operations" if t_ops > t_bytes else "bytes",
                    mb=n_bytes / 1e6, gflop=ops / 1e9)

    _build.build()
    cfg = OrbConfig()
    thr, size = cfg.fast_threshold, 2 * PATCH_RADIUS + 1
    flags = [lv <= cfg.subpixel_max_octave for lv in range(cfg.n_levels)]
    frames = render_sequence_cached(n_frames=257, height=376, width=1241, n_points=4000, step=0.8,
                                    intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0).frames[:32]
    base = torch.as_tensor(frames).cuda().float()
    # Distinct inputs: the same frames under small intensity shifts.
    pyramids = [[x.contiguous() for x in build_pyramid(base + 0.25 * i, cfg.n_levels, cfg.scale_factor)]
                for i in range(5)]
    blurred = [[gaussian_blur(x) for x in p] for p in pyramids]
    ranked, harris = corner.corner_response_levels(pyramids[0], thr, flags)
    quotas = features_per_level(cfg.max_features, cfg.n_levels, cfg.scale_factor)
    starts = [(torch.round(_select_level(r, q, cfg.edge_threshold, h)[0]).to(torch.int32) - PATCH_RADIUS).contiguous()
              for r, q, h in zip(ranked, quotas, harris)]
    shapes = [tuple(x.shape) for x in pyramids[0]]

    candidates = int(kc.compass_candidates(frames, cfg.n_levels, cfg.scale_factor, thr, "cuda").sum())
    k2_bytes = (sum(kc.k2_read_bytes(s, st, size) for s, st in zip(shapes, starts))
                + kc.k2_write_bytes(len(frames), sum(quotas), size))
    out = {"repo": args.repo, "card": gpu_name_and_power()}
    out["k1"] = dict(
        chunk_ms=device_ms(torch, lambda p: corner.corner_response_levels(p, thr, flags), pyramids, REPS["k1"]),
        levels_ms=[device_ms(torch, lambda p, lv=lv: corner.corner_response(p[lv], thr, flags[lv]), pyramids,
                             REPS["k1"]) for lv in range(cfg.n_levels)],
        pixels=kc.k1_pixels(shapes), candidates=candidates,
        **bound(kc.k1_bytes(shapes, flags), kc.k1_ops(kc.k1_pixels(shapes), candidates)))
    out["k2"] = dict(
        chunk_ms=device_ms(torch, lambda b: patch.extract_patches_levels(b, starts, PATCH_RADIUS), blurred,
                           REPS["k2"]),
        levels_ms=[device_ms(torch, lambda b, lv=lv: patch.extract_patches_batched(b[lv], starts[lv], PATCH_RADIUS),
                             blurred, REPS["k2"]) for lv in range(cfg.n_levels)],
        **bound(k2_bytes))
    out["k2_raw_and_blurred"] = dict(
        chunk_ms=device_ms(torch, lambda pb: patch.extract_patches_levels(pb[0] + pb[1], starts + starts, PATCH_RADIUS),
                           list(zip(pyramids, blurred)), REPS["k2"]),
        **bound(2 * k2_bytes))
    rng = np.random.default_rng(0)
    for cell, shape in NULLSPACE_CHUNKS.items():
        inputs = []
        for _ in range(5):
            x = np.stack([rng.uniform(-0.85, 0.9, (*shape, 5)), rng.uniform(-0.27, 0.27, (*shape, 5))], -1)
            inputs.append([torch.from_numpy(v.astype(np.float32)).cuda() for v in (x, x + rng.normal(0.0, 0.01, x.shape))])
        m = int(np.prod(shape))
        out[f"n1_{cell}"] = dict(chunk_ms=device_ms(torch, lambda p: five_point._nullspace4(*p), inputs, REPS["n1"]),
                                 systems=m, **bound(NULLSPACE_BYTES_PER_SYSTEM * m, NULLSPACE_OPS_PER_SYSTEM * m))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
