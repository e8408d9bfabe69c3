#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's flagship goes, on one GPU.

    python3 tools/profile_torch_point_cloud.py [--fused] [--frames 257] [--chunk 32]

Runs slamtpu_torch.pipeline.point_cloud.run_point_cloud (the host loop), or
run_point_cloud_fused with --fused, at bench.py's flagship configuration
(PointCloudConfig()) on bench.py's rendered scene (1241x376, KITTI
intrinsics, 4000 landmarks, step 0.8, seed 0) three times after a warm-up:
  1. plain, host clock around the whole run -> frames/s (frame pairs over
     wall time, as bench.py counts) and keyframes/s;
  2. with each stage wrapped in a synchronizing timer; host loop: frame-0
     detect, frontend (VO chunks), keyframe match, triangulate + insert,
     re-associate, observation log (the device -> host copies), window BA,
     prune; fused: frame-0 detect, frontend, keyframe match, triangulate,
     insert, re-associate, window BA, prune, free-table rebuild, host
     reconstruction (chain and log from the fetched step outputs). "other"
     is the rest of the run (for the fused runner: ring and descriptor-bit
     updates, observation compaction, stacking and the final fetch; the
     synchronizations cost a little time of their own); also the keyframe
     at which the map first has no free slot;
  3. under torch.profiler -> device busy time (sum of kernel durations),
     its share of the wall time, kernel launches, and the kernels that take
     the most device time.
Prints one JSON object per measurement, with the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STAGES = dict(detect_and_compute="frame-0 detect", vo_frontend="frontend", _match_keyframes="keyframe match",
              _triangulate_and_insert="triangulate+insert", _reassociate="re-associate",
              _log_observations="observation log", _run_window_ba="window BA", map_prune="prune")
FUSED_STAGES = dict(detect_and_compute="frame-0 detect", vo_frontend="frontend", _match_keyframes="keyframe match",
                    triangulate_points="triangulate", _map_insert_at="insert", _reassociate="re-associate",
                    _fused_window_ba="window BA", map_prune="prune", _free_table="free-table rebuild",
                    _phase2_host_reconstruct="host reconstruction")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--fused", action="store_true", help="profile run_point_cloud_fused instead of the host loop")
    ap.add_argument("--frames", type=int, default=257)
    ap.add_argument("--chunk", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_point_cloud: no CUDA device", file=sys.stderr)
        return 2

    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.pipeline import point_cloud as pc

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    scene = render_sequence(n_frames=args.frames, height=376, width=1241, n_points=4000, step=0.8,
                            intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)
    config = pc.PointCloudConfig()
    runner, stages_of = (pc.run_point_cloud_fused, FUSED_STAGES) if args.fused else (pc.run_point_cloud, STAGES)
    card = f"{card}; {runner.__name__}"

    def run():
        out = runner(scene.frames, scene.intrinsics, config, chunk_size=args.chunk, device="cuda")
        torch.cuda.synchronize()
        return out

    run()  # warm-up: kernel build, cuBLAS / cuSOLVER handles
    t0 = time.perf_counter()
    result = run()
    wall = time.perf_counter() - t0
    n_kf = len(result.keyframe_frame_idx)
    print(json.dumps({"measure": "run", "card": card, "frames": args.frames, "chunk": args.chunk, "wall_s": wall,
                      "frames_per_s": (args.frames - 1) / wall, "keyframes": n_kf, "keyframes_per_s": n_kf / wall,
                      "ba_runs": result.ba_runs, "landmarks": int(result.map_state.valid.sum()),
                      "success_rate": result.successful_frames / (args.frames - 1)}), flush=True)

    stage_s = collections.Counter()
    calls = collections.Counter()

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[name] += time.perf_counter() - t
            calls[name] += 1
            return out
        return wrapper

    originals = {attr: getattr(pc, attr) for attr in stages_of}
    for attr, name in stages_of.items():
        setattr(pc, attr, timed(name, originals[attr]))
    sizes = []  # map size after each keyframe's insert
    insert_attr = "_map_insert_at" if args.fused else "_triangulate_and_insert"
    timed_insert = getattr(pc, insert_attr)

    def insert_and_count(*a):
        out = timed_insert(*a)
        sizes.append(int((out[0] if args.fused else out).size()))
        return out

    setattr(pc, insert_attr, insert_and_count)
    try:
        t0 = time.perf_counter()
        run()
        staged_wall = time.perf_counter() - t0
    finally:
        for attr, fn in originals.items():
            setattr(pc, attr, fn)
    stages = {k: v * 1e3 for k, v in stage_s.most_common()}
    stages["other"] = staged_wall * 1e3 - sum(stages.values())
    full_at = next((k + 1 for k, n in enumerate(sizes) if n == config.map_capacity), None)
    print(json.dumps({"measure": "stages_ms_per_run", "card": card, "wall_ms": staged_wall * 1e3,
                      "stages": stages, "calls": dict(calls), "map_full_at_keyframe": full_at,
                      "map_size_every_10_keyframes": sizes[::10]}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    print(json.dumps({"measure": "device", "card": card, "wall_ms": prof_wall * 1e3,
                      "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e6 / prof_wall,
                      "kernel_launches": len(kernels),
                      "top_kernels_ms": {k: v / 1e3 for k, v in by_name.most_common(12)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
