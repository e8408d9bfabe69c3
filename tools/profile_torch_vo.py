#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's VO goes, on one GPU.

    python3 tools/profile_torch_vo.py [--frames 257] [--chunk 32]

Runs slamtpu_torch.pipeline.vo.run_vo with VoConfig() defaults on bench.py's
rendered scene (1241x376, KITTI intrinsics, 4000 landmarks, step 0.8,
seed 0) three times after a warm-up:
  1. plain, host clock around the whole run -> frames/s;
  2. with each stage wrapped in a synchronizing timer (detector, matching,
     pose, keyframe scan + trajectory), so stage wall times add up to the
     run (the synchronizations cost a little time of their own);
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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=257)
    ap.add_argument("--chunk", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_vo: no CUDA device", file=sys.stderr)
        return 2

    from slamtpu_torch.feature.matcher import FeatureMatcher
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.pipeline import vo

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    scene = render_sequence(n_frames=args.frames, height=376, width=1241, n_points=4000, step=0.8,
                            intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)
    config = vo.VoConfig()

    def run():
        out = vo.run_vo(scene.frames, scene.intrinsics, config, chunk_size=args.chunk, device="cuda")
        torch.cuda.synchronize()
        return out

    run()  # warm-up: kernel build, cuBLAS / cuSOLVER handles
    t0 = time.perf_counter()
    result = run()
    wall = time.perf_counter() - t0
    print(json.dumps({"measure": "run", "card": card, "frames": args.frames, "chunk": args.chunk,
                      "wall_s": wall, "frames_per_s": args.frames / wall,
                      "success_rate": float(result.success.mean())}), flush=True)

    # Stage wall times: wrap the stage functions vo_frontend calls.
    stage_s = collections.Counter()

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[name] += time.perf_counter() - t
            return out
        return wrapper

    originals = dict(detect=vo.detect_and_compute, pose=vo.estimate_relative_pose,
                     keyframe=vo.keyframe_step, trajectory=vo.compose_relative_transforms,
                     match=FeatureMatcher.match_from_bits, filter=FeatureMatcher.filter_good_matches)
    vo.detect_and_compute = timed("detect", originals["detect"])
    vo.estimate_relative_pose = timed("pose", originals["pose"])
    vo.keyframe_step = timed("keyframe_scan", originals["keyframe"])
    vo.compose_relative_transforms = timed("trajectory", originals["trajectory"])
    FeatureMatcher.match_from_bits = timed("match", originals["match"])
    FeatureMatcher.filter_good_matches = timed("match", originals["filter"])
    try:
        t0 = time.perf_counter()
        run()
        staged_wall = time.perf_counter() - t0
    finally:
        vo.detect_and_compute = originals["detect"]
        vo.estimate_relative_pose = originals["pose"]
        vo.keyframe_step = originals["keyframe"]
        vo.compose_relative_transforms = originals["trajectory"]
        FeatureMatcher.match_from_bits = originals["match"]
        FeatureMatcher.filter_good_matches = originals["filter"]
    stages = {k: v * 1e3 for k, v in stage_s.most_common()}
    stages["other"] = staged_wall * 1e3 - sum(stages.values())
    print(json.dumps({"measure": "stages_ms_per_run", "card": card, "wall_ms": staged_wall * 1e3,
                      "stages": stages}), flush=True)

    # Device busy time and the heaviest kernels.
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
