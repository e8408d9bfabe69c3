#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's MonoDepth2 goes, on one GPU.

    python3 tools/profile_torch_depth.py [--batches 8 64]

MonoDepth2 at bench.py's configuration (random weights from seed 0,
640x192, scale-0 disparity) on bench.py's rendered clip (1241x376, frames
from 1, gray repeated to RGB, f32 on the card), at f32 (TF32 off) and bf16,
for each batch:
  1. under torch.profiler, three calls of the whole forward (resize and
     network) after a warm-up -> device busy share of the wall time,
     kernel launches per call, device time per frame by kind of kernel
     (convolution, layout transposes, BatchNorm, other elementwise, resize,
     reflection pad, max pool, concatenation) and the heaviest kernels;
  2. the network alone on the resized input, in turns, with the input in
     channels-last layout (what the forward hands it, from NHWC frames) and
     NCHW-contiguous, each with cuDNN's autotuner (`cudnn.benchmark`) off
     (the package's setting) and on: median ms/frame over 9 calls, and peak
     memory above the inputs.
Prints one JSON object per measurement, with the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.inputs.depth_counts import kind_of  # noqa: E402  (the benchmark's kernel classes)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_depth: no CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from slamtpu_torch.depth.monodepth2 import MonoDepth2
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if 1 + 3 * max(args.batches) > 257:
        raise SystemExit("three clips of the largest batch must fit in the 257-frame clip")
    scene = render_sequence(n_frames=257, height=376, width=1241, n_points=4000, step=0.8,
                            intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)
    f32 = MonoDepth2(seed=0, device="cuda")
    models = {"f32": f32, "bf16": MonoDepth2(encoder=f32.encoder.state_dict(), decoder=f32.decoder.state_dict(),
                                             compute_dtype=torch.bfloat16, device="cuda")}

    for batch in args.batches:
        clips = [torch.as_tensor(scene.frames[1 + i * batch : 1 + (i + 1) * batch]).cuda()[..., None]
                 .expand(-1, -1, -1, 3).float().contiguous() for i in range(3)]
        for name, model in models.items():
            model._forward(clips[0] + 0.25)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for clip in clips:
                    model._forward(clip)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            by_kind, by_name = collections.Counter(), collections.Counter()
            for e in kernels:
                us = e.time_range.elapsed_us()
                by_kind[kind_of(e.name)] += us
                by_name[e.name[:100]] += us
            frames = batch * len(clips)
            busy = sum(by_kind.values())
            print(json.dumps({
                "measure": "forward_profile", "card": card, "dtype": name, "batch": batch,
                "wall_ms_per_frame": wall * 1e3 / frames, "device_busy_ms_per_frame": busy / 1e3 / frames,
                "device_busy_share": busy / 1e6 / wall, "launches_per_call": len(kernels) / len(clips),
                "ms_per_frame_by_kind": {k: v / 1e3 / frames for k, v in by_kind.most_common()},
                "top_kernels_ms_per_frame": {k: v / 1e3 / frames for k, v in by_name.most_common(8)},
            }), flush=True)

            # The network alone, channels-last vs NCHW, autotuner off / on, in turns.
            x = torch.nn.functional.interpolate(clips[0].permute(0, 3, 1, 2), size=(model.height, model.width),
                                                mode="bilinear", align_corners=False, antialias=True) / 255.0
            if model.compute_dtype is not None:
                x = x.to(model.compute_dtype)
            inputs = {"channels_last": x.contiguous(memory_format=torch.channels_last), "nchw": x.contiguous()}
            variants = [(layout, bench) for bench in (False, True) for layout in inputs]
            samples = collections.defaultdict(list)
            peaks = {}
            try:
                for rnd in range(3):
                    for layout, bench in (variants if rnd % 2 == 0 else variants[::-1]):
                        torch.backends.cudnn.benchmark = bench
                        key = f"{layout}{'+benchmark' if bench else ''}"
                        with torch.inference_mode():
                            model.decoder(model.encoder(inputs[layout]), scales=(0,))  # warm-up / autotune
                            torch.cuda.synchronize()
                            torch.cuda.reset_peak_memory_stats()
                            held = torch.cuda.memory_allocated()
                            for _ in range(3):
                                t0 = time.perf_counter()
                                model.decoder(model.encoder(inputs[layout]), scales=(0,))
                                torch.cuda.synchronize()
                                samples[key].append((time.perf_counter() - t0) * 1e3 / batch)
                        peaks[key] = max(peaks.get(key, 0.0), (torch.cuda.max_memory_allocated() - held) / 2**20)
            finally:
                torch.backends.cudnn.benchmark = False
            print(json.dumps({
                "measure": "network_layout_ab", "card": card, "dtype": name, "batch": batch,
                "ms_per_frame_median": {k: statistics.median(v) for k, v in samples.items()},
                "ms_per_frame_min_max": {k: [min(v), max(v)] for k, v in samples.items()},
                "peak_above_inputs_mib": peaks,
            }), flush=True)
        del clips
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
