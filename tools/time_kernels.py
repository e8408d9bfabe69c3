#!/usr/bin/env python3
"""Device times of kernels K1 and K2 of a checkout of the port, for
comparing two versions in one run on one card.

    python3 tools/time_kernels.py [--repo PATH] [--reps 4]

Imports `slamtpu_torch` from PATH (default: this checkout), renders the
first 32-frame chunk of bench.py's clip (1241x376, seed 0), builds its
8-level pyramid under five small intensity shifts, and times with
chip_smoke.py's method (CUDA events around the replay of a CUDA graph of
back-to-back launches, divided by their count):
  * each kernel per level through its per-level entry point
    (`corner_response`, `extract_patches_batched`), which every version has;
  * each kernel over the whole chunk through the multi-level entry point
    (`corner_response_levels`, `extract_patches_levels`) where the version
    has one.
Prints one JSON line with the times in ms and the card's name and power
limit. Run it for the parent and the change in turns (parent, change,
change, parent) within one call to compare them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.repo).resolve()))
    from slamtpu_torch import _build
    from slamtpu_torch.feature.detector import OrbConfig, _select_level, features_per_level
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.ops import corner, patch
    from slamtpu_torch.ops.brief import PATCH_RADIUS
    from slamtpu_torch.ops.pyramid import build_pyramid, gaussian_blur

    _build.build()
    cfg = OrbConfig()
    quotas = features_per_level(cfg.max_features, cfg.n_levels, cfg.scale_factor)
    subpix = [lv <= cfg.subpixel_max_octave for lv in range(cfg.n_levels)]
    thr = cfg.fast_threshold
    scene = render_sequence(n_frames=cs.CHUNK, height=cs.HEIGHT, width=cs.WIDTH, n_points=4000, step=0.8,
                            intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)
    base = torch.as_tensor(scene.frames).cuda().float()
    variants = [[x.contiguous() for x in build_pyramid(base + 0.25 * i, cfg.n_levels, cfg.scale_factor)]
                for i in range(5)]
    blurred = [[gaussian_blur(img) for img in pyr] for pyr in variants]
    starts = []
    for lv, img in enumerate(variants[0]):
        ranked, harris = corner.corner_response(img, thr, with_harris=True)
        xy_int = _select_level(ranked, quotas[lv], cfg.edge_threshold, harris if subpix[lv] else None)[0]
        starts.append((torch.round(xy_int).to(torch.int32) - PATCH_RADIUS).contiguous())

    def ms(fn, inputs):
        return cs.device_ms(torch, fn, inputs, args.reps)

    out = {"repo": args.repo, "card": cs.gpu_name_and_power()}
    out["k1_levels_ms"] = [ms(lambda p, lv=lv: corner.corner_response(p[lv], thr, subpix[lv]), variants)
                           for lv in range(cfg.n_levels)]
    out["k1_levels_sum_ms"] = sum(out["k1_levels_ms"])
    out["k2_levels_ms"] = [ms(lambda b, lv=lv: patch.extract_patches_batched(b[lv], starts[lv], PATCH_RADIUS),
                              blurred) for lv in range(cfg.n_levels)]
    out["k2_levels_sum_ms"] = sum(out["k2_levels_ms"])
    if hasattr(corner, "corner_response_levels"):
        out["k1_chunk_ms"] = ms(lambda p: corner.corner_response_levels(p, thr, subpix), variants)
        out["k2_chunk_ms"] = ms(lambda b: patch.extract_patches_levels(b, starts, PATCH_RADIUS), blurred)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
