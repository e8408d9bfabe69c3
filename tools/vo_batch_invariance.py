#!/usr/bin/env python3
"""Does a batch of B sequences compute what each sequence computes alone?

    python3 tools/vo_batch_invariance.py [--device cuda]

On the VO cells' 257-frame 1241x376 clip (KITTI intrinsics, 4000
landmarks, step 0.8, seed 0, noise 2.0; cached in .scene_cache), four
windows of 128 frames at offsets 0, 43, 86 and 129, chunk 32. Prints, for
a batch of 4 x 32 frames against the first 32 alone:
  - the pyramid built over the whole batch (one resize matmul per level
    for all frames) and built per sequence (`detect_and_compute(...,
    groups=B)`, what the batched frontend does): largest difference per
    level;
  - the GN polish's normal equations as a batched matmul and as summed
    products (what `ops/ransac.py::_gn_step` does on CUDA), on 31 random
    systems tiled 4x: largest difference of the Gauss-Newton step;
then `run_vo_batched` against `run_vo` of each window: whether success,
matches, keyframes and inlier counts are equal, and the largest rotation
and translation differences. On the CPU the same comparisons run with
the CPU's kernels (use a small --frames to keep it short).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OFFSETS, FRAMES, CHUNK = (0, 43, 86, 129), 128, 32  # the windows and the chunk


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from slamtpu_torch import _build
    from slamtpu_torch.io.synthetic import render_sequence_cached
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.ops.pyramid import build_pyramid
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo, run_vo_batched
    from tools.time_kernels import gpu_name_and_power

    dev = torch.device(args.device)
    if dev.type == "cuda":
        _build.build()
        print(gpu_name_and_power())
    scene = render_sequence_cached(n_frames=257, height=376, width=1241, n_points=4000, step=0.8,
                                   intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)
    offsets, frames, chunk = OFFSETS, FRAMES, CHUNK

    solo = torch.as_tensor(scene.frames[:chunk]).to(dev).float()
    batch = torch.cat([torch.as_tensor(scene.frames[o : o + chunk]).to(dev).float() for o in offsets])
    whole = build_pyramid(batch, 8, 1.2)
    alone = build_pyramid(solo, 8, 1.2)
    print("pyramid over the batch vs alone, largest difference per level:",
          [float((a[:chunk] - b).abs().max()) for a, b in zip(whole, alone)])
    grouped = [torch.cat(p) for p in zip(*(build_pyramid(x, 8, 1.2) for x in batch.chunk(len(offsets))))]
    print("pyramid per sequence vs alone:", [float((a[:chunk] - b).abs().max()) for a, b in zip(grouped, alone)])

    gen = torch.Generator().manual_seed(0)
    jac = torch.randn((chunk - 1, 6, 500), generator=gen).to(dev)
    res = torch.randn((chunk - 1, 500), generator=gen).to(dev)

    def step(j, r, summed: bool):
        if summed:
            jtj = torch.sum(j[..., :, None, :] * j[..., None, :, :], dim=-1)
            jtr = torch.sum(j * r[..., None, :], dim=-1)[..., None]
        else:
            jtj, jtr = j @ j.transpose(-1, -2), j @ r[..., None]
        damp = 1e-6 * jtj.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
        return torch.linalg.solve_ex(jtj + damp[..., None, None] * torch.eye(6, device=dev), -jtr)[0]

    tile = len(offsets)
    for summed in (False, True):
        a = step(jac, res, summed)
        b = step(jac.repeat(tile, 1, 1), res.repeat(tile, 1), summed)[: chunk - 1]
        print(f"GN step, normal equations {'as summed products' if summed else 'by batched matmul'}: "
              f"largest difference {float((a - b).abs().max())} ({tile}x the batch vs alone)")

    windows = np.stack([scene.frames[o : o + frames] for o in offsets])
    runs = run_vo_batched(windows, scene.intrinsics, VoConfig(), chunk_size=chunk, seed=0, device=dev)
    for b, run in enumerate(runs):
        one = run_vo(windows[b], scene.intrinsics, VoConfig(), chunk_size=chunk, seed=b, device=dev)
        equal = {f: bool(np.array_equal(getattr(run, f), getattr(one, f)))
                 for f in ("success", "num_matches", "is_keyframe", "num_inliers")}
        print(f"run_vo_batched sequence {b} vs run_vo of its window: {equal}; rotations "
              f"{float(np.abs(run.rotations - one.rotations).max())}, translations "
              f"{float(np.abs(run.translations - one.translations).max())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
