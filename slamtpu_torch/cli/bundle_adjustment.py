"""Synthetic bundle-adjustment demo CLI (counterpart of
slamtpu/cli/bundle_adjustment.py): ground-truth points and poses,
perturbed initial estimates, full BA, then a local-BA window demo, on the
port's BundleAdjuster (f64 on the card unless --device says otherwise).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="slamtpu_torch bundle adjustment demo")
    parser.add_argument("--poses", type=int, default=4)
    parser.add_argument("--points", type=int, default=4)
    parser.add_argument("--iterations", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)

    import torch

    from ..mapping.bundle_adjustment import BundleAdjuster, Observation
    from ..odometry.camera import CameraIntrinsics
    from ..ops.lie import so3_exp

    def exp(v):
        return so3_exp(torch.from_numpy(np.asarray(v, np.float64))).numpy()

    rng = np.random.default_rng(args.seed)
    cam = CameraIntrinsics(500.0, 500.0, 320.0, 240.0)

    # Ground-truth scene.
    gt_points = np.stack(
        [rng.uniform(-2, 2, args.points), rng.uniform(-1.5, 1.5, args.points), rng.uniform(6, 12, args.points)], 1
    )
    gt_poses = [
        (exp(rng.normal(scale=0.02, size=3)), np.array([0.4 * i, 0.0, 0.0]) + rng.normal(scale=0.02, size=3))
        for i in range(args.poses)
    ]

    def project(pose, x):
        p = pose[0] @ x + pose[1]
        return np.array([cam.fx * p[0] / p[2] + cam.cx, cam.fy * p[1] / p[2] + cam.cy])

    observations = [
        Observation(i, j, project(gt_poses[i], gt_points[j]))
        for i in range(args.poses)
        for j in range(args.points)
    ]

    # Perturb: poses by +/-0.05, points by +/-0.15.
    noisy_poses = [(exp(rng.uniform(-0.05, 0.05, 3)) @ r, t + rng.uniform(-0.05, 0.05, 3)) for r, t in gt_poses]
    noisy_points = [p + rng.uniform(-0.15, 0.15, 3) for p in gt_points]

    ba = BundleAdjuster(cam, device=args.device).with_max_iterations(args.iterations)
    initial = ba.compute_total_error(noisy_poses, noisy_points, observations)
    print(f"Initial reprojection error: {initial:.4f}")

    start = time.perf_counter()
    new_poses, new_points, final = ba.optimize(noisy_poses, noisy_points, observations, True)
    ms = (time.perf_counter() - start) * 1000.0
    print(f"Final reprojection error: {final:.6f}")
    print(f"Error reduction: {100.0 * (1.0 - final / initial):.1f}%")
    print(f"Optimization time: {ms:.1f} ms")

    # Local BA demo with window 2.
    _, _, local_err = ba.local_bundle_adjustment(noisy_poses, noisy_points, observations, 2)
    print(f"Local BA (window=2) final error: {local_err:.6f}")


if __name__ == "__main__":
    main()
