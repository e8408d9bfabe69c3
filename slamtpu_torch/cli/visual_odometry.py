"""Full VO pipeline CLI (counterpart of slamtpu/cli/visual_odometry.py).

Usage:
  python -m slamtpu_torch.cli.visual_odometry <input> [--fx F --fy F --cx F --cy F]
      [--max-features N] [--chunk N] [--output trajectory_output.json]
      [--config slam.json] [--plot traj.png] [--gt poses.txt] [--device cpu]
      [--features orb|superpoint_lightglue] [--weights superpoint_v1.pth superpoint_lightglue.pth]

<input>: any spec of io/video.py::load_frames (a KITTI sequence directory,
an image directory, a video file, "synthetic:<T>[x<H>x<W>]" or a .npy
stack). Without --fx the intrinsics are the input's own (a KITTI
sequence's P0) or the KITTI preset. Runs on the card unless --device says
otherwise. `--features superpoint_lightglue` runs the learned frontend
(SuperPoint at 2048 keypoints and LightGlue, bfloat16 on CUDA) with the
published weight files given by --weights (without them, weights drawn
from --seed: a timing run whose matches are noise).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="slamtpu_torch visual odometry")
    parser.add_argument("input")
    parser.add_argument("--fx", type=float)
    parser.add_argument("--fy", type=float)
    parser.add_argument("--cx", type=float)
    parser.add_argument("--cy", type=float)
    parser.add_argument("--max-features", type=int, default=1000)
    parser.add_argument("--max-frames", type=int)
    parser.add_argument("--chunk", type=int, default=32, help="frames per frontend call")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", default="trajectory_output.json")
    parser.add_argument("--config", metavar="JSON", help="SlamConfig file (utils/config.py)")
    parser.add_argument("--plot", metavar="PNG", help="write the top-down X-Z trajectory plot (needs cv2)")
    parser.add_argument(
        "--gt", metavar="POSES_TXT",
        help="KITTI ground-truth pose file; prints ATE (Sim3-aligned, the monocular convention) "
        "over the trajectory's keyframes",
    )
    parser.add_argument("--device", help="torch device (default: cuda; raises without one)")
    parser.add_argument("--features", choices=("orb", "superpoint_lightglue"), default="orb",
                        help="the frontend: ORB and Hamming matching, or SuperPoint and LightGlue")
    parser.add_argument("--weights", nargs=2, metavar=("SUPERPOINT_PTH", "LIGHTGLUE_PTH"),
                        help="superpoint_v1.pth and superpoint_lightglue.pth for --features superpoint_lightglue")
    args = parser.parse_args(argv)
    if args.weights and args.features != "superpoint_lightglue":
        parser.error("--weights is for --features superpoint_lightglue")

    import dataclasses

    from .. import resolve_device
    from ..feature.detector import OrbConfig
    from ..io.video import load_frames
    from ..odometry.camera import CameraIntrinsics
    from ..pipeline.vo import VoConfig, run_vo
    from ..utils.metrics import StepTimer

    device = resolve_device(args.device)
    frames, cam, fps = load_frames(args.input, max_frames=args.max_frames)
    if args.fx is not None:
        cam = CameraIntrinsics(args.fx, args.fy or args.fx, args.cx or 0.0, args.cy or 0.0)
    elif cam is None:
        cam = CameraIntrinsics.kitti()
    print(f"Loaded {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]}")
    print(f"Intrinsics: fx={cam.fx} fy={cam.fy} cx={cam.cx} cy={cam.cy}")

    if args.config:
        from ..utils.config import load_config

        config = dataclasses.replace(load_config(args.config).vo(), fps=fps)
    else:
        config = VoConfig(orb=OrbConfig(max_features=args.max_features), fps=fps)
    frontend = None
    if args.features == "superpoint_lightglue":
        import torch

        from ..feature.learned import LearnedFrontend

        config = dataclasses.replace(config, features="superpoint_lightglue",
                                     ransac=dataclasses.replace(config.ransac, octave_sigma=False))
        if args.weights:
            superpoint, lightglue = (torch.load(path, map_location="cpu", weights_only=True) for path in args.weights)
        else:
            superpoint = lightglue = None
            print(f"No --weights: SuperPoint and LightGlue weights drawn from seed {args.seed} (matches are noise)")
        frontend = LearnedFrontend(superpoint, lightglue, seed=args.seed, device=device)
    timer = StepTimer()
    timer.start()
    run = run_vo(frames, cam, config, chunk_size=args.chunk, seed=args.seed, device=device, frontend=frontend)
    elapsed = timer.stop()  # run_vo returns host arrays: the device work is done

    print("\nSummary")
    print(f"Total frames: {run.total_frames}")
    print(f"Successful poses: {run.successful_frames}")
    print(f"Failed poses: {run.failed_frames}")
    print(f"Keyframes selected: {run.keyframe_count}")
    print(f"Keyframe ratio: {100.0 * run.keyframe_ratio:.1f}%")
    print(f"Total distance: {run.trajectory.total_distance():.2f}m")
    print(f"Total time: {elapsed:.2f}s")
    print(f"Average FPS: {run.total_frames / elapsed:.2f}")

    run.trajectory.save_to_file(args.output)
    print(f"\nTrajectory saved to: {args.output}")
    if args.plot:
        from ..utils.viz import save_trajectory_plot

        save_trajectory_plot(run.trajectory, args.plot)
        print(f"Trajectory plot saved to: {args.plot}")
    if args.gt:
        import numpy as np

        from ..io.kitti import load_poses
        from ..utils.evaluate import ate_rmse

        gt_poses = load_poses(args.gt)
        # Trajectory points number frames from 1 (point 0 is the frame-0
        # origin). Frames beyond the ground-truth file are a sequence
        # mismatch: score only the covered prefix and say so.
        est, gt, dropped = [], [], 0
        for p in run.trajectory.points:
            idx = max(p.frame - 1, 0)
            if idx >= gt_poses.shape[0]:
                dropped += 1
                continue
            est.append(p.position)
            gt.append(gt_poses[idx, :3, 3])
        if dropped:
            print(
                f"Warning: ground-truth file has {gt_poses.shape[0]} poses but the "
                f"trajectory reaches frame {run.trajectory.points[-1].frame}; "
                f"{dropped} keyframes beyond it were excluded from the ATE"
            )
        if len(est) < 2:
            print("ATE vs ground truth: not enough overlapping keyframes")
        else:
            ate = ate_rmse(np.asarray(est), np.asarray(gt), align="sim3")
            print(f"ATE vs ground truth (Sim3-aligned, {len(est)} keyframes): {ate:.3f} m")


if __name__ == "__main__":
    main()
