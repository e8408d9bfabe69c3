"""Point-cloud mapping CLI (counterpart of slamtpu/cli/point_cloud.py).

Usage:
  python -m slamtpu_torch.cli.point_cloud <input> [--max-features N] [--ba-interval N]
      [--prune-interval N] [--max-frames N] [--fused] [--global-ba]
      [--checkpoint DIR] [--resume DIR] [--rerun] [--rerun-save log.rrd] [--device cpu]

Writes point_cloud.ply, point_cloud.json and trajectory_output.json to the
working directory. Runs on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="slamtpu_torch point cloud mapping")
    parser.add_argument("input")
    parser.add_argument("--fx", type=float)
    parser.add_argument("--fy", type=float)
    parser.add_argument("--cx", type=float)
    parser.add_argument("--cy", type=float)
    parser.add_argument("--max-features", type=int, default=3000)
    parser.add_argument("--max-frames", type=int)
    parser.add_argument("--chunk", type=int, default=32)
    parser.add_argument("--ba-interval", type=int, default=5)
    parser.add_argument("--ba-window", type=int, default=5)
    parser.add_argument("--prune-interval", type=int, default=10)
    parser.add_argument("--map-capacity", type=int, default=65536)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", metavar="DIR", help="save resumable state at the end")
    parser.add_argument("--resume", metavar="DIR", help="resume from a saved checkpoint")
    parser.add_argument("--rerun", action="store_true", help="log to the Rerun viewer (needs the rerun package)")
    parser.add_argument("--rerun-save", metavar="PATH", help="write the Rerun log to a .rrd file")
    parser.add_argument(
        "--global-ba", action="store_true",
        help="finish with one global bundle adjustment over all keyframes and observations",
    )
    parser.add_argument(
        "--fused", action="store_true",
        help="keep phase 2 on the device (run_point_cloud_fused); incompatible with --rerun's "
        "per-keyframe logging",
    )
    parser.add_argument("--device", help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)
    if args.fused and (args.rerun or args.rerun_save):
        parser.error("--fused runs phase 2 on-device; use the default host loop for --rerun logging")

    from .. import resolve_device
    from ..feature.detector import OrbConfig
    from ..io.video import load_frames
    from ..mapping.keyframe import KeyframeConfig
    from ..odometry.camera import CameraIntrinsics
    from ..pipeline.point_cloud import PointCloudConfig, run_global_ba, run_point_cloud, run_point_cloud_fused
    from ..pipeline.vo import VoConfig
    from ..utils.metrics import StepTimer

    device = resolve_device(args.device)
    frames, cam, fps = load_frames(args.input, max_frames=args.max_frames)
    if args.fx is not None:
        cam = CameraIntrinsics(args.fx, args.fy or args.fx, args.cx or 0.0, args.cy or 0.0)
    elif cam is None:
        cam = CameraIntrinsics.kitti()
    print(f"Loaded {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]}")
    print(f"Intrinsics: fx={cam.fx} fy={cam.fy} cx={cam.cx} cy={cam.cy}")

    config = PointCloudConfig(
        vo=VoConfig(
            orb=OrbConfig(max_features=args.max_features),
            keyframe=KeyframeConfig(0.03, 0.03, 0.7, 3),
            fps=fps,
        ),
        ba_interval=args.ba_interval,
        ba_window=args.ba_window,
        prune_interval=args.prune_interval,
        map_capacity=args.map_capacity,
    )
    rerun_logger = None
    if args.rerun or args.rerun_save:
        from ..utils.metrics import RerunLogger

        rerun_logger = RerunLogger(save_path=args.rerun_save)
        if not rerun_logger.active:
            print("Warning: Rerun not available. pip install rerun-sdk")

    timer = StepTimer()
    timer.start()
    if args.fused:
        result = run_point_cloud_fused(frames, cam, config, chunk_size=args.chunk, seed=args.seed,
                                       resume_from=args.resume, device=device)
    else:
        result = run_point_cloud(frames, cam, config, chunk_size=args.chunk, seed=args.seed,
                                 resume_from=args.resume, rerun_logger=rerun_logger, device=device)
    elapsed = timer.stop(result.map_state)

    if args.global_ba:
        t = StepTimer()
        t.start()
        result, err_before, err_after = run_global_ba(result, cam, device=device)
        print(f"Global BA: reprojection error {err_before:.1f} -> {err_after:.1f} "
              f"({t.stop(result.map_state):.2f}s)")

    print("\nSummary")
    print(f"Frames: {result.total_frames}")
    print(f"Keyframes: {result.keyframe_rotations.shape[0]}")
    stable = result.stable_points()
    print(f"3D map points: {len(result.points())} ({len(stable)} stable)")
    print(f"Distance: {result.trajectory.total_distance():.2f}m")
    print(f"Bundle Adjustment runs: {result.ba_runs}")
    print(f"Time: {elapsed:.2f}s")
    print(f"Avg FPS: {result.total_frames / elapsed:.2f}")

    result.save()
    print("saved: point_cloud.ply, point_cloud.json, trajectory_output.json")
    if args.checkpoint:
        result.save_checkpoint(args.checkpoint)
        print(f"checkpoint saved: {args.checkpoint}")


if __name__ == "__main__":
    main()
