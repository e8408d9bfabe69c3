"""Depth estimation CLI (counterpart of slamtpu/cli/depth_estimation.py).

Usage:
  python -m slamtpu_torch.cli.depth_estimation <input> --encoder encoder.pth \
      --decoder depth.pth [--width 640 --height 192] [--save DIR]
      [--skip-frames N] [--max-frames N] [--random-init] [--device cpu]
      [--fuse-vo cloud.ply] [--rerun] [--rerun-save log.rrd]
  python -m slamtpu_torch.cli.depth_estimation <input> \
      --model depth_anything_v2_vitl --checkpoint depth_anything_v2_vitl.pth
      [--input-size 518] [...]

--model picks the network: MonoDepth2 `mono_640x192` (the default; its
sigmoid disparity at --width x --height) or Depth Anything V2 Large
(`depth_anything_v2_vitl`: relative inverse depth at upstream's
lower-bound size of --input-size, 518x1708 for KITTI's 1241x376; a
checkpoint in upstream's layout by --checkpoint). Depth Anything's output
is affine-invariant, so --fuse-vo, which reads metric-like depth, takes
MonoDepth2 only.

Prints the inference time per frame of each batch and an average-FPS
summary. On CUDA (the default device) the defaults are batch 64 and bf16;
on the CPU batch 8 and f32. Without checkpoints, --random-init runs the
architecture with random weights (timing and smoke only). <input> is any
spec of io/video.py::load_frames. --rerun logs each frame and its colored
depth to the Rerun viewer; without the rerun package it prints a notice
and runs on with no logger.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

MODELS = ("mono_640x192", "depth_anything_v2_vitl")


def depth_fn_for(model, height: int, width: int):
    """One [H, W] frame -> [height, width] f32 depth on the model's device:
    disp_to_depth of `model.predict_raw`, upsampled bilinearly (half-pixel
    centres) from the model's size."""
    from ..pipeline.depth_mapping import disp_to_depth

    def depth_fn(frame):
        depth = disp_to_depth(model.predict_raw(frame))
        return F.interpolate(depth[None, None], size=(height, width), mode="bilinear", align_corners=False)[0, 0]

    return depth_fn


def main(argv=None):
    parser = argparse.ArgumentParser(description="slamtpu_torch monocular depth estimation")
    parser.add_argument("input")
    parser.add_argument("--model", choices=MODELS, default=MODELS[0], help="the network (default: %(default)s)")
    parser.add_argument("--encoder", help="MonoDepth2's encoder checkpoint")
    parser.add_argument("--decoder", help="MonoDepth2's depth decoder checkpoint")
    parser.add_argument("--checkpoint", help="Depth Anything V2's checkpoint (upstream's state dict layout)")
    parser.add_argument("--input-size", type=int, default=518,
                        help="Depth Anything V2's resize: both sides at least this, multiples of 14")
    parser.add_argument("--bf16", action="store_true", default=None,
                        help="run the network in bfloat16 (default on CUDA); --f32 opts out")
    parser.add_argument("--f32", action="store_true", help="force float32 inference (overrides the CUDA bf16 default)")
    parser.add_argument("--random-init", action="store_true",
                        help="run with random weights (no checkpoints; smoke/timing)")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=192)
    parser.add_argument("--save", metavar="DIR", help="write colored depth PNGs (needs cv2)")
    parser.add_argument("--rerun", action="store_true", help="log frames + colored depth to the Rerun viewer")
    parser.add_argument("--rerun-save", metavar="PATH", help="write the Rerun log to a .rrd file")
    parser.add_argument("--skip-frames", type=int, default=0)
    parser.add_argument("--max-frames", type=int)
    parser.add_argument("--batch", type=int, default=None,
                        help="frames per inference call (default: 64 on CUDA, else 8)")
    parser.add_argument("--fuse-vo", metavar="PLY", help="also run VO and export a semi-dense world-frame cloud to PLY")
    parser.add_argument("--fx", type=float)
    parser.add_argument("--fy", type=float)
    parser.add_argument("--cx", type=float)
    parser.add_argument("--cy", type=float)
    parser.add_argument("--device", help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)

    from ..io.video import load_frames

    dav2 = args.model == "depth_anything_v2_vitl"
    if dav2 and args.fuse_vo:
        parser.error("--fuse-vo takes MonoDepth2's depth; Depth Anything V2's inverse depth is defined only up to "
                     "scale and shift, and aligning it to VO is not supported")
    if not args.random_init and not (args.checkpoint if dav2 else args.encoder and args.decoder):
        parser.error("provide --checkpoint (Depth Anything V2), --encoder/--decoder checkpoints (MonoDepth2) "
                     "or --random-init")
    rerun_logger = None
    if args.rerun or args.rerun_save:
        from ..utils.metrics import RerunLogger

        rerun_logger = RerunLogger(save_path=args.rerun_save)
        if not rerun_logger.active:
            print("rerun package not available; --rerun ignored")
            rerun_logger = None

    device = resolve_device(args.device)
    on_cuda = device.type == "cuda"
    if args.batch is None:
        args.batch = 64 if on_cuda else 8
    if args.f32:
        args.bf16 = False
    elif args.bf16 is None:
        args.bf16 = on_cuda

    frames, _, _ = load_frames(args.input, max_frames=args.max_frames, skip_frames=args.skip_frames)
    print(f"Loaded {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]}")

    dtype = torch.bfloat16 if args.bf16 else None
    if dav2:
        from ..depth.depth_anything import DepthAnythingV2

        state = None if args.random_init else torch.load(args.checkpoint, map_location="cpu", weights_only=True)
        model = DepthAnythingV2(state_dict=state, input_size=args.input_size, compute_dtype=dtype, device=device)
    else:
        from ..depth.monodepth2 import MonoDepth2

        model = MonoDepth2(
            encoder_path=args.encoder if not args.random_init else None,
            depth_path=args.decoder if not args.random_init else None,
            width=args.width,
            height=args.height,
            compute_dtype=dtype,
            device=device,
        )

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    times = []  # (ms_per_computed_frame, is_padded_tail)
    for start in range(0, frames.shape[0], args.batch):
        block = frames[start : start + args.batch]
        n_real = block.shape[0]
        if n_real < args.batch:
            # Pad the ragged tail to the steady batch shape, as the JAX CLI
            # does, so every call computes the same shape.
            block = np.concatenate([block, np.repeat(block[-1:], args.batch - n_real, axis=0)])
        sync()
        t0 = time.perf_counter()
        model.predict(block)
        sync()
        ms = (time.perf_counter() - t0) * 1000.0
        block = block[:n_real]
        # Per-frame cost divides by the frames computed (args.batch when padded).
        ms_frame = ms / args.batch if n_real < args.batch else ms / n_real
        times.append((ms_frame, n_real < args.batch))
        print(f"Frames {start}-{start + n_real - 1}: {ms_frame:.1f} ms/frame")
        colored = None
        if args.save or rerun_logger is not None:
            colored = model.predict_colored(block)
        if rerun_logger is not None:
            for i in range(block.shape[0]):
                rerun_logger.set_frame(start + i)
                rerun_logger.log_depth(block[i], colored[i], start + i)
        if args.save:
            import cv2

            os.makedirs(args.save, exist_ok=True)
            for i in range(block.shape[0]):
                cv2.imwrite(os.path.join(args.save, f"depth_{start + i:05d}.png"),
                            cv2.cvtColor(colored[i], cv2.COLOR_RGB2BGR))

    # Summary: skip the first (warm-up) batch and padded tail blocks.
    steady = [t for t, padded in times[1:] if not padded]
    steady = steady or [t for t, _ in times]
    print("\nSummary")
    print(f"Frames processed: {frames.shape[0]}")
    print(f"Average inference: {np.mean(steady):.1f} ms/frame")
    print(f"Average FPS: {1000.0 / np.mean(steady):.2f}")

    if args.fuse_vo:
        from ..odometry.camera import CameraIntrinsics
        from ..pipeline.depth_mapping import run_depth_mapping

        cam = None
        if args.fx is not None:
            cam = CameraIntrinsics(args.fx, args.fy or args.fx, args.cx or 0.0, args.cy or 0.0)
        cam = cam or CameraIntrinsics.kitti()
        h, w = frames.shape[1:]
        res = run_depth_mapping(frames, cam, depth_fn_for(model, h, w), stride=8, device=device)
        res.save_ply(args.fuse_vo)
        print(f"Semi-dense cloud: {len(res.points)} points -> {args.fuse_vo}")


if __name__ == "__main__":
    main()
