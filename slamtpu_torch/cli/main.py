"""Minimal smoke binary (counterpart of slamtpu/cli/main.py): open an
input, detect ORB features, report counts every 30 frames. The detector
takes 32 frames a call. Runs on the card unless --device says otherwise."""

from __future__ import annotations

import argparse

import numpy as np

CHUNK = 32  # frames per detector call, as run_vo's default chunk


def main(argv=None):
    parser = argparse.ArgumentParser(description="slamtpu_torch smoke test")
    parser.add_argument("input", nargs="?", default="synthetic:60")
    parser.add_argument("--max-features", type=int, default=500)
    parser.add_argument("--device", help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..feature.detector import OrbConfig, detect_and_compute
    from ..io.video import load_frames

    device = resolve_device(args.device)
    frames, _, _ = load_frames(args.input)
    print(f"Opened {args.input}: {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]}")

    config = OrbConfig(max_features=args.max_features)
    counts = np.concatenate([
        detect_and_compute(torch.as_tensor(frames[s : s + CHUNK]).to(device), config).count().cpu().numpy()
        for s in range(0, frames.shape[0], CHUNK)
    ])
    for f in range(0, frames.shape[0], 30):
        print(f"Frame {f:4}: {counts[f]} features")
    print(f"Done. mean features/frame: {counts.mean():.1f}")


if __name__ == "__main__":
    main()
