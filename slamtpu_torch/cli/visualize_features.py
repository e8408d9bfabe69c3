"""Feature visualization CLI (counterpart of
slamtpu/cli/visualize_features.py).

Detects and matches consecutive frames; without a GUI it reports per-frame
keypoint and match counts and optionally writes match-overlay images
(needs cv2). The detector takes 32 frames a call. Runs on the card unless
--device says otherwise.
"""

from __future__ import annotations

import argparse

import numpy as np

CHUNK = 32  # frames per detector call, as run_vo's default chunk


def main(argv=None):
    parser = argparse.ArgumentParser(description="slamtpu_torch feature visualization")
    parser.add_argument("input")
    parser.add_argument("--max-features", type=int, default=500)
    parser.add_argument("--max-frames", type=int, default=100)
    parser.add_argument("--save-overlays", metavar="DIR", help="write match images (needs cv2)")
    parser.add_argument("--device", help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..feature.detector import OrbConfig, OrbFeatures, detect_and_compute
    from ..feature.matcher import FeatureMatcher
    from ..io.video import load_frames

    device = resolve_device(args.device)
    frames, _, _ = load_frames(args.input, max_frames=args.max_frames)
    config = OrbConfig(max_features=args.max_features)
    matcher = FeatureMatcher()

    parts = [detect_and_compute(torch.as_tensor(frames[s : s + CHUNK]).to(device).float(), config)
             for s in range(0, frames.shape[0], CHUNK)]
    feats = OrbFeatures(*[torch.cat(x) for x in zip(*parts)])
    counts = feats.count().cpu().numpy()
    total_matches = 0
    for t in range(1, frames.shape[0]):
        d1 = OrbFeatures(*[x[t - 1] for x in feats])
        d2 = OrbFeatures(*[x[t] for x in feats])
        good = matcher.filter_good_matches(matcher.match_descriptors(d1.descriptors, d2.descriptors, d1.mask, d2.mask))
        n = int(good.count())
        total_matches += n
        if t % 10 == 0 or t == 1:
            print(f"Frame {t:4} | keypoints {counts[t]:4} | good matches {n:4}")
        if args.save_overlays:
            _save_overlay(args.save_overlays, t, frames[t - 1], frames[t], d1, d2, good)

    print(f"\nFrames: {frames.shape[0]}")
    print(f"Mean keypoints/frame: {counts.mean():.1f}")
    print(f"Mean good matches/pair: {total_matches / max(frames.shape[0] - 1, 1):.1f}")


def _save_overlay(outdir, t, img1, img2, f1, f2, good):
    import os

    import cv2

    os.makedirs(outdir, exist_ok=True)
    canvas = cv2.cvtColor(np.concatenate([img1, img2], axis=1), cv2.COLOR_GRAY2BGR)
    w = img1.shape[1]
    live = good.mask.cpu().numpy()
    xy1 = f1.xy.cpu().numpy()[live]
    xy2 = f2.xy.cpu().numpy()[good.train_idx.cpu().numpy()[live]]
    for (x1, y1), (x2, y2) in zip(xy1, xy2):
        cv2.line(canvas, (int(x1), int(y1)), (int(x2) + w, int(y2)), (0, 255, 0), 1)
    cv2.imwrite(os.path.join(outdir, f"matches_{t:05d}.png"), canvas)


if __name__ == "__main__":
    main()
