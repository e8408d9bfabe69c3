#!/usr/bin/env python3
"""The port's VO on the card against the same VO on the host CPU, on the
same frames and the same RANSAC draws.

    python3 tools/vo_card_vs_cpu.py [--features 500 1000] [--frames 257]

For each feature count, runs slamtpu_torch.pipeline.vo.run_vo (chunk 32,
seed 0, fps 10: the VO CLI's settings at --max-features N) on bench.py's
rendered clip (1241x376, KITTI intrinsics, 4000 landmarks, step 0.8,
seed 0) once on the card and once on the CPU. A seed draws the same RANSAC
hypotheses on both (ops/ransac.py::pair_uniforms), so what differs is the
arithmetic. Prints, per feature count, one JSON object: each device's ATE
(Sim3, against the camera centres, as the VO CLI's --gt scores it), its
translation-direction and rotation errors against the ground truth (with
the pair of the largest rotation error); the pairs where
the devices disagree on success, keyframe flag or inlier count; the
largest difference of a rotation-matrix entry between them; and the pairs whose
translation directions differ by more than 1 degree, with each device's
error on them. Then the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--features", type=int, nargs="+", default=[500, 1000])
    ap.add_argument("--frames", type=int, default=257)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vo_card_vs_cpu: no CUDA device", file=sys.stderr)
        return 2

    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence_cached
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo
    from slamtpu_torch.utils.evaluate import ate_rmse

    scene = render_sequence_cached(n_frames=args.frames, height=376, width=1241, n_points=4000, step=0.8,
                                   intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)
    centres = -np.einsum("tji,tj->ti", scene.rotations, scene.translations)
    gt_dir = scene.rel_translations / np.linalg.norm(scene.rel_translations, axis=1, keepdims=True)

    def angle(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.degrees(np.arccos(np.clip((a * b).sum(-1), -1.0, 1.0)))

    def rotation_errors(rots, ref):
        """Geodesic angles (degrees) of rots^T ref, from the skew part and
        the trace together, so that f32 rotations near the identity do not
        read as ~0.05 degree."""
        d = np.einsum("tji,tjk->tik", np.asarray(rots, np.float64), ref)
        skew = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], 1)
        return np.degrees(np.arctan2(np.linalg.norm(skew, axis=1), np.trace(d, axis1=1, axis2=2) - 1.0))

    for feats in args.features:
        config = VoConfig(orb=OrbConfig(max_features=feats), fps=10.0)
        runs = {dev: run_vo(scene.frames, scene.intrinsics, config, chunk_size=32, seed=0, device=dev)
                for dev in ("cuda", "cpu")}
        out = {"features": feats}
        for dev, run in runs.items():
            est = np.asarray([p.position for p in run.trajectory.points])
            gt = centres[[max(p.frame - 1, 0) for p in run.trajectory.points]]
            ok = run.success.astype(bool)
            err = angle(run.translations, gt_dir)[ok]
            rot_err = rotation_errors(run.rotations, scene.rel_rotations)
            worst = int(np.argmax(np.where(ok, rot_err, -1.0)))
            out[dev] = dict(ate_m=ate_rmse(est, gt), successes=int(run.successful_frames),
                            keyframes=int(run.keyframe_count), t_dir_err_median=float(np.median(err)),
                            t_dir_err_max=float(err.max()), over_10=int((err > 10).sum()),
                            over_90=int((err > 90).sum()), rot_err_median=float(np.median(rot_err[ok])),
                            rot_err_max=float(rot_err[worst]), rot_err_max_pair=worst,
                            rot_over_1=int((rot_err[ok] > 1.0).sum()))
        g, c = runs["cuda"], runs["cpu"]
        t_diff = angle(g.translations, c.translations)
        split = np.nonzero(t_diff > 1.0)[0]
        out["pairs_success_differ"] = np.nonzero(g.success != c.success)[0].tolist()
        out["pairs_keyframe_differ"] = np.nonzero(g.is_keyframe != c.is_keyframe)[0].tolist()
        out["pairs_inliers_differ"] = int((g.num_inliers != c.num_inliers).sum())
        out["rotation_diff_max_abs"] = float(np.abs(g.rotations.astype(np.float64) - c.rotations).max())
        out["pairs_translation_differ_over_1deg"] = [
            dict(pair=int(i), diff_deg=float(t_diff[i]), cuda_err_deg=float(angle(g.translations[i], gt_dir[i])),
                 cpu_err_deg=float(angle(c.translations[i], gt_dir[i])),
                 inliers=[int(g.num_inliers[i]), int(c.num_inliers[i])]) for i in split]
        print(json.dumps(out), flush=True)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
