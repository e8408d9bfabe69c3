"""Batches of clips through `run_vo_batched`, one batch a request (a closed
loop with one client): B windows of the scene cut at the mix's offsets,
sequence b drawing from the request's seed + b. The check re-runs the
sampled request through the reference's `run_vo_batched`, reads the pose,
keyframe and trajectory layers of every sequence, and holds the port's
poses to the scene's ground truth; each number is the worst sequence's."""

from __future__ import annotations

import numpy as np

from benchmark import compare, programs, settings


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device, program=None):
        self.prog = program or programs.port()
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        n = traffic["clip_frames"]
        self.offsets = list(traffic["offsets"])
        self.frames = np.stack([scene.frames[o : o + n] for o in self.offsets])  # [B, T, H, W] host uint8
        self.gt = [compare.relative_rotations(scene.rotations[o : o + n]) for o in self.offsets]

    def _run(self, prog, request_seed: int) -> list:
        vo = settings.build(prog.VoConfig, self.config["vo"])
        runs = prog.run_vo_batched(self.frames, prog.CameraIntrinsics(**self.config["camera"]), vo,
                                   chunk_size=self.traffic["chunk_size"], seed=request_seed, device=self.device)
        return [programs.vo_answer(r) for r in runs]

    def request(self, i: int) -> dict:
        s = programs.request_seed(self.seed, i)
        n = self.frames.shape[1]
        detected = [o + j for o in self.offsets for j in range(n)]
        return dict(frames=len(detected), detected=detected, answer=(s, self._run(self.prog, s)))

    def warmup(self) -> None:
        self.request(-1)

    def check(self, answer, reference) -> dict:
        s, port = answer
        out = []
        for p, r, gt in zip(port, self._run(reference, s), self.gt, strict=True):
            out.append({**compare.pairs(p, r),
                        **compare.trajectory(p["traj_frames"], p["traj_pos"], r["traj_frames"], r["traj_pos"]),
                        **compare.ground_truth(p["success"], p["rotations"], gt)})
        return compare.worst(out)
