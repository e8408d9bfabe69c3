"""Whole clips through the fused flagship `run_point_cloud_fused`, one
clip a request (a closed loop with one client), each request with its own
RANSAC seed. The map is copied to the host inside the request, as a user
reading the point cloud gets it. The check re-runs the sampled request
through the reference's `run_point_cloud_fused` and reads the trajectory
layer (the reference-style trajectory, which advances on keyframes with
each keyframe pair's pose) and the mapping layer (keyframe poses, BA runs,
the map's valid landmarks and their positions), and holds the port's run
to the scene's ground truth: pair success, keyframe rotations, BA run."""

from __future__ import annotations

import numpy as np

from benchmark import compare, programs, settings


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device, program=None):
        self.prog = program or programs.port()
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.frames = scene.frames[: traffic["clip_frames"]]
        self.scene_rotations = scene.rotations[: traffic["clip_frames"]]

    def _run(self, prog, request_seed: int) -> dict:
        cfg = settings.build(prog.PointCloudConfig, self.config["point_cloud"])
        res = prog.run_point_cloud_fused(self.frames, prog.CameraIntrinsics(**self.config["camera"]), cfg,
                                         chunk_size=self.traffic["chunk_size"], seed=request_seed,
                                         device=self.device)
        m = res.map_state
        return dict(
            ba_runs=res.ba_runs, pairs=res.total_frames - 1, successful=res.successful_frames,
            kf_frames=np.asarray(res.keyframe_frame_idx), kf_rotations=np.asarray(res.keyframe_rotations),
            kf_translations=np.asarray(res.keyframe_translations),
            traj_frames=np.array([p.frame for p in res.trajectory.points]),
            traj_pos=np.array([p.position for p in res.trajectory.points], np.float64),
            valid=m.valid.cpu().numpy(), ids=m.ids.cpu().numpy(), positions=m.positions.cpu().numpy(),
        )

    def request(self, i: int) -> dict:
        s = programs.request_seed(self.seed, i)
        n = len(self.frames)
        return dict(frames=n, detected=list(range(n)), answer=(s, self._run(self.prog, s)))

    def warmup(self) -> None:
        self.request(-1)

    def check(self, answer, reference) -> dict:
        s, port = answer
        ref = self._run(reference, s)
        return {**compare.trajectory(port["traj_frames"], port["traj_pos"], ref["traj_frames"], ref["traj_pos"]),
                **compare.mapping(port, ref),
                "gt_fail_share": 1.0 - port["successful"] / max(port["pairs"], 1),
                "gt_no_ba_run": float(port["ba_runs"] == 0),
                **compare.keyframe_ground_truth(port["kf_frames"], port["kf_rotations"], self.scene_rotations)}
