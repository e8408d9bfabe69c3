"""Whole clips through `run_vo`, one clip a request (a closed loop with
one client). Every request sends the same frames with its own RANSAC seed.
The check re-runs the sampled request through the reference's `run_vo`
and reads the pose, keyframe and trajectory layers, and holds the port's
poses to the scene's ground truth."""

from __future__ import annotations

from benchmark import compare, programs, settings


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device, program=None):
        self.prog = program or programs.port()
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        n = traffic["clip_frames"]
        self.frames = scene.frames[:n]  # host uint8, as a user holds decoded frames
        self.gt = compare.relative_rotations(scene.rotations[:n])

    def _run(self, prog, request_seed: int) -> dict:
        vo = settings.build(prog.VoConfig, self.config["vo"])
        run = prog.run_vo(self.frames, prog.CameraIntrinsics(**self.config["camera"]), vo,
                          chunk_size=self.traffic["chunk_size"], seed=request_seed, device=self.device)
        return programs.vo_answer(run)

    def request(self, i: int) -> dict:
        s = programs.request_seed(self.seed, i)
        n = len(self.frames)
        return dict(frames=n, detected=list(range(n)), answer=(s, self._run(self.prog, s)))

    def warmup(self) -> None:
        self.request(-1)

    def check(self, answer, reference) -> dict:
        s, port = answer
        ref = self._run(reference, s)
        return {**compare.pairs(port, ref),
                **compare.trajectory(port["traj_frames"], port["traj_pos"], ref["traj_frames"], ref["traj_pos"]),
                **compare.ground_truth(port["success"], port["rotations"], self.gt)}
