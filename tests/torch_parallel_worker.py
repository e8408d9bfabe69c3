"""One rank of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py): a process group, the port's parallel
runners on it, this rank's results pickled for the parent.

    python torch_parallel_worker.py <mode> <rank> <world> <port> <workdir> <device>

On the CPU every group is Gloo. On a card a one-process group is NCCL and
the ranks of a larger one share the card over Gloo. Modes:
  parallel - 4 ranks on the CPU, explicit arguments: the sharded VO step
             on a (1, 4) mesh (the port's draws at f64; the JAX draws at
             f32 with the state-dependent keyframe configuration;
             refine_matches), run_point_cloud_sharded on it, and
             run_point_cloud_batched on a (2, 2) mesh; inputs from
             <workdir>/inputs.npz;
  explicit - 4 ranks through initialize_multihost(coordinator, n, id);
  env      - 4 ranks through the SLAMTPU_* variables;
  single   - 1 process through initialize_multihost() with nothing set:
             the one-process group and its (1, 1) mesh;
  shared   - 4 ranks, explicit arguments, as "explicit", then
             run_point_cloud_batched on a (2, 2) mesh over the tiny clips
             of seeds 7 and 11.
The last four run the tiny clip of tests/distributed_worker.py and report
their local_time_slice, their block of the sharded step and its launches
of kernels K1 and K2.

Imports torch and the port only (no jax, no conftest). The parents start
the ranks with `spawn` and wait for them with `collect`.
"""

import os
import pickle
import socket
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from slamtpu_torch.feature.detector import OrbConfig  # noqa: E402
from slamtpu_torch.io.synthetic import render_sequence  # noqa: E402
from slamtpu_torch.mapping.keyframe import KeyframeConfig  # noqa: E402
from slamtpu_torch.odometry.camera import CameraIntrinsics  # noqa: E402
from slamtpu_torch.ops.corner import corner_response  # noqa: E402
from slamtpu_torch.ops.patch import extract_patches_batched  # noqa: E402
from slamtpu_torch.ops.ransac import RansacConfig  # noqa: E402
from slamtpu_torch.parallel import distributed as pdist  # noqa: E402
from slamtpu_torch.parallel.flagship import run_point_cloud_batched, run_point_cloud_sharded  # noqa: E402
from slamtpu_torch.parallel.mesh import make_mesh  # noqa: E402
from slamtpu_torch.parallel.sharded import sharded_vo_step  # noqa: E402
from slamtpu_torch.pipeline.point_cloud import PointCloudConfig  # noqa: E402
from slamtpu_torch.pipeline.vo import VoConfig  # noqa: E402

VO = VoConfig(orb=OrbConfig(max_features=200), ransac=RansacConfig(iters=150))
KF_STATE = KeyframeConfig(min_translation=5.0, min_rotation=10.0, max_frames=3)
FLAGSHIP = PointCloudConfig(
    vo=VoConfig(orb=OrbConfig(max_features=200), ransac=RansacConfig(iters=150),
                keyframe=KeyframeConfig(0.03, 0.03, 0.7, 3)),
    map_capacity=2048, max_obs_per_kf=256, max_ba_landmarks=512, max_ba_observations=1024,
)
TINY = dict(n_frames=8, height=120, width=160, n_points=400, step=0.5, seed=7)
TINY_VO = VoConfig(orb=OrbConfig(max_features=128), ransac=RansacConfig(iters=64))
SHARED_SEEDS = (7, 11)  # the tiny clips of mode "shared", run at seeds 0 and 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(extra=None) -> dict:
    """The environment without any process-group variable, plus `extra`."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SLAMTPU_") and k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                                                          "LOCAL_RANK")}
    return {**env, **(extra or {})}


def spawn(mode: str, world: int, workdir, env_for=lambda rank, port: {}, device: str = "cpu"):
    """Start `world` worker ranks on a free port, rank r with the variables
    env_for(r, port) added; their output goes to <workdir>/<mode>_rank<r>.log."""
    port = free_port()
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"{mode}_rank{rank}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(rank), str(world), str(port),
                                       str(workdir), device],
                                      stdout=log, stderr=subprocess.STDOUT, env=worker_env(env_for(rank, port))))
        log.close()
    return procs


def collect(procs, mode: str, workdir, timeout: float) -> list:
    """Wait for every rank (killing all on the first timeout) and load
    their results; a failed rank fails with its log."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    out = []
    for rank, p in enumerate(procs):
        log = open(os.path.join(workdir, f"{mode}_rank{rank}.log")).read()
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
        with open(os.path.join(workdir, f"{mode}_rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(result) -> dict:
    return {k: v.cpu().numpy() for k, v in result._asdict().items()}


def _flagship(res) -> dict:
    return dict(kf_idx=res.keyframe_frame_idx, kf_rot=res.keyframe_rotations, kf_trans=res.keyframe_translations,
                ba_runs=res.ba_runs, successful=res.successful_frames, valid=res.map_state.valid.cpu().numpy(),
                positions=res.map_state.positions.cpu().numpy(), n_obs=len(res.observations[0]))


def _parallel(workdir: str) -> dict:
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    cam = CameraIntrinsics(*inp["camera"].tolist())
    mesh = make_mesh(data=1)
    t0, t1 = pdist.local_time_slice(mesh, inp["frames7"].shape[0])
    block = lambda name: pdist.from_process_local(mesh, inp[name][None])  # noqa: E731
    out = dict(slice=(t0, t1))
    out["own_f64"] = _np(sharded_vo_step(mesh, block("frames7"), cam, VO, chunk_size=2, seed=0,
                                         pose_dtype=torch.float64, device="cpu"))
    out["kf_state"] = _np(sharded_vo_step(mesh, block("frames9"), cam, VoConfig(VO.orb, VO.ransac, KF_STATE),
                                          uniforms=torch.from_numpy(block("slot_draws9")), device="cpu"))
    out["refine"] = _np(sharded_vo_step(mesh, block("frames7"), cam, VoConfig(VO.orb, VO.ransac, refine_matches=True),
                                        seed=0, device="cpu"))
    out["sharded_flagship"] = _flagship(run_point_cloud_sharded(
        inp["frames7"], cam, mesh, FLAGSHIP, uniforms=torch.from_numpy(inp["pair_draws7"]), pose_dtype=torch.float64,
        device="cpu"))
    mesh22 = make_mesh(data=2)
    out["batched"] = [_flagship(r) for r in run_point_cloud_batched(
        np.stack([inp["frames7"], inp["frames11"]]), cam, mesh22, FLAGSHIP, seeds=[0, 1], device="cpu")]
    return out


def _tiny(mesh, device: str) -> dict:
    scene = render_sequence(**TINY)
    t0, t1 = pdist.local_time_slice(mesh, TINY["n_frames"])
    block = pdist.from_process_local(mesh, scene.frames[None, t0:t1], scene.frames[None].shape)
    before = corner_response.launches, extract_patches_batched.launches
    vo = _np(sharded_vo_step(mesh, block, scene.intrinsics, TINY_VO, seed=0, device=device))
    return dict(slice=(t0, t1), mesh=tuple(mesh.shape), vo=vo,
                vo_launches=(corner_response.launches - before[0], extract_patches_batched.launches - before[1]))


def main() -> None:
    mode, rank, world, port, workdir, device = sys.argv[1:7]
    rank, world = int(rank), int(world)
    backend = None if world == 1 else "gloo"
    if mode in ("parallel", "explicit", "shared"):
        got = pdist.initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device, backend=backend)
    else:  # "env" reads the SLAMTPU_* variables its parent set; "single" finds nothing set
        got = pdist.initialize_multihost(device=device, backend=backend)
    try:
        out = _parallel(workdir) if mode == "parallel" else _tiny(pdist.global_mesh(data=1), device)
        if mode == "single":
            scene = render_sequence(**TINY)
            mesh = make_mesh()
            out["default_mesh"] = tuple(mesh.shape)
            out["sharded_flagship"] = _flagship(run_point_cloud_sharded(scene.frames, scene.intrinsics, mesh, FLAGSHIP,
                                                                        device=device))
            out["batched"] = [_flagship(r) for r in run_point_cloud_batched(scene.frames[None], scene.intrinsics,
                                                                            mesh, FLAGSHIP, device=device)]
        if mode == "shared":
            scenes = [render_sequence(**{**TINY, "seed": s}) for s in SHARED_SEEDS]
            out["batched"] = [_flagship(r) for r in run_point_cloud_batched(
                np.stack([sc.frames for sc in scenes]), scenes[0].intrinsics, make_mesh(data=2), FLAGSHIP,
                seeds=list(range(len(scenes))), device=device)]
        out["rank_world"] = got
        out["backend"] = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(workdir, f"{mode}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
