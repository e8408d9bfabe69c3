"""The two programs a driver can run: the port (the system under test) and
the plain reference, behind the same names, and the host answers the
comparison reads from their results."""

from __future__ import annotations

import types

import numpy as np

_NAMES = {
    "pipeline.vo": ("VoConfig", "run_vo", "run_vo_batched"),
    "pipeline.point_cloud": ("PointCloudConfig", "run_point_cloud_fused"),
    "odometry.camera": ("CameraIntrinsics",),
}


def _namespace(package: str) -> types.SimpleNamespace:
    import importlib

    ns = {}
    for module, names in _NAMES.items():
        mod = importlib.import_module(f"{package}.{module}")
        ns.update({n: getattr(mod, n) for n in names})
    return types.SimpleNamespace(**ns)


def port() -> types.SimpleNamespace:
    """slamtpu_torch, the PyTorch and CUDA port."""
    return _namespace("slamtpu_torch")


def reference() -> types.SimpleNamespace:
    """The plain reference (benchmark/reference/plainslam)."""
    return _namespace("benchmark.reference.plainslam")


def request_seed(seed: int, i: int) -> int:
    """The RANSAC seed of request i of a run seeded `seed` (non-negative,
    under 2**63)."""
    return int(np.random.SeedSequence([int(seed), int(i) + 1]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def vo_answer(run) -> dict:
    """The host answer of one VoRun: per-pair success and poses, and the
    trajectory's frames and positions."""
    return dict(
        success=np.asarray(run.success, bool),
        rotations=np.asarray(run.rotations),
        translations=np.asarray(run.translations),
        traj_frames=np.array([p.frame for p in run.trajectory.points]),
        traj_pos=np.array([p.position for p in run.trajectory.points], np.float64),
    )
