"""slamtpu_torch — the PyTorch/CUDA port of slamtpu for one NVIDIA H100.

The JAX package `slamtpu/` is the reference; this package mirrors its layout
(`feature/`, `ops/`, `odometry/`, `mapping/`, `models/`, `depth/`,
`pipeline/`, `io/`, `utils/`, `cli/`) so each module's counterpart is found under the
same path. It imports torch and numpy only — never jax and nothing of
`slamtpu`.

The public API is re-exported flat at the package root: the 15 names of
the JAX package's root (`OrbDetector`, `PoseEstimator`, `Map`, ...) and
`DepthAnythingV2`, `LearnedFrontend` and `LearnedConfig` (SuperPoint +
LightGlue for `VoConfig(features="superpoint_lightglue")`), which the JAX
package does not have.
Each loads its module on first use, so `import slamtpu_torch` costs torch
and nothing more.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`). Kernel wrappers choose by the device of the tensor they
are given: a CUDA tensor launches the hand-written Hopper kernel (or
raises), a CPU tensor runs the plain PyTorch version. There is no fallback.

Full fp32 matmuls and convolutions matter here: the bilinear pyramid resize
is exact only without TF32 (ops/pyramid.py), the epipolar algebra needs
every digit (ops/epipolar.py), and MonoDepth2's f32 mode must compute what
the JAX package's f32 model computes (depth/monodepth2.py). PyTorch runs
cuDNN's f32 convolutions in TF32 (a 10-bit mantissa) by default, so
importing the package sets both `torch.backends.cuda.matmul.allow_tf32`
(PyTorch's default, made explicit) and `torch.backends.cudnn.allow_tf32`
to False. Reduced precision is asked for explicitly, as MonoDepth2's bf16
mode is.
"""

import importlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Flat public API: name -> the submodule that defines it, loaded on first use.
_EXPORTS = {
    "OrbDetector": "slamtpu_torch.feature.detector",
    "FeatureMatcher": "slamtpu_torch.feature.matcher",
    "Matches": "slamtpu_torch.feature.matcher",
    "CameraIntrinsics": "slamtpu_torch.odometry.camera",
    "PoseEstimator": "slamtpu_torch.odometry.pose",
    "Trajectory": "slamtpu_torch.odometry.trajectory",
    "TrajectoryPoint": "slamtpu_torch.odometry.trajectory",
    "KeyframeConfig": "slamtpu_torch.mapping.keyframe",
    "KeyframeSelector": "slamtpu_torch.mapping.keyframe",
    "Triangulator": "slamtpu_torch.mapping.triangulation",
    "MapPoint": "slamtpu_torch.mapping.triangulation",
    "Map": "slamtpu_torch.mapping.map",
    "BundleAdjuster": "slamtpu_torch.mapping.bundle_adjustment",
    "Observation": "slamtpu_torch.mapping.bundle_adjustment",
    "MonoDepth2": "slamtpu_torch.depth.monodepth2",
    "DepthAnythingV2": "slamtpu_torch.depth.depth_anything",
    "LearnedFrontend": "slamtpu_torch.feature.learned",
    "LearnedConfig": "slamtpu_torch.feature.learned",
}

__all__ = sorted(_EXPORTS) + ["resolve_device"]


def __getattr__(name: str):
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(f"module 'slamtpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module_name), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    this host has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "slamtpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host"
        )
    return dev
