"""slamtpu_torch — the PyTorch/CUDA port of slamtpu for one NVIDIA H100.

The JAX package `slamtpu/` is the reference; this package mirrors its layout
(`feature/`, `ops/`, `odometry/`, `mapping/`, `pipeline/`, `io/`) so each
module's counterpart is found under the same path. It imports torch and
numpy only — never jax and nothing of `slamtpu`.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`). Kernel wrappers choose by the device of the tensor they
are given: a CUDA tensor launches the hand-written Hopper kernel (or
raises), a CPU tensor runs the plain PyTorch version. There is no fallback.

Full fp32 matmuls matter here: the bilinear pyramid resize is exact only
without TF32 (ops/pyramid.py), and the epipolar algebra needs every digit
(ops/epipolar.py). Importing the package therefore sets
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default, made
explicit). No convolution runs here, so cuDNN's TF32 switch is left alone;
the blur is written as shifted-slice sums for that reason.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False

__all__ = ["resolve_device"]


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
