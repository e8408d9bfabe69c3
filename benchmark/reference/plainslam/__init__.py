"""A frozen copy of the plain PyTorch path of slamtpu_torch (VO and the
fused flagship), the plain reference the benchmark compares the port with.

It was copied from the port's modules of the same paths, with three
changes: the two hand-written kernels are replaced by plain PyTorch
(`ops/corner.py`, `ops/patch.py`), the package root keeps only
`resolve_device` and leaves the TF32 switches to the caller, and the host
loop, checkpoints and exports of `pipeline/point_cloud.py` are left out.
It imports torch and numpy only, never the port, and it does not change
when the port does.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on: "cuda" unless the caller says otherwise."""
    return torch.device("cuda" if device is None else device)
