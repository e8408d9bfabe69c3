"""Kernel K1 wrapper: fused FAST-9 + NMS + Harris corner ranking.

Replaces slamtpu/ops/pallas_corner.py::corner_response (the Pallas TPU
kernel). The CUDA source is csrc/corner_response.cu; its note says what
bounds it on the H100 and how the design answers that.

`corner_response` chooses by the device of its input: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs `corner_response_plain`.
`corner_response.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .fast import fast_score, nms3x3
from .harris import harris_response

__all__ = ["corner_response", "corner_response_plain"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def corner_response_plain(images: torch.Tensor, threshold: float = 20.0, with_harris: bool = False):
    """[B, H, W] f32 -> ranked map [B, H, W]: Harris where a FAST-9 corner
    survives strict 3x3 NMS, -inf elsewhere; with_harris=True also returns
    the dense Harris map."""
    score = nms3x3(fast_score(images, threshold))
    harris = harris_response(images)
    ranked = torch.where(score > 0.0, harris, torch.full_like(harris, float("-inf")))
    return (ranked, harris) if with_harris else ranked


def corner_response(images: torch.Tensor, threshold: float = 20.0, with_harris: bool = False):
    """Same contract as `corner_response_plain`; on a CUDA tensor it is one
    launch of the K1 kernel."""
    if images.device.type == "cpu":
        return corner_response_plain(images, threshold, with_harris)
    if images.device.type != "cuda":
        raise ValueError(f"corner_response: unsupported device {images.device}")
    if images.dtype != torch.float32 or images.dim() != 3 or not images.is_contiguous():
        raise ValueError("corner_response: needs a contiguous [B, H, W] float32 tensor")
    b, h, w = images.shape
    ranked = torch.empty_like(images)
    harris = torch.empty_like(images) if with_harris else None
    if images.numel():
        launch = _build.load("corner_response", "launch_corner_response", _ARGTYPES)
        with torch.cuda.device(images.device):
            err = launch(
                images.data_ptr(), ranked.data_ptr(), None if harris is None else harris.data_ptr(),
                b, h, w, float(threshold), torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"corner_response: kernel launch failed with CUDA error {err}")
        corner_response.launches += 1
    return (ranked, harris) if with_harris else ranked


corner_response.launches = 0
