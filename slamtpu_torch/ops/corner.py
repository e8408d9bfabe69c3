"""Kernel K1 wrapper: fused FAST-9 + NMS + Harris corner ranking.

Replaces slamtpu/ops/pallas_corner.py::corner_response (the Pallas TPU
kernel). The CUDA source is csrc/corner_response.cu; its note says what
bounds it on the H100 and how the design answers that.

Two entry points launch the same kernel: `corner_response` on one level
[B, H, W] (the Pallas kernel's contract) and `corner_response_levels` on
every level of a pyramid at once, which is how the detector calls it. Each
chooses by the device of its input: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version. `corner_response.launches`
counts launches of the kernel by either entry point.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .fast import fast_score, nms3x3
from .harris import harris_response

__all__ = ["corner_response", "corner_response_levels", "corner_response_levels_plain", "corner_response_plain"]

MAX_LEVELS = 16  # csrc/corner_response.cu's table
_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]


def corner_response_plain(images: torch.Tensor, threshold: float = 20.0, with_harris: bool = False):
    """[B, H, W] f32 -> ranked map [B, H, W]: Harris where a FAST-9 corner
    survives strict 3x3 NMS, -inf elsewhere; with_harris=True also returns
    the dense Harris map."""
    score = nms3x3(fast_score(images, threshold))
    harris = harris_response(images)
    ranked = torch.where(score > 0.0, harris, torch.full_like(harris, float("-inf")))
    return (ranked, harris) if with_harris else ranked


def corner_response_levels_plain(levels, threshold: float = 20.0, with_harris=False):
    """`corner_response_plain` on each level: (ranked list, Harris list with
    None where `with_harris` (a bool, or one per level) is False)."""
    flags = _flags(levels, with_harris)
    ranked, harris = [], []
    for img, flag in zip(levels, flags):
        out = corner_response_plain(img, threshold, with_harris=True)
        ranked.append(out[0])
        harris.append(out[1] if flag else None)
    return ranked, harris


def _flags(levels, with_harris):
    flags = [with_harris] * len(levels) if isinstance(with_harris, bool) else list(with_harris)
    if len(flags) != len(levels):
        raise ValueError(f"with_harris has {len(flags)} entries for {len(levels)} levels")
    return [bool(f) for f in flags]


def _launch(levels, ranked, harris, threshold: float) -> None:
    """One K1 launch over `levels` (validated CUDA tensors, one batch)."""
    n = len(levels)
    if n > MAX_LEVELS:
        raise ValueError(f"corner_response: at most {MAX_LEVELS} levels per launch, got {n}")
    if not any(img.numel() for img in levels):
        return
    ptrs = (ctypes.c_uint64 * (3 * n))()
    dims = (ctypes.c_int * (2 * n))()
    for i, (img, rk, hr) in enumerate(zip(levels, ranked, harris)):
        ptrs[3 * i], ptrs[3 * i + 1] = img.data_ptr(), rk.data_ptr()
        ptrs[3 * i + 2] = 0 if hr is None else hr.data_ptr()
        dims[2 * i], dims[2 * i + 1] = img.shape[1], img.shape[2]
    launch = _build.load("corner_response", "launch_corner_levels", _ARGTYPES)
    with torch.cuda.device(levels[0].device):
        err = launch(n, ptrs, dims, levels[0].shape[0], float(threshold), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"corner_response: kernel launch failed with CUDA error {err}")
    corner_response.launches += 1


def _check_cuda(images: torch.Tensor, device) -> None:
    if images.device.type != "cuda":
        raise ValueError(f"corner_response: unsupported device {images.device}")
    if images.device != device:
        raise ValueError(f"corner_response: levels on {images.device} and {device}")
    if images.dtype != torch.float32 or images.dim() != 3 or not images.is_contiguous():
        raise ValueError("corner_response: needs contiguous [B, H, W] float32 tensors")


def corner_response(images: torch.Tensor, threshold: float = 20.0, with_harris: bool = False):
    """Same contract as `corner_response_plain`; on a CUDA tensor it is one
    launch of the K1 kernel."""
    if images.device.type == "cpu":
        return corner_response_plain(images, threshold, with_harris)
    _check_cuda(images, images.device)
    ranked = torch.empty_like(images)
    harris = torch.empty_like(images) if with_harris else None
    _launch([images], [ranked], [harris], threshold)
    return (ranked, harris) if with_harris else ranked


def corner_response_levels(levels, threshold: float = 20.0, with_harris=False):
    """Same contract as `corner_response_levels_plain` (levels [B, H_l, W_l]
    sharing B); on CUDA tensors it is one launch of the K1 kernel over every
    level."""
    levels = list(levels)
    flags = _flags(levels, with_harris)
    if not levels:
        return [], []
    if levels[0].device.type == "cpu":
        return corner_response_levels_plain(levels, threshold, flags)
    batch = levels[0].shape[0] if levels[0].dim() == 3 else -1
    for img in levels:
        _check_cuda(img, levels[0].device)
        if img.shape[0] != batch:
            raise ValueError("corner_response_levels: levels differ in batch size")
    ranked = [torch.empty_like(img) for img in levels]
    harris = [torch.empty_like(img) if f else None for img, f in zip(levels, flags)]
    _launch(levels, ranked, harris, threshold)
    return ranked, harris


corner_response.launches = 0
