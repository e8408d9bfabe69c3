"""Kernel K2 wrapper: per-keypoint window extraction.

Replaces slamtpu/ops/pallas_patch.py::extract_patches_batched (the Pallas
TPU kernel). The CUDA source is csrc/extract_patches.cu; its note says what
bounds it on the H100 and how the design answers that.

`extract_patches_batched` chooses by the device of its input: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs `extract_patches_plain`.
`extract_patches_batched.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["extract_patches_batched", "extract_patches_plain"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _clamped(starts: torch.Tensor, h: int, w: int, size: int) -> torch.Tensor:
    return torch.stack(
        [starts[..., 0].clamp(0, max(w - size, 0)), starts[..., 1].clamp(0, max(h - size, 0))], dim=-1
    )


def extract_patches_plain(images: torch.Tensor, starts: torch.Tensor, radius: int) -> torch.Tensor:
    """[B, H, W] + window starts [B, K, 2] (x0, y0) -> [B, K, 2r+1, 2r+1].

    One slice per keypoint with its start clamped to [0, W-size] x
    [0, H-size] — the semantics of slamtpu's vmapped `lax.dynamic_slice`
    (ops/brief.py::extract_patches).
    """
    b, h, w = images.shape
    size = 2 * radius + 1
    starts = _clamped(starts, h, w, size).tolist()
    out = images.new_empty((b, len(starts[0]) if b else 0, size, size))
    for i in range(b):
        for k, (x0, y0) in enumerate(starts[i]):
            out[i, k] = images[i, y0 : y0 + size, x0 : x0 + size]
    return out


def extract_patches_batched(images: torch.Tensor, starts: torch.Tensor, radius: int) -> torch.Tensor:
    """Same contract as `extract_patches_plain`; on a CUDA tensor it is one
    launch of the K2 kernel."""
    if images.device.type == "cpu":
        return extract_patches_plain(images, starts, radius)
    if images.device.type != "cuda":
        raise ValueError(f"extract_patches_batched: unsupported device {images.device}")
    size = 2 * radius + 1
    b, h, w = images.shape
    if images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError("extract_patches_batched: needs contiguous float32 images [B, H, W]")
    if starts.device != images.device or starts.dtype != torch.int32 or not starts.is_contiguous():
        raise ValueError("extract_patches_batched: needs contiguous int32 starts on the images' device")
    if starts.shape[0] != b or starts.dim() != 3 or starts.shape[2] != 2:
        raise ValueError(f"extract_patches_batched: starts {tuple(starts.shape)} != [{b}, K, 2]")
    if h < size or w < size:
        raise ValueError(f"extract_patches_batched: image {h}x{w} smaller than the {size}px window")
    k = starts.shape[1]
    out = images.new_empty((b, k, size, size))
    if out.numel():
        launch = _build.load("extract_patches", "launch_extract_patches", _ARGTYPES)
        with torch.cuda.device(images.device):
            err = launch(
                images.data_ptr(), starts.data_ptr(), out.data_ptr(), b, k, h, w, size,
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"extract_patches_batched: kernel launch failed with CUDA error {err}")
        extract_patches_batched.launches += 1
    return out


extract_patches_batched.launches = 0
