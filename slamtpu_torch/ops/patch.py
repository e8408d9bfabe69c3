"""Kernel K2 wrapper: per-keypoint window extraction.

Replaces slamtpu/ops/pallas_patch.py::extract_patches_batched (the Pallas
TPU kernel). The CUDA source is csrc/extract_patches.cu; its note says what
bounds it on the H100 and how the design answers that.

Two entry points launch the same kernel: `extract_patches_batched` on one
level (the Pallas kernel's contract) and `extract_patches_levels` on every
level of a pyramid at once, which is how the detector calls it. Each
chooses by the device of its input: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version. `extract_patches_batched.launches`
counts launches of the kernel by either entry point.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["extract_patches_batched", "extract_patches_levels", "extract_patches_levels_plain",
           "extract_patches_plain"]

MAX_LEVELS = 16  # csrc/extract_patches.cu's table
_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def extract_patches_levels_plain(levels, starts, radius: int) -> torch.Tensor:
    """Per-level images ([B, H_l, W_l], or None for a level too small for a
    window) + per-level starts ([B, K_l, 2]) -> [B, sum K_l, 2r+1, 2r+1]:
    `extract_patches_plain` on each level, concatenated in level order; the
    slots of a level without an image are zero."""
    size = 2 * radius + 1
    parts = []
    for img, st in zip(levels, starts, strict=True):
        if img is None:
            parts.append(torch.zeros((st.shape[0], st.shape[1], size, size), dtype=torch.float32, device=st.device))
        else:
            parts.append(extract_patches_plain(img, st, radius))
    return torch.cat(parts, dim=1)


def _launch(levels, counts, starts: torch.Tensor, size: int, out: torch.Tensor) -> None:
    """One K2 launch: validated CUDA levels (None: zero slots), their slot
    counts, the concatenated starts and the output."""
    n = len(levels)
    if n > MAX_LEVELS:
        raise ValueError(f"extract_patches: at most {MAX_LEVELS} levels per launch, got {n}")
    if not out.numel():
        return
    imgs = (ctypes.c_uint64 * n)()
    dims = (ctypes.c_int * (3 * n))()
    for i, (img, k) in enumerate(zip(levels, counts)):
        imgs[i] = 0 if img is None else img.data_ptr()
        dims[3 * i], dims[3 * i + 1] = (0, 0) if img is None else img.shape[1:]
        dims[3 * i + 2] = k
    launch = _build.load("extract_patches", "launch_extract_patches_levels", _ARGTYPES)
    with torch.cuda.device(out.device):
        err = launch(n, imgs, dims, starts.data_ptr(), out.data_ptr(), out.shape[0], size,
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"extract_patches: kernel launch failed with CUDA error {err}")
    extract_patches_batched.launches += 1


def _check_cuda(images, starts: torch.Tensor, size: int, who: str) -> None:
    if starts.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {starts.device}")
    if starts.dtype != torch.int32 or starts.dim() != 3 or starts.shape[2] != 2:
        raise ValueError(f"{who}: needs int32 starts [B, K, 2], got {starts.dtype} {tuple(starts.shape)}")
    if images is None:
        return
    b, h, w = images.shape
    if images.device != starts.device or images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError(f"{who}: needs contiguous float32 images [B, H, W] on the starts' device")
    if starts.shape[0] != b:
        raise ValueError(f"{who}: starts {tuple(starts.shape)} != [{b}, K, 2]")
    if h < size or w < size:
        raise ValueError(f"{who}: image {h}x{w} smaller than the {size}px window")


def extract_patches_batched(images: torch.Tensor, starts: torch.Tensor, radius: int) -> torch.Tensor:
    """Same contract as `extract_patches_plain`; on a CUDA tensor it is one
    launch of the K2 kernel."""
    if images.device.type == "cpu":
        return extract_patches_plain(images, starts, radius)
    size = 2 * radius + 1
    if images.device.type != "cuda":
        raise ValueError(f"extract_patches_batched: unsupported device {images.device}")
    _check_cuda(images, starts, size, "extract_patches_batched")
    if not starts.is_contiguous():
        raise ValueError("extract_patches_batched: needs contiguous starts")
    out = images.new_empty((images.shape[0], starts.shape[1], size, size))
    _launch([images], [starts.shape[1]], starts, size, out)
    return out


def extract_patches_levels(levels, starts, radius: int) -> torch.Tensor:
    """Same contract as `extract_patches_levels_plain`; on CUDA tensors it
    is one launch of the K2 kernel over every level."""
    levels, starts = list(levels), list(starts)
    if len(levels) != len(starts) or not starts:
        raise ValueError(f"extract_patches_levels: {len(levels)} levels and {len(starts)} start tensors")
    if starts[0].device.type == "cpu":
        return extract_patches_levels_plain(levels, starts, radius)
    size = 2 * radius + 1
    batch = starts[0].shape[0]
    for img, st in zip(levels, starts):
        _check_cuda(img, st, size, "extract_patches_levels")
        if st.device != starts[0].device or st.shape[0] != batch:
            raise ValueError("extract_patches_levels: starts differ in device or batch size")
    counts = [st.shape[1] for st in starts]
    out = torch.empty((batch, sum(counts), size, size), dtype=torch.float32, device=starts[0].device)
    _launch(levels, counts, torch.cat(starts, dim=1).contiguous(), size, out)
    return out


extract_patches_batched.launches = 0
