"""The host side of the port's depth predictors (MonoDepth2 and
DepthAnythingV2), in one place: the upload of the frames, the grayscale to
RGB expansion, the spans and the `depth.frames` counter, and the magma
colouring of `predict_colored`.

Preprocessing and the network run on one device per call: the frames cross
the bus as they come (uint8 grayscale stays uint8) and are expanded to RGB
there, as an [B, H, W, 3] view. A predictor supplies `_preprocess` (that
view to the network's input), `_encode` and `_decode`.

  * `predict_raw` returns the network's map, [B?, H', W'] f32;
  * `predict` min-max normalizes it per image to [0, 1];
  * `predict_colored` maps it through the embedded 728-entry magma table on
    the host, byte-exact to the JAX package (index percentile, degenerate
    range -> 1.0, LUT index by truncation).

Spans (utils/metrics.py; one flag test each with tracing off): every call
of `predict_raw`, `predict` or `predict_colored` is one root span
`depth.predict`, with `depth.upload` (the frames to the device),
`depth.preprocess` (RGB expand and the predictor's `_preprocess`),
`depth.encoder`, `depth.decoder`, and `depth.normalize` (`predict`) or
`depth.colorize` (`predict_colored`'s fetch and host LUT work) inside it.
The counter `depth.frames` counts the frames through the network a call,
padding included.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..utils.metrics import count, span

__all__ = ["DepthPredictor", "colorize"]


@functools.lru_cache()
def _magma_lut() -> np.ndarray:
    """728x3 uint8 RGB magma table, byte-identical to the reference's
    magma.png (a copy of the JAX package's magma_lut.npz)."""
    return np.load(os.path.join(os.path.dirname(__file__), "magma_lut.npz"))["lut"]


class DepthPredictor:
    """What both predictors share; a subclass sets `self.device` and
    implements `_preprocess`, `_encode` and `_decode`."""

    device: torch.device

    def _preprocess(self, image: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] frames on the device in [0, 255] (any dtype) -> the
        network's input."""
        raise NotImplementedError

    def _encode(self, x: torch.Tensor):
        raise NotImplementedError

    def _decode(self, features) -> torch.Tensor:
        """-> [B, H', W'] f32."""
        raise NotImplementedError

    @torch.inference_mode()
    def _forward(self, image: torch.Tensor) -> torch.Tensor:
        """Frames on the device in [0, 255] ([H, W] / [H, W, 3] / [T, H, W]
        / [B, H, W, 3], any dtype) -> [B, H', W'] f32."""
        with span("depth.preprocess"):
            if image.ndim == 2 or (image.ndim == 3 and image.shape[-1] != 3):
                image = image[..., None].expand(*image.shape, 3)  # grayscale frame or clip
            if image.ndim == 3:
                image = image[None]
            x = self._preprocess(image)
        count("depth.frames", x.shape[0])
        with span("depth.encoder"):
            features = self._encode(x)
        with span("depth.decoder"):
            return self._decode(features)

    def _raw(self, image) -> torch.Tensor:
        """predict_raw inside the caller's span."""
        with span("depth.upload"):
            image = torch.as_tensor(image).to(self.device)
        single = image.ndim == 2 or (image.ndim == 3 and image.shape[-1] == 3)
        out = self._forward(image)
        return out[0] if single else out

    def predict_raw(self, image) -> torch.Tensor:
        """The network's map, un-normalized: [B?, H', W'] f32 on the device."""
        with span("depth.predict", root=True):
            return self._raw(image)

    def predict(self, image) -> torch.Tensor:
        """The map min-max normalized per image."""
        with span("depth.predict", root=True):
            out = self._raw(image)
            with span("depth.normalize"):
                lo = out.amin(dim=(-2, -1), keepdim=True)
                hi = out.amax(dim=(-2, -1), keepdim=True)
                return (out - lo) / torch.clamp(hi - lo, min=1e-12)

    def predict_colored(self, image) -> np.ndarray:
        """uint8 RGB magma visualization on the host: vmin = min, vmax = the
        sorted values at index floor(0.95 * count) (an index percentile),
        degenerate range -> 1.0, LUT index = trunc(normalized * 727)."""
        with span("depth.predict", root=True):
            out = self._raw(image)
            with span("depth.colorize"):
                return colorize(out.cpu().numpy())


def colorize(disp: np.ndarray) -> np.ndarray:
    """predict_colored's host work on a [B?, H, W] map."""
    batched = disp.ndim == 3
    flat = disp.reshape(disp.shape[0] if batched else 1, -1)
    vmin = flat.min(axis=-1)
    srt = np.sort(flat, axis=-1)
    p95_idx = min(int(flat.shape[-1] * 0.95), flat.shape[-1] - 1)
    vmax = srt[:, p95_idx]
    rng = vmax - vmin
    rng = np.where(rng < 1e-8, 1.0, rng)
    shape = (-1, 1, 1) if batched else (-1, 1)
    if not batched:
        vmin, rng = vmin[0], rng[0]
    else:
        vmin, rng = vmin.reshape(shape), rng.reshape(shape)
    lut = _magma_lut()
    n = lut.shape[0]
    norm = np.clip((disp - vmin) / rng, 0.0, 1.0)
    idx = np.clip((norm * (n - 1)).astype(np.int32), 0, n - 1)
    return lut[idx]
