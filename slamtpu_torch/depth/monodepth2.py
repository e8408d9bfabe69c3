"""MonoDepth2 inference (counterpart of slamtpu/depth/monodepth2.py).

Preprocessing and the network run on one device per call: the frames cross
the bus as they come (uint8 grayscale stays uint8), are expanded to RGB and
cast to f32 there, resized to the model's size with an antialiased bilinear
filter (the JAX package's `jax.image.resize(..., "linear")` antialiases on a
downscale), scaled to [0, 1], and run through ResNet18Encoder and
DepthDecoder in eval mode.

  * `predict_raw` returns the scale-0 sigmoid disparity, [B?, H, W] f32;
  * `predict` min-max normalizes it per image to [0, 1];
  * `predict_colored` maps it through the embedded 728-entry magma table on
    the host, byte-exact to the JAX package (index percentile, degenerate
    range -> 1.0, LUT index by truncation).

bf16 mode (`compute_dtype=torch.bfloat16`) runs a bf16 copy of the modules,
every floating parameter and buffer cast (BatchNorm statistics included),
on a bf16 input, and casts the disparity back to f32, as the JAX package
does; autocast would keep BatchNorm in f32 and compute something else.

Spans (utils/metrics.py; one flag test each with tracing off): every call
of `predict_raw`, `predict` or `predict_colored` is one root span
`depth.predict`, with `depth.upload` (the frames to the device),
`depth.preprocess` (RGB expand, resize, scale, cast), `depth.encoder`,
`depth.decoder`, and `depth.normalize` (`predict`) or `depth.colorize`
(`predict_colored`'s fetch and host LUT work) inside it. The counter
`depth.frames` counts the frames through the network a call, padding
included.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..models.depth_decoder import DepthDecoder
from ..models.resnet import ResNet18Encoder
from ..utils.metrics import count, span

__all__ = ["MonoDepth2"]


@functools.lru_cache()
def _magma_lut() -> np.ndarray:
    """728x3 uint8 RGB magma table, byte-identical to the reference's
    magma.png (a copy of the JAX package's magma_lut.npz)."""
    return np.load(os.path.join(os.path.dirname(__file__), "magma_lut.npz"))["lut"]


@torch.no_grad()
def _flax_like_init(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initializers, drawn from `generator`: lecun-normal conv
    kernels (a normal truncated at 2 standard deviations, scaled to variance
    1 / fan_in), zero biases, BatchNorm scale 1, shift 0, mean 0, var 1.
    The values differ from JAX's draws; weights cross by convert.py."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # jax variance_scaling, truncated_normal
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


class MonoDepth2:
    """Batched MonoDepth2 predictor on `device` ("cuda" when None; raises
    without one).

    Built from upstream checkpoints (`encoder_path`, `depth_path`), from
    state dicts in the port's layout (`encoder`, `decoder`; what
    depth/convert.py and `slamtpu_torch.convert.monodepth2_from_flax`
    return), or from a random init drawn from `seed` (timing and tests;
    predictions are noise).
    """

    def __init__(
        self,
        encoder_path: Optional[str] = None,
        depth_path: Optional[str] = None,
        encoder: Optional[dict] = None,
        decoder: Optional[dict] = None,
        width: int = 640,
        height: int = 192,
        seed: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        self.width = width
        self.height = height
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.encoder = ResNet18Encoder()
        self.decoder = DepthDecoder()
        if encoder_path is not None:
            from .convert import convert_decoder, convert_encoder, load_state_dict

            encoder = convert_encoder(load_state_dict(encoder_path))
            decoder = convert_decoder(load_state_dict(depth_path))
        if encoder is None:
            gen = torch.Generator().manual_seed(seed)
            _flax_like_init(self.encoder, gen)
            _flax_like_init(self.decoder, gen)
        else:
            self.encoder.load_state_dict(encoder, strict=True)
            self.decoder.load_state_dict(decoder, strict=True)
        for m in (self.encoder, self.decoder):
            m.eval().to(self.device)
            if compute_dtype is not None:
                m.to(compute_dtype)  # floating parameters and buffers; num_batches_tracked stays int

    # -- inference --------------------------------------------------------
    @torch.inference_mode()
    def _forward(self, image: torch.Tensor) -> torch.Tensor:
        """Frames on the device in [0, 255] ([H, W] / [H, W, 3] / [T, H, W]
        / [B, H, W, 3], any dtype) -> [B, height, width] f32 scale-0
        disparity."""
        with span("depth.preprocess"):
            if image.ndim == 2 or (image.ndim == 3 and image.shape[-1] != 3):
                image = image[..., None].expand(*image.shape, 3)  # grayscale frame or clip
            if image.ndim == 3:
                image = image[None]
            # A channels-last view of the NHWC frames: from it cuDNN runs the
            # f32 network faster on the H100 than from an NCHW copy, and bf16
            # as fast (an A/B of the two layouts; the depth-b64 cell times this path).
            x = image.float().permute(0, 3, 1, 2)
            if x.shape[-2:] != (self.height, self.width):
                x = F.interpolate(x, size=(self.height, self.width), mode="bilinear", align_corners=False,
                                  antialias=True)
            x = x / 255.0
            if self.compute_dtype is not None:
                x = x.to(self.compute_dtype)
        count("depth.frames", x.shape[0])
        with span("depth.encoder"):
            features = self.encoder(x)
        with span("depth.decoder"):
            return self.decoder(features, scales=(0,))[0][:, 0].float()

    def _raw(self, image) -> torch.Tensor:
        """predict_raw inside the caller's span."""
        with span("depth.upload"):
            image = torch.as_tensor(image).to(self.device)
        single = image.ndim == 2 or (image.ndim == 3 and image.shape[-1] == 3)
        disp = self._forward(image)
        return disp[0] if single else disp

    def predict_raw(self, image) -> torch.Tensor:
        """Sigmoid disparity in [0, 1], un-normalized. [B?, height, width]."""
        with span("depth.predict", root=True):
            return self._raw(image)

    def predict(self, image) -> torch.Tensor:
        """Min-max-normalized disparity, per image."""
        with span("depth.predict", root=True):
            disp = self._raw(image)
            with span("depth.normalize"):
                lo = disp.amin(dim=(-2, -1), keepdim=True)
                hi = disp.amax(dim=(-2, -1), keepdim=True)
                return (disp - lo) / torch.clamp(hi - lo, min=1e-12)

    def predict_colored(self, image) -> np.ndarray:
        """uint8 RGB magma visualization on the host: vmin = min, vmax = the
        sorted values at index floor(0.95 * count) (an index percentile),
        degenerate range -> 1.0, LUT index = trunc(normalized * 727)."""
        with span("depth.predict", root=True):
            disp = self._raw(image)
            with span("depth.colorize"):
                return _colorize(disp.cpu().numpy())


def _colorize(disp: np.ndarray) -> np.ndarray:
    """predict_colored's host work on a [B?, H, W] disparity."""
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
