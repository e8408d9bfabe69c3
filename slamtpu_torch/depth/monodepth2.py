"""MonoDepth2 inference (counterpart of slamtpu/depth/monodepth2.py).

The host side (upload, RGB expansion, spans, `depth.frames`, the magma
colouring) is depth/predictor.py's. On the device the RGB frames are cast
to f32, resized to the model's size with an antialiased bilinear filter
(the JAX package's `jax.image.resize(..., "linear")` antialiases on a
downscale), scaled to [0, 1], and run through ResNet18Encoder and
DepthDecoder in eval mode. `predict_raw` returns the scale-0 sigmoid
disparity, [B?, H, W] f32.

bf16 mode (`compute_dtype=torch.bfloat16`) runs a bf16 copy of the modules,
every floating parameter and buffer cast (BatchNorm statistics included),
on a bf16 input, and casts the disparity back to f32, as the JAX package
does; autocast would keep BatchNorm in f32 and compute something else.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..models.depth_decoder import DepthDecoder
from ..models.resnet import ResNet18Encoder
from .predictor import DepthPredictor

__all__ = ["MonoDepth2"]


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


class MonoDepth2(DepthPredictor):
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

    # -- inference (depth/predictor.py calls these) -------------------------
    def _preprocess(self, image: torch.Tensor) -> torch.Tensor:
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
        return x

    def _encode(self, x: torch.Tensor):
        return self.encoder(x)

    def _decode(self, features) -> torch.Tensor:
        """Sigmoid disparity in [0, 1], un-normalized: [B, height, width]."""
        return self.decoder(features, scales=(0,))[0][:, 0].float()
