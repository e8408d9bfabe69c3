"""Depth Anything V2 inference (Yang et al., NeurIPS 2024, arXiv:2406.09414;
github.com/DepthAnything/Depth-Anything-V2), model `depth_anything_v2_vitl`
by default: a DINOv2 ViT-L/14 encoder (models/vit.py) and the DPT head
(models/dpt.py). The output is relative inverse depth, defined up to scale
and shift.

The host side (upload, RGB expansion, spans, `depth.frames`, the magma
colouring) is depth/predictor.py's. On the device the RGB frames are cast
to f32, divided by 255, resized bicubically (no antialiasing, as cv2's
INTER_CUBIC) to upstream's lower-bound size (`target_size`: both sides at
least `input_size`, the aspect kept, each side a multiple of 14; KITTI's
1241x376 becomes 518x1708, a 37x122 patch grid), normalised with
ImageNet's mean and standard deviation, and run through the network in
eval mode. `predict_raw` returns the map at the model's size,
[B?, H', W'] f32. The counter `depth.tokens` counts the ViT's tokens a
call, class tokens included.

bf16 mode (`compute_dtype=torch.bfloat16`) runs a bf16 copy of every
parameter, as MonoDepth2's does, not autocast; the position table is
interpolated in f32 and cast, as upstream does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..models.dpt import DPTHead
from ..models.vit import DinoVisionTransformer, LayerScale
from ..utils.metrics import count
from .predictor import DepthPredictor

__all__ = ["DepthAnythingV2", "DepthAnythingV2Config", "VITL", "target_size"]

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DepthAnythingV2Config:
    """The widths of a Depth Anything V2 model; the defaults are `vitl`'s
    (upstream's model_configs['vitl'] and dinov2.py::vit_large)."""

    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    img_size: int = 518  # the position table's grid is img_size / patch_size square
    layers: tuple = (4, 11, 17, 23)  # the blocks whose outputs feed the head
    features: int = 256
    out_channels: tuple = (256, 512, 1024, 1024)


VITL = DepthAnythingV2Config()


def target_size(height: int, width: int, input_size: int = 518, multiple: int = 14) -> tuple:
    """The network's input size for a height x width frame: upstream's
    Resize(input_size, input_size, keep_aspect_ratio=True,
    ensure_multiple_of=multiple, resize_method='lower_bound')."""
    scale = max(input_size / height, input_size / width)

    def side(x: float) -> int:
        y = round(x / multiple) * multiple  # half to even, as upstream's np.round
        return y if y >= input_size else math.ceil(x / multiple) * multiple

    return side(scale * height), side(scale * width)


class DepthAnythingV2Net(nn.Module):
    """Upstream's DepthAnythingV2 module: `pretrained` (the ViT) and
    `depth_head`; [B, 3, H, W] normalised -> [B, H, W] inverse depth."""

    def __init__(self, config: DepthAnythingV2Config = VITL):
        super().__init__()
        c = config
        self.config = c
        self.pretrained = DinoVisionTransformer(c.embed_dim, c.depth, c.num_heads, c.mlp_ratio, c.patch_size,
                                                c.img_size)
        self.depth_head = DPTHead(c.embed_dim, c.features, c.out_channels)

    def encode(self, x: torch.Tensor) -> tuple:
        """[B, 3, H, W] -> (the ViT's token maps for the head, gh, gw)."""
        gh, gw = x.shape[-2] // self.config.patch_size, x.shape[-1] // self.config.patch_size
        return self.pretrained.get_intermediate_layers(x, self.config.layers), gh, gw

    def decode(self, tokens: list, gh: int, gw: int) -> torch.Tensor:
        """The head and the final ReLU -> [B, gh p, gw p] f32, in blocks of
        frames so that no tensor of the head reaches 2^31 elements (the
        limit of CUDA's channels-last bilinear resize). The largest is the
        output's resize, features / 2 channels at the input's size: 113 M
        elements a frame at 518x1708, so batches of 64 run as 4 blocks of
        16."""
        c, ps = self.config, self.config.patch_size
        b = tokens[0].shape[0]
        per_frame = max(c.features * 64, c.features // 2 * ps * ps) * gh * gw
        blocks = -(-b // max(1, (2**31 - 1) // per_frame))
        step = -(-b // blocks)
        out = torch.empty((b, gh * ps, gw * ps), dtype=torch.float32, device=tokens[0].device)
        for s in range(0, b, step):
            out[s : s + step] = F.relu(self.depth_head([t[s : s + step] for t in tokens], gh, gw, ps))[:, 0]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(*self.encode(x))


@torch.no_grad()
def _random_init(module: nn.Module, generator: torch.Generator) -> None:
    """Weights drawn from `generator` (timing and tests; predictions are
    noise): linear and conv weights lecun-normal (truncated at 2 standard
    deviations of 1 / sqrt(fan_in); a transposed conv's fan-in is its input
    channels), zero biases, LayerNorm and LayerScale 1, class token and
    position table N(0, 0.02^2)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel()
            std = fan_in ** -0.5
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif isinstance(m, LayerScale):
            m.gamma.fill_(1.0)
        elif isinstance(m, DinoVisionTransformer):
            for p in (m.cls_token, m.pos_embed):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)


class DepthAnythingV2(DepthPredictor):
    """Batched Depth Anything V2 predictor on `device` ("cuda" when None;
    raises without one).

    Built from a state dict in upstream's checkpoint layout (`pretrained.*`,
    `depth_head.*`, as `torch.load` reads depth_anything_v2_vitl.pth),
    loaded with strict=True, or from a random init drawn from `seed`.
    `input_size` is the resize's lower bound; `config` the widths (ViT-L's
    unless given).
    """

    def __init__(
        self,
        state_dict: Optional[dict] = None,
        seed: int = 0,
        input_size: int = 518,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        config: Optional[DepthAnythingV2Config] = None,
    ):
        self.config = config or VITL
        self.input_size = input_size
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.net = DepthAnythingV2Net(self.config)
        if state_dict is None:
            _random_init(self.net, torch.Generator().manual_seed(seed))
        else:
            self.net.load_state_dict(state_dict, strict=True)
        self.net.eval().to(self.device)
        if compute_dtype is not None:
            self.net.to(compute_dtype)
        self._mean = torch.tensor(MEAN, device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(STD, device=self.device).view(1, 3, 1, 1)

    def size_of(self, height: int, width: int) -> tuple:
        """The network's input (and output) size for a height x width frame."""
        return target_size(height, width, self.input_size, self.config.patch_size)

    # -- inference (depth/predictor.py calls these) -------------------------
    def _preprocess(self, image: torch.Tensor) -> torch.Tensor:
        x = image.float().permute(0, 3, 1, 2) / 255.0  # a channels-last view of the NHWC frames
        size = self.size_of(*x.shape[-2:])
        if tuple(x.shape[-2:]) != size:
            x = F.interpolate(x, size=size, mode="bicubic", align_corners=False)
        x = (x - self._mean) / self._std
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _encode(self, x: torch.Tensor):
        tokens, gh, gw = self.net.encode(x)
        count("depth.tokens", x.shape[0] * (1 + gh * gw))
        return tokens, gh, gw

    def _decode(self, features) -> torch.Tensor:
        """Relative inverse depth, >= 0: [B, H', W']."""
        return self.net.decode(*features)
