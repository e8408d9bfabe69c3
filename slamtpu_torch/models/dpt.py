"""The DPT head of Depth Anything V2 (upstream's dpt.py::DPTHead and
util/blocks.py, use_bn=False, use_clstoken=False): four token maps of the
ViT to one relative inverse-depth map at the patch grid's pixel size. The
submodules carry upstream's names, so a checkpoint's `depth_head.*`
tensors load with strict=True; refinenet4, which takes one input, keeps
its unused resConfUnit1 for that reason.

The token maps enter as channels-last views of the [B, N, D] tokens (no
transposing copy), and the convolutions keep that layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ResidualConvUnit(nn.Module):
    """ReLU, 3x3, ReLU, 3x3, plus the input."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """path (+ resConfUnit1(skip)), resConfUnit2, a bilinear resize with
    align_corners=True to `size` (x2 without one), a 1x1 out_conv."""

    def __init__(self, features: int):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, path: torch.Tensor, skip: torch.Tensor | None = None, size=None) -> torch.Tensor:
        if skip is not None:
            path = path + self.resConfUnit1(skip)
        path = self.resConfUnit2(path)
        resize = {"size": tuple(size)} if size is not None else {"scale_factor": 2}
        path = F.interpolate(path, **resize, mode="bilinear", align_corners=True)
        return self.out_conv(path)


class DPTHead(nn.Module):
    def __init__(self, in_channels: int = 1024, features: int = 256, out_channels=(256, 512, 1024, 1024),
                 head_features_2: int = 32):
        super().__init__()
        oc = out_channels
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], kernel_size=4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], kernel_size=2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], kernel_size=3, stride=2, padding=1),
        ])
        self.scratch = nn.Module()
        for i, c in enumerate(oc):
            setattr(self.scratch, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", FeatureFusionBlock(features))
        self.scratch.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, head_features_2, 3, padding=1), nn.ReLU(),
            nn.Conv2d(head_features_2, 1, 1), nn.ReLU())

    def forward(self, features: list, gh: int, gw: int, patch_size: int = 14) -> torch.Tensor:
        """Four [B, gh gw, D] token maps -> [B, 1, gh p, gw p]."""
        s = self.scratch
        layers = []
        for i, tokens in enumerate(features):
            x = tokens.reshape(tokens.shape[0], gh, gw, tokens.shape[-1]).permute(0, 3, 1, 2)
            x = self.resize_layers[i](self.projects[i](x))
            layers.append(getattr(s, f"layer{i + 1}_rn")(x))
        path = s.refinenet4(layers[3], size=layers[2].shape[-2:])
        path = s.refinenet3(path, layers[2], size=layers[1].shape[-2:])
        path = s.refinenet2(path, layers[1], size=layers[0].shape[-2:])
        path = s.refinenet1(path, layers[0])
        out = s.output_conv1(path)
        out = F.interpolate(out, size=(gh * patch_size, gw * patch_size), mode="bilinear", align_corners=True)
        return s.output_conv2(out)
