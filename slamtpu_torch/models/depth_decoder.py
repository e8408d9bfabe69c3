"""MonoDepth2 depth decoder (counterpart of slamtpu/models/depth_decoder.py).

Five encoder features in, sigmoid disparities at scales 0-3 out: per level
i = 4..0, a 3x3 reflection-padded conv + ELU, a nearest 2x upsample, the
skip concatenation (i > 0), another conv block, and a sigmoid disparity
head at scales 0-3.

The convolutions sit in one `decoder` ModuleList in upstream MonoDepth2's
order, [upconv(4,0), upconv(4,1), ..., upconv(0,1), dispconv(0), ...,
dispconv(3)], and each keeps upstream's nesting (ConvBlock.conv is a
Conv3x3, Conv3x3.conv the Conv2d), so `depth.pth` loads as it is:
`decoder.{idx}.conv.conv.*` for a block, `decoder.{idx}.conv.*` for a head.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import NUM_CH_ENC

__all__ = ["DepthDecoder", "ConvBlock", "Conv3x3", "DispConv", "NUM_CH_DEC"]

NUM_CH_DEC = (16, 32, 64, 128, 256)


class Conv3x3(nn.Module):
    """Reflection-pad by 1 (the edge pixel is not repeated), then a 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.pad(x))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (upstream ConvBlock)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class DispConv(Conv3x3):
    """The disparity head: Conv3x3 to one channel (sigmoid applied by the
    decoder)."""

    def __init__(self, in_channels: int):
        super().__init__(in_channels, 1)


class DepthDecoder(nn.Module):
    """features (the 5 maps of ResNet18Encoder) -> [disp_s for s in scales],
    each [B, 1, H / 2^s, W / 2^s] in (0, 1)."""

    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.scales = tuple(scales)
        mods = []
        for i in range(4, -1, -1):
            cin = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
            mods.append(ConvBlock(cin, NUM_CH_DEC[i]))
            mods.append(ConvBlock(NUM_CH_DEC[i] + (NUM_CH_ENC[i - 1] if i > 0 else 0), NUM_CH_DEC[i]))
        mods.extend(DispConv(NUM_CH_DEC[s]) for s in self.scales)
        self.decoder = nn.ModuleList(mods)

    def forward(self, features: List[torch.Tensor], scales: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """`scales`: the heads to run, a subset of the module's (all when
        None)."""
        scales = self.scales if scales is None else tuple(scales)
        x = features[-1]
        disps = {}
        for i in range(4, -1, -1):
            x = self.decoder[2 * (4 - i)](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")  # reads source row i // 2
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self.decoder[2 * (4 - i) + 1](x)
            if i in scales:
                disps[i] = torch.sigmoid(self.decoder[10 + self.scales.index(i)](x))
        return [disps[s] for s in sorted(disps)]
