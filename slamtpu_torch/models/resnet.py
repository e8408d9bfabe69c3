"""ResNet-18 encoder for MonoDepth2 (counterpart of slamtpu/models/resnet.py).

torchvision's resnet18 layer graph, NCHW, inference only: BatchNorm uses its
running statistics (eps 1e-5, as in Flax). It returns the five feature maps
MonoDepth2's decoder consumes:

  f0: conv1+bn+relu               (H/2,  64)
  f1: maxpool + layer1            (H/4,  64)
  f2: layer2                      (H/8,  128)
  f3: layer3                      (H/16, 256)
  f4: layer4                      (H/32, 512)

Submodules carry torchvision's names (`conv1`, `bn1`, `layer{s}.{b}.conv1`,
`layer{s}.{b}.downsample.0/1`), so the published `encoder.pth` loads with
`load_state_dict(strict=True)` once depth/convert.py has stripped its
`encoder.` prefix, its metadata and the classifier head. Input is RGB in
[0, 1]; MonoDepth2's normalization (x - 0.45) / 0.225 is applied here.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

__all__ = ["ResNet18Encoder", "BasicBlock", "NUM_CH_ENC"]

NUM_CH_ENC = (64, 64, 128, 256, 512)


class BasicBlock(nn.Module):
    """Two 3x3 conv+BN layers with a residual; a 1x1 conv+BN projects the
    identity when the stride or the width changes."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels)
        self.downsample = None
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Sequential(nn.Conv2d(in_channels, channels, 1, stride, bias=False),
                                            nn.BatchNorm2d(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + identity)


class ResNet18Encoder(nn.Module):
    """[B, 3, H, W] RGB in [0, 1] -> the 5 MonoDepth2 feature maps."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)  # pads with -inf, as Flax's max_pool
        in_ch = 64
        for stage, (n_blocks, ch) in enumerate(zip(stage_sizes, NUM_CH_ENC[1:]), start=1):
            blocks = [BasicBlock(in_ch if b == 0 else ch, ch, 2 if (stage > 1 and b == 0) else 1)
                      for b in range(n_blocks)]
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - 0.45) / 0.225  # MonoDepth2 ResnetEncoder normalization
        f0 = torch.relu(self.bn1(self.conv1(x)))
        feats = [f0]
        x = self.maxpool(f0)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats
