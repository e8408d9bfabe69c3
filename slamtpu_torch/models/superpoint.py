"""SuperPoint (DeTone, Malisiewicz, Rabinovich, "SuperPoint: Self-Supervised
Interest Point Detection and Description", CVPRW 2018, arXiv:1712.07629) as
the LightGlue repository's `superpoint.py` (github.com/cvg/LightGlue) runs
it, with fixed shapes: every frame gives K keypoint slots and a mask.

  * `SuperPointNet`: the VGG-style backbone (3x3 convolutions, ReLU, three
    2x2 max-pools) and the two heads, with upstream's submodule names
    (`conv1a` ... `convDb`), so `superpoint_v1.pth` loads with strict=True.
    [B, 1, H, W] in [0, 1] -> (65-channel logits, descriptors before their
    normalisation), both at H/8 x W/8.
  * `keypoint_scores`: softmax over the 65 channels, the dustbin dropped,
    the 64 channels unfolded into 8x8 pixels.
  * `simple_nms`: upstream's, radius 4 (max-pool 9x9, two rounds of
    re-suppression).
  * `select_keypoints`: the border set to -1, scores above the threshold,
    the top K by score as (x, y) = (column, row) pixels; slots past the
    candidates are dead (mask False, xy 0, score 0).
  * `sample_descriptors`: the coarse descriptors, L2-normalised, sampled at
    the keypoints (bilinear, align_corners=True, the keypoint shifted by
    s/2 - 0.5 and scaled as upstream's) and L2-normalised again.

`SuperPointNet.backbone` runs conv1a in conv1a's own dtype and the other
layers in theirs. Everything after the network runs in float32, whatever
the network's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.graphs import device_constant

__all__ = ["SuperPointNet", "keypoint_scores", "simple_nms", "select_keypoints", "normalize_descriptors",
           "sample_descriptors", "CELL"]

CELL = 8  # the heads' stride: one logit vector and one descriptor per 8x8 cell


class SuperPointNet(nn.Module):
    """The network of upstream's SuperPoint: [B, 1, H, W] -> (logits
    [B, 65, H/8, W/8], descriptors [B, D, H/8, W/8], not normalised)."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        conv = lambda cin, cout, k=3: nn.Conv2d(cin, cout, kernel_size=k, stride=1, padding=k // 2)  # noqa: E731
        self.conv1a, self.conv1b = conv(1, c1), conv(c1, c1)
        self.conv2a, self.conv2b = conv(c1, c2), conv(c2, c2)
        self.conv3a, self.conv3b = conv(c2, c3), conv(c3, c3)
        self.conv4a, self.conv4b = conv(c3, c4), conv(c4, c4)
        self.convPa, self.convPb = conv(c4, c5), conv(c5, 65, 1)
        self.convDa, self.convDb = conv(c4, c5), conv(c5, descriptor_dim, 1)

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        # conv1a runs in its own dtype (float32 in LearnedFrontend), its output
        # is rounded once into the other layers' dtype, and the ReLU follows
        # the rounding (the same values, half the bytes)
        x = F.relu(self.conv1a(x.to(self.conv1a.weight.dtype)).to(self.conv1b.weight.dtype), inplace=True)
        x = F.max_pool2d(F.relu(self.conv1b(x)), 2, 2)
        for a, b in ((self.conv2a, self.conv2b), (self.conv3a, self.conv3b)):
            x = F.max_pool2d(F.relu(b(F.relu(a(x)))), 2, 2)
        return F.relu(self.conv4b(F.relu(self.conv4a(x))))

    def heads(self, x: torch.Tensor) -> tuple:
        return self.convPb(F.relu(self.convPa(x))), self.convDb(F.relu(self.convDa(x)))

    def forward(self, x: torch.Tensor) -> tuple:
        return self.heads(self.backbone(x))


def keypoint_scores(logits: torch.Tensor) -> torch.Tensor:
    """[B, 65, h, w] logits -> [B, 8h, 8w] float32 scores."""
    scores = torch.softmax(logits.float(), dim=1)[:, :-1]
    b, _, h, w = scores.shape
    scores = scores.permute(0, 2, 3, 1).reshape(b, h, w, CELL, CELL)
    return scores.permute(0, 1, 3, 2, 4).reshape(b, h * CELL, w * CELL)


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Upstream's non-maximum suppression of [B, H, W] scores: a pixel
    survives where it is the maximum of its (2r + 1)^2 window, or becomes
    one once the survivors' windows are suppressed (two rounds)."""

    def max_pool(x):
        return F.max_pool2d(x, kernel_size=2 * radius + 1, stride=1, padding=radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def select_keypoints(scores: torch.Tensor, k: int, threshold: float, border: int) -> tuple:
    """The top k of [B, H, W] NMS scores with the `border` pixels at -1 and
    only scores above `threshold`: (xy [B, k, 2] float32 (column, row),
    score [B, k], mask [B, k]), best first; dead slots hold 0."""
    b, h, w = scores.shape
    if border:
        scores = scores.clone()
        scores[:, :border] = -1
        scores[:, :, :border] = -1
        scores[:, -border:] = -1
        scores[:, :, -border:] = -1
    values, idx = torch.topk(scores.reshape(b, h * w), min(k, h * w), dim=1, sorted=True)
    if values.shape[1] < k:  # a frame of fewer than k pixels: the remaining slots are dead
        values, idx = F.pad(values, (0, k - values.shape[1]), value=-1.0), F.pad(idx, (0, k - idx.shape[1]))
    mask = values > threshold
    xy = torch.stack([idx % w, torch.div(idx, w, rounding_mode="floor")], dim=-1).float()
    return xy * mask[..., None], torch.where(mask, values, torch.zeros_like(values)), mask


def normalize_descriptors(descriptors: torch.Tensor) -> torch.Tensor:
    """The coarse descriptors [B, D, h, w], L2-normalised over D in float32."""
    return F.normalize(descriptors.float(), p=2, dim=1)


def sample_descriptors(xy: torch.Tensor, coarse: torch.Tensor, s: int = CELL) -> torch.Tensor:
    """Upstream's `sample_descriptors`: normalised coarse descriptors
    [B, D, h, w] at keypoints xy [B, K, 2] (pixels), bilinear with
    align_corners=True, L2-normalised: [B, K, D] float32."""
    b, c, h, w = coarse.shape
    scale = device_constant((w * s - s / 2 - 0.5, h * s - s / 2 - 0.5), xy.dtype, xy.device)
    grid = (xy - s / 2 + 0.5) / scale * 2 - 1
    out = F.grid_sample(coarse, grid.view(b, 1, -1, 2), mode="bilinear", align_corners=True)
    return F.normalize(out.reshape(b, c, -1), p=2, dim=1).transpose(1, 2)
