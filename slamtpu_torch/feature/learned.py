"""The learned VO frontend: SuperPoint keypoints and descriptors
(models/superpoint.py) matched by LightGlue (models/lightglue.py), at fixed
shapes: K keypoint slots a frame with a mask, as the ORB path keeps them.

`LearnedFrontend` owns both networks. Built from state dicts in
upstream's layout (`superpoint_v1.pth`, `superpoint_lightglue.pth`, the
latter's older keys renamed as upstream does) loaded with strict=True, or
from weights drawn from `seed` (timing and tests; predictions are noise).
On CUDA the networks run a bfloat16 copy of every parameter (the depth
predictors' rule, not autocast); on the CPU they run in float32.
LightGlue's position encoding stays float32, and so does SuperPoint's
first convolution (1 -> 64 channels on the frame): in bfloat16 the frame
and the convolution's output, rounded before the bias is added, each move
by up to half a gray level, which the layers after it amplify. Its output
is rounded once, to bfloat16, for the layers after it. `LearnedConfig` is
the one place of the learned frontend's settings: `run_vo` reads the slots
a frame from the frontend it is given.

Spans (utils/metrics.py) under the caller's: `sp.backbone` (the
convolutions), `sp.keypoints` (scores, NMS, border, threshold, top-k) and
`sp.descriptors` (normalisation and sampling) in `detect`; `lg.layers` and
`lg.assign` in `match`. Counters: `sp.frames`, `sp.keypoint_slots` (K a
frame), `lg.pairs` and `lg.layers` (layers run, summed over the pairs),
all known on the host; LightGlue's run through `utils/graphs.py::host_effect`
so a replayed graph counts them too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from .. import resolve_device
from ..models import superpoint as sp
from ..models.lightglue import LightGlue, rename_old_keys
from ..utils.metrics import count, span

__all__ = ["LearnedConfig", "LearnedFeatures", "LearnedFrontend", "seed_features"]


@dataclasses.dataclass(frozen=True)
class LearnedConfig:
    """SuperPoint's settings as LightGlue's repository runs it
    (`superpoint.py`'s defaults, 2048 keypoints) and LightGlue's
    (`LightGlue(features="superpoint")`). Adaptive depth and width are not
    ported: all layers run on all slots, upstream's depth_confidence =
    width_confidence = -1."""

    max_keypoints: int = 2048
    descriptor_dim: int = 256
    nms_radius: int = 4
    detection_threshold: float = 0.0005
    remove_borders: int = 4
    n_layers: int = 9
    num_heads: int = 4
    filter_threshold: float = 0.1


class LearnedFeatures(NamedTuple):
    """K keypoint slots with a mask, level-0 pixels (x, y)."""

    xy: torch.Tensor  # [..., K, 2] float32
    descriptors: torch.Tensor  # [..., K, D] the networks' dtype, unit norm
    scores: torch.Tensor  # [..., K] float32 detection score
    mask: torch.Tensor  # [..., K] bool

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1, dtype=torch.int32)


def seed_features(config: LearnedConfig, dtype: torch.dtype, device=None) -> LearnedFeatures:
    """All-masked LearnedFeatures: the carry seed for a run's first chunk."""
    k = config.max_keypoints
    zeros = torch.zeros((k,), dtype=torch.float32, device=device)
    return LearnedFeatures(xy=torch.zeros((k, 2), dtype=torch.float32, device=device),
                           descriptors=torch.zeros((k, config.descriptor_dim), dtype=dtype, device=device),
                           scores=zeros, mask=torch.zeros((k,), dtype=torch.bool, device=device))


@torch.no_grad()
def _random_init(module: nn.Module, generator: torch.Generator) -> None:
    """Linear and conv weights lecun-normal (truncated at 2 standard
    deviations of 1 / sqrt(fan_in)), zero biases, LayerNorm 1 and 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            std = m.weight[0].numel() ** -0.5
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


class LearnedFrontend:
    """SuperPoint + LightGlue on `device` ("cuda" when None; raises without
    one); see the module's docstring."""

    def __init__(self, superpoint: Optional[dict] = None, lightglue: Optional[dict] = None, seed: int = 0,
                 config: LearnedConfig = LearnedConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.superpoint = sp.SuperPointNet(config.descriptor_dim)
        self.lightglue = LightGlue(config.descriptor_dim, config.n_layers, config.num_heads, config.filter_threshold)
        generator = torch.Generator().manual_seed(seed)
        for net, state in ((self.superpoint, superpoint), (self.lightglue, lightglue)):
            if state is None:
                _random_init(net, generator)
            else:
                if net is self.lightglue:
                    state = rename_old_keys(state, config.n_layers)
                net.load_state_dict(state, strict=True)
            net.eval().requires_grad_(False).to(self.device, self.compute_dtype)
        self.lightglue.posenc.float()
        self.superpoint.conv1a.float()
        if self.device.type == "cuda":
            self.superpoint.to(memory_format=torch.channels_last)

    def dense(self, frames: torch.Tensor) -> tuple:
        """SuperPoint's network on frames [N, H, W] (uint8, or float in
        [0, 255]) on the device: (logits [N, 65, h, w], coarse descriptors
        [N, D, h, w] not normalised), both in the networks' dtype."""
        x = (frames.float() / 255.0)[:, None]
        if self.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        return self.superpoint(x)

    def detect(self, frames: torch.Tensor) -> tuple:
        """Frames [N, H, W] -> (LearnedFeatures [N, K, ...], logits
        [N, 65, h, w] and the coarse descriptor map [N, D, h, w] before its
        normalisation, both in the networks' dtype)."""
        c = self.config
        with span("sp.backbone"):
            logits, descriptors = self.dense(frames)
        with span("sp.keypoints"):
            scores = sp.simple_nms(sp.keypoint_scores(logits), c.nms_radius)
            xy, kp_scores, mask = sp.select_keypoints(scores, c.max_keypoints, c.detection_threshold,
                                                      c.remove_borders)
        with span("sp.descriptors"):
            coarse = sp.normalize_descriptors(descriptors)
            desc = sp.sample_descriptors(xy, coarse).to(self.compute_dtype)
        count("sp.frames", frames.shape[0])
        count("sp.keypoint_slots", frames.shape[0] * xy.shape[1])
        return LearnedFeatures(xy, desc, kp_scores, mask), logits, descriptors

    def match(self, xy0, desc0, mask0, xy1, desc1, mask1, size: tuple) -> tuple:
        """LightGlue over B pairs of keypoints xy [B, K, 2], descriptors
        [B, K, D] and masks [B, K] in images of size (w, h): (log-assignment
        [B, K + 1, K + 1] f32, matches0 [B, K] int64, -1 where none;
        mscores0 [B, K])."""
        return self.lightglue(torch.cat([xy0, xy1]), torch.cat([desc0, desc1]), torch.cat([mask0, mask1]), size)
