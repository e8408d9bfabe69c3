"""MonoDepth2 checkpoints in the upstream layout -> the port's modules
(counterpart of slamtpu/depth/convert.py).

The upstream `encoder.pth` / `depth.pth` are torch state dicts. The port's
modules carry upstream's names (models/resnet.py, models/depth_decoder.py),
so the conversion is a short list of explicit edits; whatever else differs
fails loudly under `load_state_dict(strict=True)`:
  * encoder: strip the `encoder.` prefix of upstream's ResnetEncoder, its
    `height` / `width` / `use_stereo` metadata, and torchvision's classifier
    head `fc.*`, which ResnetEncoder holds but never runs;
  * decoder: the keys carry over unchanged (`decoder.{idx}.conv.conv.*`
    for a conv block, `decoder.{idx}.conv.*` for a disparity head).
Values become tensors; arrays of any kind are accepted.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_encoder", "convert_decoder", "load_state_dict"]

_ENCODER_METADATA = ("height", "width", "use_stereo")
_ENCODER_UNUSED_PREFIX = "fc."


def load_state_dict(path: str) -> dict:
    """A `.pth` state dict, read without unpickling arbitrary objects."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if torch.is_tensor(v) else torch.from_numpy(np.array(v))


def convert_encoder(state_dict) -> dict:
    """encoder.pth state dict -> a state dict for ResNet18Encoder."""
    out = {}
    for key, value in state_dict.items():
        if key in _ENCODER_METADATA:
            continue
        key = key[len("encoder."):] if key.startswith("encoder.") else key
        if not key.startswith(_ENCODER_UNUSED_PREFIX):
            out[key] = _tensor(value)
    return out


def convert_decoder(state_dict) -> dict:
    """depth.pth state dict -> a state dict for DepthDecoder (same keys)."""
    return {key: _tensor(value) for key, value in state_dict.items()}
