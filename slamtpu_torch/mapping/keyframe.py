"""Keyframe selection (counterpart of slamtpu/mapping/keyframe.py).

A frame is a keyframe iff frames_since_last + 1 >= max_frames, or
||t|| >= min_translation, or its rotation angle >= min_rotation, or (with a
previous keyframe) num_matches / last_keyframe_matches < min_match_ratio.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.lie import rotation_angle

__all__ = ["KeyframeConfig", "KeyframeState", "keyframe_step"]


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    min_translation: float = 0.1
    min_rotation: float = 0.1
    min_match_ratio: float = 0.8
    max_frames: int = 10


class KeyframeState(NamedTuple):
    """Selector state carried from step to step."""

    frames_since_last: torch.Tensor  # int32 scalar
    last_keyframe_matches: torch.Tensor  # int32 scalar

    @staticmethod
    def initial(device=None) -> "KeyframeState":
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return KeyframeState(zero, zero.clone())


def keyframe_step(config: KeyframeConfig, state: KeyframeState, rotation, translation, num_matches):
    """One selection step -> (new_state, is_keyframe bool scalar)."""
    frames = state.frames_since_last + 1
    force = frames >= config.max_frames
    trans = torch.linalg.vector_norm(translation) >= config.min_translation
    rot = rotation_angle(rotation) >= config.min_rotation
    have_prev = state.last_keyframe_matches > 0
    ratio = num_matches.to(torch.float32) / torch.clamp(
        state.last_keyframe_matches.to(torch.float32), min=1.0
    )
    degraded = have_prev & (ratio < config.min_match_ratio)

    is_kf = force | trans | rot | degraded
    new_state = KeyframeState(
        frames_since_last=torch.where(is_kf, torch.zeros_like(frames), frames).to(
            state.frames_since_last.dtype
        ),
        last_keyframe_matches=torch.where(
            is_kf, num_matches.to(state.last_keyframe_matches.dtype), state.last_keyframe_matches
        ),
    )
    return new_state, is_kf
