"""Keyframe selection (counterpart of slamtpu/mapping/keyframe.py).

A frame is a keyframe iff frames_since_last + 1 >= max_frames, or
||t|| >= min_translation, or its rotation angle >= min_rotation, or (with a
previous keyframe) num_matches / last_keyframe_matches < min_match_ratio.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.lie import rotation_angle

__all__ = ["KeyframeConfig", "KeyframeSelector", "KeyframeState", "keyframe_step", "select_keyframes"]


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
    """One selection step -> (new_state, is_keyframe bool); batched over
    leading dimensions of the state and inputs."""
    frames = state.frames_since_last + 1
    force = frames >= config.max_frames
    trans = torch.linalg.vector_norm(translation, dim=-1) >= config.min_translation
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


def select_keyframes(config: KeyframeConfig, rotations, translations, num_matches, state=None):
    """The selector over a clip, step by step: rotations [T, 3, 3],
    translations [T, 3], num_matches [T] -> (final state, is_keyframe [T]
    bool). Each step depends on the state the previous one left."""
    if state is None:
        state = KeyframeState.initial(rotations.device)
    num_matches = torch.as_tensor(num_matches, device=rotations.device)
    flags = []
    for r, t, n in zip(rotations, translations, num_matches):
        state, kf = keyframe_step(config, state, r, t, n)
        flags.append(kf)
    if not flags:
        return state, torch.zeros((0,), dtype=torch.bool, device=rotations.device)
    return state, torch.stack(flags)


class KeyframeSelector:
    """Frame-at-a-time selector. Its state lives on `device` ("cuda"
    unless the caller asks for the CPU); each decision is read back to the
    host as a bool."""

    def __init__(self, config: KeyframeConfig | None = None, device=None):
        self.config = config or KeyframeConfig()
        self.device = resolve_device(device)
        self._state = KeyframeState.initial(self.device)

    def should_be_keyframe(self, rotation, translation, num_matches: int) -> bool:
        self._state, is_kf = keyframe_step(
            self.config, self._state,
            torch.as_tensor(rotation, device=self.device),
            torch.as_tensor(translation, device=self.device),
            torch.as_tensor(num_matches, dtype=torch.int32, device=self.device),
        )
        return bool(is_kf)

    def reset(self) -> None:
        self._state = KeyframeState.initial(self.device)

    def mark_as_keyframe(self, num_matches: int) -> None:
        self._state = KeyframeState(torch.zeros((), dtype=torch.int32, device=self.device),
                                    torch.tensor(num_matches, dtype=torch.int32, device=self.device))

    @property
    def frames_since_last(self) -> int:
        return int(self._state.frames_since_last)
