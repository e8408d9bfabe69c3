"""Unified configuration tree (counterpart of slamtpu/utils/config.py).

One frozen dataclass tree over the port's config dataclasses covers the
whole frontend, JSON-(de)serializable for CLI `--config` files and
reproducible runs. A JSON written by the JAX package's `save_config` loads
here: the fields with no port counterpart are accepted and dropped by the
rule `convert.py` uses (`convert._SKIPPED`); any other unknown key raises.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from ..convert import _SKIPPED
from ..feature.detector import OrbConfig
from ..mapping.bundle_adjustment import BaConfig
from ..mapping.keyframe import KeyframeConfig
from ..ops.ransac import RansacConfig
from ..pipeline.point_cloud import PointCloudConfig
from ..pipeline.vo import VoConfig

__all__ = ["SlamConfig", "to_json", "from_json", "load_config", "save_config"]


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Everything in one tree, the JAX package's fields and defaults."""

    orb: OrbConfig = OrbConfig()
    ransac: RansacConfig = RansacConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    ba: BaConfig = BaConfig()
    match_ratio: float = 2.0
    min_matches: int = 8
    fps: float = 30.0
    map_capacity: int = 65536
    ba_interval: int = 5
    ba_window: int = 5
    prune_interval: int = 10
    min_observations: int = 2

    def vo(self) -> VoConfig:
        return VoConfig(
            orb=self.orb,
            ransac=self.ransac,
            keyframe=self.keyframe,
            match_ratio=self.match_ratio,
            min_matches=self.min_matches,
            fps=self.fps,
        )

    def point_cloud(self) -> PointCloudConfig:
        return PointCloudConfig(
            vo=self.vo(),
            ba_interval=self.ba_interval,
            ba_window=self.ba_window,
            prune_interval=self.prune_interval,
            map_capacity=self.map_capacity,
            ba=self.ba,
            min_observations=self.min_observations,
        )


def _to_dict(obj: Any):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def _from_dict(cls, data: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields) - _SKIPPED
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    kwargs = {}
    for name, v in data.items():
        if name not in fields:
            continue
        f = fields[name]
        if isinstance(v, dict):
            # Nested config: its class comes from the field's default value.
            kwargs[name] = _from_dict(type(f.default), v)
        else:
            kwargs[name] = v
    return cls(**kwargs)


def to_json(config: SlamConfig) -> str:
    return json.dumps(_to_dict(config), indent=2)


def from_json(text: str) -> SlamConfig:
    return _from_dict(SlamConfig, json.loads(text))


def save_config(config: SlamConfig, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_json(config))


def load_config(path: str) -> SlamConfig:
    with open(path) as f:
        return from_json(f.read())
