"""Moving state across from the JAX package.

VO has no learned weights; what crosses over is the run's carry and its
configuration. `carry_from_numpy` takes the JAX carry (OrbFeatures,
KeyframeState, 4x4 pose) as numpy arrays and returns the port's tensors, so
a run started by the JAX package can be continued here. `config_from_jax`
maps the field values of any object shaped like the JAX package's VoConfig
(read by attribute name; nothing of that package is imported) onto the
port's dataclasses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .feature.detector import OrbConfig, OrbFeatures
from .mapping.keyframe import KeyframeConfig, KeyframeState
from .ops.ransac import RansacConfig
from .pipeline.vo import VoConfig

__all__ = ["carry_from_numpy", "config_from_jax"]

_FEATURE_DTYPES = dict(
    xy=torch.float32, response=torch.float32, angle=torch.float32, octave=torch.int32,
    size=torch.float32, descriptors=torch.uint8, mask=torch.bool,
)


def carry_from_numpy(prev_feats, kf_state, global_pose, device=None):
    """(OrbFeatures-like, KeyframeState-like, [4, 4]) of numpy arrays (any
    objects with those field names) -> the port's carry on `device`."""
    feats = OrbFeatures(**{
        name: torch.tensor(np.asarray(getattr(prev_feats, name)), dtype=dt, device=device)
        for name, dt in _FEATURE_DTYPES.items()
    })
    state = KeyframeState(*[
        torch.tensor(np.asarray(getattr(kf_state, name)), dtype=torch.int32, device=device)
        for name in KeyframeState._fields
    ])
    pose = torch.tensor(np.asarray(global_pose), dtype=torch.float64, device=device)
    return feats, state, pose


# JAX fields with no port counterpart. exact_topk and corner_backend only
# steer TPU code paths: selection is always exact here and the corner kernel
# is chosen by tensor device. The others tune paths that raise
# NotImplementedError here when switched on (refine_matches,
# homography_fallback), so they are read by nothing.
_SKIPPED = {"exact_topk", "corner_backend", "refine_radius", "refine_search", "homography_ratio",
            "homography_iters"}


def _convert(cls, obj):
    known = {f.name for f in dataclasses.fields(cls)}
    extra = {f.name for f in dataclasses.fields(obj)} - known - _SKIPPED
    if extra:
        raise ValueError(f"{type(obj).__name__} fields with no port counterpart: {sorted(extra)}")
    nested = {"orb": OrbConfig, "ransac": RansacConfig, "keyframe": KeyframeConfig}
    kwargs = {}
    for name in known:
        value = getattr(obj, name)
        kwargs[name] = _convert(nested[name], value) if name in nested else value
    return cls(**kwargs)


def config_from_jax(jax_config) -> VoConfig:
    """The port's VoConfig with the field values of a JAX VoConfig."""
    return _convert(VoConfig, jax_config)
