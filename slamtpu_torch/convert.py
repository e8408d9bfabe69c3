"""Moving state and weights across from the JAX package.

`monodepth2_from_flax` carries MonoDepth2's Flax variable trees into the
port's state dicts; everything else that crosses over is state and
configuration. `carry_from_numpy` takes the JAX VO carry (OrbFeatures,
KeyframeState, 4x4 pose) as numpy arrays and returns the port's tensors, so
a run started by the JAX package can be continued here; `map_state_from_numpy`
and `point_cloud_result_from_numpy` do the same for the flagship's map,
keyframe chain, observation log and trajectory (so `run_global_ba` and the
map ops can continue JAX state), and `fused_carry_from_numpy` for the
fused flagship's phase-2 carry. `config_from_jax` and
`point_cloud_config_from_jax` map the field values of objects shaped like
the JAX package's VoConfig / PointCloudConfig (read by attribute name;
nothing of that package is imported) onto the port's dataclasses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .feature.detector import OrbConfig, OrbFeatures
from .mapping.bundle_adjustment import BaConfig
from .mapping.keyframe import KeyframeConfig, KeyframeState
from .mapping.map import MapState
from .odometry.trajectory import Trajectory, TrajectoryPoint
from .ops.ransac import RansacConfig
from .pipeline.point_cloud import PointCloudConfig, PointCloudResult, _FusedCarry
from .pipeline.vo import VoConfig

__all__ = ["carry_from_numpy", "config_from_jax", "point_cloud_config_from_jax", "map_state_from_numpy",
           "point_cloud_result_from_numpy", "fused_carry_from_numpy", "monodepth2_from_flax"]

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
_NESTED = {"orb": OrbConfig, "ransac": RansacConfig, "keyframe": KeyframeConfig, "vo": VoConfig,
           "ba": BaConfig}


def _convert(cls, obj):
    known = {f.name for f in dataclasses.fields(cls)}
    extra = {f.name for f in dataclasses.fields(obj)} - known - _SKIPPED
    if extra:
        raise ValueError(f"{type(obj).__name__} fields with no port counterpart: {sorted(extra)}")
    kwargs = {}
    for name in known:
        value = getattr(obj, name)
        kwargs[name] = _convert(_NESTED[name], value) if name in _NESTED else value
    return cls(**kwargs)


def config_from_jax(jax_config) -> VoConfig:
    """The port's VoConfig with the field values of a JAX VoConfig."""
    return _convert(VoConfig, jax_config)


def point_cloud_config_from_jax(jax_config) -> PointCloudConfig:
    """The port's PointCloudConfig (nested vo and ba) with the field values
    of a JAX PointCloudConfig."""
    return _convert(PointCloudConfig, jax_config)


_MAP_DTYPES = dict(positions=torch.float32, descriptors=torch.uint8, observations=torch.int32,
                   ids=torch.int32, valid=torch.bool, next_id=torch.int32)


def map_state_from_numpy(state, device=None) -> MapState:
    """A MapState-like object of arrays (positions, descriptors,
    observations, ids, valid, next_id) -> the port's MapState on `device`."""
    return MapState(**{name: torch.tensor(np.asarray(getattr(state, name)), dtype=dt, device=device)
                       for name, dt in _MAP_DTYPES.items()})


def point_cloud_result_from_numpy(result, device=None) -> PointCloudResult:
    """A JAX PointCloudResult (read by attribute name) -> the port's: map
    state on `device`, keyframe chain, observation log as arrays and the
    reference-style trajectory."""
    traj = Trajectory()
    traj.global_pose = np.array(result.trajectory.global_pose, dtype=np.float64)
    traj.points = [TrajectoryPoint(int(p.frame), [float(v) for v in p.position], float(p.timestamp))
                   for p in result.trajectory.points]
    obs_kf, obs_pt, obs_px, obs_id = result.observations
    observations = (np.asarray(obs_kf, np.int32).reshape(-1), np.asarray(obs_pt, np.int32).reshape(-1),
                    np.asarray(obs_px, np.float32).reshape(-1, 2), np.asarray(obs_id, np.int32).reshape(-1))
    return PointCloudResult(
        map_state=map_state_from_numpy(result.map_state, device),
        trajectory=traj,
        keyframe_rotations=np.asarray(result.keyframe_rotations),
        keyframe_translations=np.asarray(result.keyframe_translations),
        keyframe_frame_idx=np.asarray(result.keyframe_frame_idx),
        ba_runs=int(result.ba_runs),
        total_frames=int(result.total_frames),
        successful_frames=int(result.successful_frames),
        observations=observations,
    )


def fused_carry_from_numpy(carry, device=None) -> _FusedCarry:
    """A JAX fused-flagship carry (read by field name, numpy arrays or
    anything numpy converts) -> the port's _FusedCarry on `device`. Poses
    keep their dtype (f64 from a JAX run under x64); the bf16 descriptor
    bits cross as exact 0/1 values."""
    fields = {}
    for name in _FusedCarry._fields:
        value = getattr(carry, name)
        if name == "map_state":
            fields[name] = map_state_from_numpy(value, device)
        elif name == "kf_count":
            fields[name] = int(np.asarray(value))
        elif name == "map_bits":
            fields[name] = torch.tensor(np.asarray(value, np.float32), device=device).to(torch.bfloat16)
        else:
            fields[name] = torch.tensor(np.asarray(value), device=device)
    return _FusedCarry(**fields)


def _conv_weight(kernel) -> torch.Tensor:
    """A Flax HWIO kernel -> a torch OIHW weight."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def _batch_norm(prefix, params, stats) -> dict:
    out = {name: torch.from_numpy(np.array(tree[key], np.float32))
           for name, tree, key in (("weight", params, "scale"), ("bias", params, "bias"),
                                   ("running_mean", stats, "mean"), ("running_var", stats, "var"))}
    out["num_batches_tracked"] = torch.tensor(0)
    return {f"{prefix}.{k}": v for k, v in out.items()}


def monodepth2_from_flax(encoder_vars, decoder_vars):
    """MonoDepth2's Flax variables (the JAX package's ResNet18Encoder
    {params, batch_stats} and DepthDecoder {params} trees; numpy arrays or
    anything numpy converts) -> (encoder, decoder) state dicts for the port's
    ResNet18Encoder and DepthDecoder. Conv kernels go from HWIO to OIHW;
    BatchNorm scale / bias / mean / var become weight / bias / running_mean
    / running_var."""
    params, stats = encoder_vars["params"], encoder_vars["batch_stats"]
    encoder = {"conv1.weight": _conv_weight(params["conv1"]["kernel"]),
               **_batch_norm("bn1", params["bn1"], stats["bn1"])}
    for stage in range(1, 5):
        for block in range(2):
            p, s, tp = params[f"layer{stage}_{block}"], stats[f"layer{stage}_{block}"], f"layer{stage}.{block}"
            for i in (1, 2):
                encoder[f"{tp}.conv{i}.weight"] = _conv_weight(p[f"conv{i}"]["kernel"])
                encoder.update(_batch_norm(f"{tp}.bn{i}", p[f"bn{i}"], s[f"bn{i}"]))
            if "downsample_conv" in p:
                encoder[f"{tp}.downsample.0.weight"] = _conv_weight(p["downsample_conv"]["kernel"])
                encoder.update(_batch_norm(f"{tp}.downsample.1", p["downsample_bn"], s["downsample_bn"]))

    # The port's ModuleList order: upconv (4, 0), (4, 1), ..., (0, 1), then
    # the disparity heads by scale.
    dparams = decoder_vars["params"]
    names = [(f"upconv_{i}_{j}", "conv.conv") for i in range(4, -1, -1) for j in (0, 1)]
    names += [(f"dispconv_{s}", "conv") for s in range(4)]
    decoder = {}
    for idx, (name, inner) in enumerate(names):
        conv = dparams[name]["conv"]
        decoder[f"decoder.{idx}.{inner}.weight"] = _conv_weight(conv["kernel"])
        decoder[f"decoder.{idx}.{inner}.bias"] = torch.from_numpy(np.array(conv["bias"], np.float32))
    return encoder, decoder
