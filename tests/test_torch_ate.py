"""The port's VO held to the repo's ATE gate on the lateral scene.

The same gate as `tests/test_ate.py` (the fast tier and, under `-m slow`,
the 160-frame one): `VoConfig()`, chunk 32, seed 0, the same fair lateral
scene and the same assertions: success >= 0.90 of pairs, common pairs with
the cv2 oracle >= 0.85 (0.9 at 160 frames), ATE over the common path < 0.2
per step, and ATE <= 1.01x the oracle's. The port runs on the CPU with its
own draws (`pair_uniforms` under seed 0); the oracle draws none of them.
The forward corridor is in `tests/test_torch_ate_forward.py`, a file of
its own so that the two gates run on two workers at once.
"""

import pytest
import torch

from slamtpu_torch import convert
from slamtpu_torch.odometry.camera import CameraIntrinsics
from slamtpu_torch.pipeline.vo import VoConfig, run_vo
from test_ate import N_FRAMES, UNIFIED, _ate_vs_oracle, _fair_scene

torch.set_num_threads(1)


def port_run(scene):
    """run_vo of the port on a scene rendered by the JAX package's cached
    renderer: the port's own CameraIntrinsics, built from the four fields."""
    i = scene.intrinsics
    cam = CameraIntrinsics(float(i.fx), float(i.fy), float(i.cx), float(i.cy))
    return run_vo(scene.frames, cam, VoConfig(), chunk_size=32, seed=0, device="cpu")


def gate(scene, min_common: float, label: str):
    run = port_run(scene)
    common, n_pairs, ate_ours, ate_oracle = _ate_vs_oracle(scene, run)
    ratio = ate_ours / max(ate_oracle, 1e-12)
    print(f"\n{label}: port {run.successful_frames}/{n_pairs} successes, {len(common)} common; "
          f"ATE port {ate_ours:.4f} vs oracle {ate_oracle:.4f}, ratio {ratio:.3f}")
    assert run.successful_frames >= 0.90 * n_pairs
    assert len(common) >= min_common * n_pairs
    assert ate_ours / len(common) < 0.2
    assert ate_ours <= 1.01 * ate_oracle, f"port {ate_ours:.4f} vs oracle {ate_oracle:.4f} (ratio {ratio:.3f} > 1.01)"


def test_port_config_is_the_unified_config():
    assert convert.config_from_jax(UNIFIED) == VoConfig()


def test_port_ate_north_star_fast_tier():
    gate(_fair_scene(80), 0.85, "lateral, 80 frames")


@pytest.mark.slow
def test_port_ate_within_north_star():
    gate(_fair_scene(N_FRAMES), 0.9, f"lateral, {N_FRAMES} frames")
