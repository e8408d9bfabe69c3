"""The port's VO held to the repo's ATE gate on the forward corridor (the
KITTI regime, epipole in the image): the gate of
`tests/test_ate.py::test_ate_forward_corridor_fast_tier` and, under
`-m slow`, its 160-frame gate, on the port on the CPU. The gate itself is
`tests/test_torch_ate.py::gate`."""

import pytest
import torch

from test_ate import N_FRAMES, _fair_forward_scene
from test_torch_ate import gate

torch.set_num_threads(1)


def test_port_ate_forward_corridor_fast_tier():
    gate(_fair_forward_scene(80), 0.85, "forward, 80 frames")


@pytest.mark.slow
def test_port_ate_forward_corridor_within_north_star():
    gate(_fair_forward_scene(N_FRAMES), 0.9, f"forward, {N_FRAMES} frames")
