"""The comparison that decides `correct`, at a small size on the CPU: a
sound run of the port passes every limit of its cell, and the control (the
plain reference in the port's place with its matrix products in TF32)
fails at least one."""

import pytest

from benchmark import calibrate
from benchmark.tests import small

CELLS = ["vo-clip257", "flagship-clip257", "vo-batch4"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_passes_and_the_control_fails(cell):
    spec, config, traffic, limits = small.files(cell)
    r = calibrate.readings(cell, 2**31 + 17, True, "cpu", spec, config, traffic)
    lim = limits["limits"]
    assert all(r["sound"][k] <= v for k, v in lim.items()), r["sound"]
    assert any(r["control_tf32"][k] > v for k, v in lim.items()), r["control_tf32"]
