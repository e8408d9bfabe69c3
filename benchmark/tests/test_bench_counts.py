"""The kernels' byte and operation counts of benchmark/inputs."""

import numpy as np
import torch

from benchmark.inputs import kernel_counts as kc
from benchmark.inputs import scene as scene_mod
from benchmark.reference.plainslam.ops.pyramid import pyramid_shapes


def test_k1_bytes_of_a_kitti_chunk():
    """One 32-frame chunk of 1241x376 at 8 levels, the Harris map kept on
    levels 0-2: 499.6 MB and 46,211,104 pixels, the port's own figures."""
    shapes = [(32, h, w) for h, w in pyramid_shapes(376, 1241, 8, 1.2)]
    flags = [lv <= 2 for lv in range(8)]
    assert kc.k1_pixels(shapes) == 46_211_104
    assert round(kc.k1_bytes(shapes, flags) / 1e6, 1) == 499.6


def test_bound_takes_the_larger_term():
    assert kc.bound_s(3.35e12) == 1.0
    assert kc.bound_s(1.0, 67e12 * 2) == 2.0
    assert kc.k1_ops(10, 2) == 83 * 10 + 179 * 2


def test_k2_reads_each_covered_pixel_once():
    size = 5
    starts = torch.tensor([[[0, 0], [2, 0], [100, 100]]], dtype=torch.int32)  # overlap, then clamped to (15, 15)
    # windows [0,5)x[0,5) and [2,7)x[0,5) cover 7 x 5; the clamped one 5 x 5 more
    assert kc.k2_read_bytes((1, 20, 20), starts, size) == 4 * (35 + 25)
    assert kc.k2_write_bytes(1, 3, size) == 4 * 3 * 25


def test_compass_candidates_per_frame():
    sc = scene_mod.render(3, 80, 120, dict(fx=100, fy=100, cx=60, cy=40), 200, 0.8, seed=3, textured=True)
    counts = kc.compass_candidates(sc.frames, 2, 1.2, 20.0, "cpu", block=2)
    assert counts.shape == (3,) and (counts > 0).all()
    assert np.array_equal(counts, kc.compass_candidates(sc.frames, 2, 1.2, 20.0, "cpu", block=3))
