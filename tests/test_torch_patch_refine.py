"""The port's sub-pixel match refinement (slamtpu_torch/ops/patch_refine.py)
against the JAX package's `refine_matches`, on the cases of
tests/test_patch_refine.py plus the border and the batch.

Tolerances: on integer-valued (uint8) frames every SSD is an exact integer
in f32, so the integer argmin is exact and the refined point differs only
by the parabola's division: within 1e-5 px. On smooth float frames the
SSD sums round differently (the reference's reduction order is XLA's), so
the argmin is held exact and the sub-pixel term within 1e-5 as well.
Masked slots pass through untouched; windows at the border are placed as
`lax.dynamic_slice` places them (a negative start counts from the end of
its axis, then clamps into the image).
"""

import numpy as np
import pytest
import torch

from slamtpu.ops.patch_refine import refine_matches as j_refine
from slamtpu_torch.ops.patch_refine import refine_matches

from test_patch_refine import _shift_bilinear, _smooth_image

torch.set_num_threads(1)


def _both(img1, img2, p1, p2, mask=None, radius=4, search=2):
    ref = np.asarray(j_refine(img1, img2, p1, p2, None if mask is None else mask, radius=radius, search=search))
    ours = refine_matches(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(p1), torch.from_numpy(p2),
                          None if mask is None else torch.from_numpy(mask), radius=radius, search=search)
    assert ours.dtype == torch.float32
    return ours.numpy(), ref


def _check(ours, ref, p2):
    # The integer part (the argmin) is exact; the sub-pixel term within 1e-5.
    np.testing.assert_array_equal(np.round(ours - np.round(p2)), np.round(ref - np.round(p2)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shift", [(0.3, -0.4), (1.2, 0.7)])
@pytest.mark.parametrize("quantize", [False, True])
def test_known_subpixel_shift_matches_jax(shift, quantize):
    img1 = _smooth_image(96, 128)
    img2 = _shift_bilinear(img1, *shift)
    if quantize:
        img1, img2 = (np.clip(np.round(x), 0, 255).astype(np.uint8) for x in (img1, img2))
    rng = np.random.default_rng(1)
    p1 = np.round(np.stack([rng.uniform(20, 108, 40), rng.uniform(20, 76, 40)], axis=1)).astype(np.float32)
    true_p2 = p1 + np.array(shift, np.float32)
    p2 = np.round(true_p2 + rng.uniform(-0.6, 0.6, size=(40, 2))).astype(np.float32)
    ours, ref = _both(img1, img2, p1, p2)
    _check(ours, ref, p2)
    if not quantize:
        assert np.median(np.linalg.norm(ours - true_p2, axis=1)) < 0.2


def test_masked_slots_pass_through_and_border_windows_clamp():
    img1 = (_smooth_image(64, 80, seed=2)).astype(np.float32)
    img2 = _shift_bilinear(img1, 0.5, -0.3)
    # Centres at and beyond the border: negative starts wrap to the far end,
    # then every start clamps into the image.
    p1 = np.array([[30.0, 30.0], [40.0, 25.0], [1.0, 2.0], [79.0, 63.0], [-3.0, 70.0], [5.4, 60.6]], np.float32)
    p2 = np.array([[31.0, 30.0], [40.0, 25.0], [2.0, 1.0], [78.0, 62.0], [0.0, 66.0], [6.0, 59.5]], np.float32)
    mask = np.array([True, False, True, True, True, True])
    ours, ref = _both(img1, img2, p1, p2, mask)
    _check(ours, ref, p2)
    np.testing.assert_array_equal(ours[1], p2[1])
    assert not np.allclose(ours[0], p2[0])


def test_flat_patch_keeps_the_centre():
    img = np.full((64, 64), 128.0, np.float32)
    p = np.array([[32.0, 32.0], [10.0, 50.0]], np.float32)
    ours, ref = _both(img, img, p, p)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours, p, atol=1e-6)


def test_batched_pairs_and_wider_search_match_jax():
    rng = np.random.default_rng(3)
    frames = np.stack([_smooth_image(72, 96, seed=s) for s in range(3)])
    frames = np.clip(np.round(frames), 0, 255).astype(np.uint8)
    p1 = np.round(np.stack([rng.uniform(0, 95, (2, 30)), rng.uniform(0, 71, (2, 30))], -1)).astype(np.float32)
    p2 = (p1 + rng.uniform(-2.5, 2.5, p1.shape)).astype(np.float32)
    mask = rng.uniform(size=(2, 30)) > 0.2
    ours = refine_matches(torch.from_numpy(frames[:-1]), torch.from_numpy(frames[1:]), torch.from_numpy(p1),
                          torch.from_numpy(p2), torch.from_numpy(mask), radius=6, search=3).numpy()
    for i in range(2):
        ref = np.asarray(j_refine(frames[i], frames[i + 1], p1[i], p2[i], mask[i], radius=6, search=3))
        _check(ours[i], ref, p2[i])
