"""The port's ORB detector against the JAX package: dense maps, both
kernels' plain versions against the Pallas kernels (interpret mode), the
BRIEF tables, and the whole detector.

Tolerances and why:
  * pyramid and blur: rtol 1e-5 (atol 1e-4 grey levels) — XLA fuses the
    weighted sums into FMAs, PyTorch rounds each product, so the two differ
    in the last bits;
  * FAST score and NMS: exact on the same input (subtracts and compares);
  * Harris: rtol 1e-5 of the level's largest magnitude — det - k tr^2 is a
    difference of large products, so near-zero values carry their
    neighbours' rounding;
  * K1 plain vs the Pallas kernel: the bar of tests/test_pallas_corner.py;
  * K2 plain vs the Pallas kernel: bit-exact;
  * whole detector: identical keypoint sets and masks, xy within 1e-4 px,
    descriptor bytes identical except where a test's outcome is decided by
    rounding: a keypoint whose angle lies within 1e-3 rad of a 30-degree
    bin boundary (atan2 and the moment sums differ by an ulp), or a bit
    whose two blurred samples differ by less than 1e-3 grey levels (the
    blur tolerance above).
"""

import math

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.feature import detector as jdet
from slamtpu.ops import brief as jbrief
from slamtpu.ops import fast as jfast
from slamtpu.ops import harris as jharris
from slamtpu.ops import pyramid as jpyr
from slamtpu.ops.pallas_corner import corner_response as j_corner_pallas
from slamtpu.ops.pallas_patch import extract_patches_batched as j_patch_pallas
from slamtpu_torch.feature import detector as tdet
from slamtpu_torch.ops import brief as tbrief
from slamtpu_torch.ops import fast as tfast
from slamtpu_torch.ops import harris as tharris
from slamtpu_torch.ops import pyramid as tpyr
from slamtpu_torch.ops.corner import corner_response, corner_response_plain
from slamtpu_torch.ops.patch import extract_patches_batched, extract_patches_plain

torch.set_num_threads(1)


def texture(rng, h, w):
    """tests/test_orb.py's synthetic texture: smoothed noise + blobs, uint8."""
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.5)
    for _ in range(40):
        x, y = rng.integers(20, w - 20), rng.integers(20, h - 20)
        r = int(rng.integers(3, 10))
        cv2.circle(img, (int(x), int(y)), r, float(rng.uniform(0, 255)), -1)
    img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)
    return img.astype(np.uint8)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return np.stack([texture(rng, 120, 200) for _ in range(3)]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_levels(frames):
    return [np.array(x) for x in jpyr.build_pyramid(jnp.asarray(frames), 4, 1.2)]


def test_pyramid_and_blur_match_jax(frames, jax_levels):
    ours = tpyr.build_pyramid(torch.from_numpy(frames), 4, 1.2)
    assert [tuple(x.shape) for x in ours] == [x.shape for x in jax_levels]
    for lv, (a, b) in enumerate(zip(ours, jax_levels)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-4, err_msg=f"level {lv}")
        blur_ref = np.asarray(jpyr.gaussian_blur(jnp.asarray(b)))
        np.testing.assert_allclose(tpyr.gaussian_blur(torch.from_numpy(b)).numpy(), blur_ref,
                                   rtol=1e-5, atol=1e-4, err_msg=f"blur level {lv}")


def test_fast_nms_harris_match_jax(jax_levels):
    for lv, img in enumerate(jax_levels):
        ours = tfast.nms3x3(tfast.fast_score(torch.from_numpy(img), 20.0)).numpy()
        ref = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img), 20.0)))
        np.testing.assert_array_equal(ours, ref, err_msg=f"FAST+NMS level {lv}")
        assert (ours > 0).sum() > 50
        h_ours = tharris.harris_response(torch.from_numpy(img)).numpy()
        h_ref = np.asarray(jharris.harris_response(jnp.asarray(img)))
        np.testing.assert_allclose(h_ours, h_ref, rtol=1e-5, atol=1e-5 * np.abs(h_ref).max())


def _pallas_test_image(rng):
    """tests/test_pallas_corner.py's input."""
    img = rng.uniform(0, 255, size=(96, 200)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.0)
    for _ in range(25):
        cv2.circle(img, (int(rng.integers(15, 185)), int(rng.integers(15, 81))), int(rng.integers(2, 6)),
                   float(rng.uniform(0, 255)), -1)
    return np.stack([img, img[::-1].copy()])


def test_k1_plain_matches_pallas_kernel(rng):
    imgs = _pallas_test_image(rng)
    ref_rank, ref_harris = (np.asarray(x) for x in j_corner_pallas(jnp.asarray(imgs), 20.0, interpret=True,
                                                                     with_harris=True))
    ours_rank, ours_harris = (x.numpy() for x in corner_response(torch.from_numpy(imgs), 20.0, with_harris=True))
    np.testing.assert_array_equal(corner_response(torch.from_numpy(imgs), 20.0).numpy(), ours_rank)
    m = 10  # the Pallas kernel's column roll and edge padding differ only near the border
    a, b = ours_rank[:, m:-m, m:-m], ref_rank[:, m:-m, m:-m]
    assert (np.isfinite(a) == np.isfinite(b)).mean() > 0.999
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 50
    np.testing.assert_allclose(a[both], b[both], rtol=1e-4)
    hb = ref_harris[:, m:-m, m:-m]
    np.testing.assert_allclose(ours_harris[:, m:-m, m:-m], hb, rtol=1e-4, atol=1e-5 * np.abs(hb).max())


def test_k1_plain_blank_image():
    imgs = np.zeros((1, 64, 128), np.float32)
    ref = np.asarray(j_corner_pallas(jnp.asarray(imgs), 20.0, interpret=True))
    assert not np.isfinite(ref).any()
    assert not torch.isfinite(corner_response_plain(torch.from_numpy(imgs), 20.0)).any()


def test_k2_plain_matches_pallas_kernel():
    """Bit-exact against the Pallas window kernel, including clamped
    out-of-range starts (tests/test_pallas_corner.py's case plus starts
    beyond every edge)."""
    rng = np.random.default_rng(7)
    b, h, w, k, r = 3, 90, 260, 17, tbrief.PATCH_RADIUS
    imgs = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    xy = np.stack([rng.integers(r, w - r, (b, k)), rng.integers(r, h - r, (b, k))], -1)
    xy[:, 0] = (r, r)
    xy[:, 1] = (w - r - 1, h - r - 1)
    starts = (xy - r).astype(np.int32)
    starts[:, 2] = (-5, -9)
    starts[:, 3] = (w, h + 3)
    ref = np.asarray(j_patch_pallas(jnp.asarray(imgs), jnp.asarray(starts), r, interpret=True))
    ours = extract_patches_batched(torch.from_numpy(imgs), torch.from_numpy(starts), r).numpy()
    np.testing.assert_array_equal(ours, ref)
    single = tbrief.extract_patches(torch.from_numpy(imgs[0]), torch.from_numpy(xy[0].astype(np.float32)), r)
    np.testing.assert_array_equal(single.numpy(), np.asarray(
        jbrief.extract_patches(jnp.asarray(imgs[0]), jnp.asarray(xy[0], jnp.float32), r)))
    assert extract_patches_plain(torch.from_numpy(imgs), torch.from_numpy(starts), r).shape == (b, k, 39, 39)


def test_brief_tables_equal_jax():
    np.testing.assert_array_equal(tbrief.brief_pattern(), np.asarray(jbrief.brief_pattern()))
    np.testing.assert_array_equal(tbrief._binned_sample_indices(12), np.asarray(jbrief._binned_sample_indices(12)))
    for n, lv in ((500, 8), (64, 4), (300, 8)):
        assert tdet.features_per_level(n, lv, 1.2) == jdet.features_per_level(n, lv, 1.2)


def test_orientation_and_binned_descriptors_match_jax(frames, rng):
    blurred = tpyr.gaussian_blur(torch.from_numpy(frames)).numpy()
    ys, xs = rng.integers(0, frames.shape[1] - 39, 60), rng.integers(0, frames.shape[2] - 39, 60)
    patches = np.stack([blurred[i % 3, y : y + 39, x : x + 39] for i, (y, x) in enumerate(zip(ys, xs))])
    ang_ref = np.array(jbrief.orientation(jnp.asarray(patches)))
    ang = tbrief.orientation(torch.from_numpy(patches))
    np.testing.assert_allclose(ang.numpy(), ang_ref, atol=1e-5)
    # Same angles into both descriptor functions: identical bytes.
    desc = tbrief.brief_descriptors_binned(torch.from_numpy(patches), torch.from_numpy(ang_ref), 12).numpy()
    desc_ref = np.asarray(jbrief.brief_descriptors_binned(jnp.asarray(patches), jnp.asarray(ang_ref), 12))
    np.testing.assert_array_equal(desc, desc_ref)


def _port_samples(frames, cfg):
    """Per keypoint slot: (angle, |v1 - v2| for the 256 tests) from the
    port's own pipeline stages, to judge which descriptor bits rounding can
    decide."""
    levels = tpyr.build_pyramid(torch.from_numpy(frames), cfg.n_levels, cfg.scale_factor)
    quotas = tdet.features_per_level(cfg.max_features, cfg.n_levels, cfg.scale_factor)
    gaps = []
    for lv, (img, q) in enumerate(zip(levels, quotas)):
        sub = lv <= cfg.subpixel_max_octave
        ranked, harris = corner_response_plain(img, cfg.fast_threshold, with_harris=True)
        xy_int = tdet._select_level(ranked, q, cfg.edge_threshold, harris if sub else None)[0]
        starts = (torch.round(xy_int).to(torch.int32) - tbrief.PATCH_RADIUS).contiguous()
        patches = extract_patches_plain(tpyr.gaussian_blur(img), starts, tbrief.PATCH_RADIUS)
        ang = tbrief.orientation(patches)
        frac = torch.remainder(ang / (2.0 * math.pi), 1.0)
        bins = torch.remainder(torch.round(frac * 12).long(), 12)
        idx = torch.from_numpy(tbrief._binned_sample_indices(12).astype(np.int64))[bins]
        vals = torch.gather(patches.reshape(*patches.shape[:2], -1), -1, idx)
        gaps.append((vals[..., :256] - vals[..., 256:]).abs())
    return torch.cat(gaps, dim=1).numpy()


def _boundary_distance(angle):
    step = 2.0 * math.pi / 12
    frac = (angle / step) % 1.0
    return np.abs(frac - 0.5) * step


@pytest.mark.parametrize("seed", [0, 1])
def test_detector_matches_jax(seed):
    rng = np.random.default_rng(seed)
    frames = np.stack([texture(rng, 120, 200) for _ in range(2)])
    cfg_j = jdet.OrbConfig(max_features=64, n_levels=4)
    cfg_t = tdet.OrbConfig(max_features=64, n_levels=4)
    ref = jdet.detect_and_compute(jnp.asarray(frames), cfg_j)
    ours = tdet.detect_and_compute(torch.from_numpy(frames), cfg_t)
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(ours.mask.numpy(), mask)
    assert mask.sum() > 60
    np.testing.assert_allclose(ours.xy.numpy(), np.asarray(ref.xy), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours.octave.numpy(), np.asarray(ref.octave))
    np.testing.assert_array_equal(ours.size.numpy(), np.asarray(ref.size))
    np.testing.assert_allclose(ours.response.numpy(), np.asarray(ref.response), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref.response)).max())
    np.testing.assert_allclose(ours.angle.numpy(), np.asarray(ref.angle), atol=1e-4)

    bits_ours = np.unpackbits(ours.descriptors.numpy(), axis=-1, bitorder="little")
    bits_ref = np.unpackbits(np.asarray(ref.descriptors), axis=-1, bitorder="little")
    differ = (bits_ours != bits_ref) & mask[..., None]
    if differ.any():
        gaps = _port_samples(frames.astype(np.float32), cfg_t)
        near_bin = _boundary_distance(ours.angle.numpy()) < 1e-3
        explained = near_bin[..., None] | (gaps < 1e-3)
        assert not (differ & ~explained).any(), "descriptor bits differ without a rounding tie"
    assert differ.sum() <= 2


def test_detector_blank_image():
    feats = tdet.detect_and_compute(torch.zeros((1, 128, 160), dtype=torch.uint8), tdet.OrbConfig(max_features=200))
    assert int(feats.mask.sum()) == 0
    assert feats.descriptors.shape == (1, 200, 32) and feats.descriptors.dtype == torch.uint8

