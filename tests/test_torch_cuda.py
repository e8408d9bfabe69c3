"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `cuda`: each test skips on a host without a CUDA device
(the decision is made inside the fixture, never at import). On the GPU:
`python -m pytest -m cuda tests/test_torch_cuda.py`. chip_smoke.py holds
the same kernels at the VO chunk's full shapes."""

import numpy as np
import pytest
import torch

from slamtpu_torch.ops.brief import PATCH_RADIUS
from slamtpu_torch.ops.corner import (
    corner_response,
    corner_response_levels,
    corner_response_levels_plain,
    corner_response_plain,
)
from slamtpu_torch.ops.patch import (
    extract_patches_batched,
    extract_patches_levels,
    extract_patches_levels_plain,
    extract_patches_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(seed, b=3, h=97, w=203):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    # Smooth then add blobs so there are corners of every strength.
    img = torch.nn.functional.avg_pool2d(torch.from_numpy(img)[:, None], 5, 1, 2)[:, 0]
    return img + torch.from_numpy(rng.uniform(0, 60, (b, h, w)).astype(np.float32))


def test_corner_kernel_matches_plain(cuda):
    imgs = _images(0).to(cuda)
    before = corner_response.launches
    rk, hk = corner_response(imgs, 20.0, with_harris=True)
    rp, hp = corner_response_plain(imgs, 20.0, with_harris=True)
    assert corner_response.launches == before + 1
    m = 10
    np.testing.assert_array_equal(torch.isfinite(rk[:, m:-m, m:-m]).cpu().numpy(),
                                  torch.isfinite(rp[:, m:-m, m:-m]).cpu().numpy())
    assert int(torch.isfinite(rk).sum()) > 100
    torch.testing.assert_close(hk[:, m:-m, m:-m], hp[:, m:-m, m:-m], rtol=1e-4, atol=0)
    torch.testing.assert_close(corner_response(imgs, 20.0), rk, rtol=0, atol=0)
    assert not torch.isfinite(corner_response(torch.zeros((1, 64, 128), device=cuda))).any()


def test_patch_kernel_matches_plain(cuda):
    imgs = _images(1, b=2, h=90, w=260).to(cuda)
    rng = np.random.default_rng(2)
    starts = np.stack([rng.integers(-30, 260, (2, 33)), rng.integers(-30, 90, (2, 33))], -1).astype(np.int32)
    starts = torch.from_numpy(starts).to(cuda)
    before = extract_patches_batched.launches
    out = extract_patches_batched(imgs, starts, PATCH_RADIUS)
    assert extract_patches_batched.launches == before + 1
    torch.testing.assert_close(out, extract_patches_plain(imgs, starts, PATCH_RADIUS), rtol=0, atol=0)


def test_corner_levels_kernel_matches_plain(cuda):
    """One launch over levels of odd widths, a tiny last level and a flat
    one: corner sets identical everywhere, Harris bit-identical at least
    4 px from the border (the kernel clamps its halo where the plain
    version wraps)."""
    levels = [_images(3, 2, 97, 203), _images(4, 2, 40, 59), _images(5, 2, 33, 131),
              torch.zeros((2, 64, 70)), _images(6, 2, 5, 9)]
    levels = [x.to(cuda).contiguous() for x in levels]
    flags = [True, False, True, False, True]
    before = corner_response.launches
    ranked, harris = corner_response_levels(levels, 20.0, flags)
    assert corner_response.launches == before + 1
    ref_ranked, ref_harris = corner_response_levels_plain(levels, 20.0, flags)
    m = 4
    for lv, (rk, rp, hk, hp) in enumerate(zip(ranked, ref_ranked, harris, ref_harris)):
        assert torch.equal(torch.isfinite(rk), torch.isfinite(rp)), lv
        assert (hk is None) == (hp is None)
        if rk.shape[1] > 2 * m and rk.shape[2] > 2 * m:
            assert torch.equal(rk[:, m:-m, m:-m], rp[:, m:-m, m:-m]), lv
            if hk is not None:
                assert torch.equal(hk[:, m:-m, m:-m], hp[:, m:-m, m:-m]), lv
        # The per-level entry point launches the same kernel on one level.
        single = corner_response(levels[lv], 20.0, with_harris=flags[lv])
        assert torch.equal(single[0] if flags[lv] else single, rk), lv
    assert int(torch.isfinite(ranked[0]).sum()) > 100
    assert not torch.isfinite(ranked[3]).any() and not torch.isfinite(ranked[4]).any()


def test_patch_levels_kernel_matches_plain(cuda):
    """One launch over levels with K_l not a multiple of 4, a level without
    an image (zero windows), and starts on and beyond every border."""
    levels = [_images(7, 3, 90, 261), None, _images(8, 3, 45, 77), _images(9, 3, 39, 39)]
    levels = [None if x is None else x.to(cuda).contiguous() for x in levels]
    rng = np.random.default_rng(10)
    starts = []
    for img, k in zip(levels, (13, 3, 6, 5)):
        h, w = (50, 50) if img is None else img.shape[1:]
        s = np.stack([rng.integers(-40, w + 5, (3, k)), rng.integers(-40, h + 5, (3, k))], -1)
        s[:, 0], s[:, 1], s[:, 2] = (0, 0), (w - 39, h - 39), (-7, h)
        s[:, -1] = (w, -3)
        starts.append(torch.from_numpy(s.astype(np.int32)).to(cuda))
    before = extract_patches_batched.launches
    out = extract_patches_levels(levels, starts, PATCH_RADIUS)
    assert extract_patches_batched.launches == before + 1
    assert out.shape == (3, 27, 39, 39)
    assert torch.equal(out, extract_patches_levels_plain(levels, starts, PATCH_RADIUS))
    assert torch.equal(out[:, 13:16], torch.zeros_like(out[:, 13:16]))
    small = extract_patches_levels(levels[2:], starts[2:], 3)
    assert torch.equal(small, extract_patches_levels_plain(levels[2:], starts[2:], 3))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        corner_response(torch.zeros((1, 64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        extract_patches_batched(torch.zeros((1, 20, 20), device=cuda),
                                torch.zeros((1, 1, 2), dtype=torch.int32, device=cuda), PATCH_RADIUS)
