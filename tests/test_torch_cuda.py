"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `cuda`: each test skips on a host without a CUDA device
(the decision is made inside the fixture, never at import). On the GPU:
`python -m pytest -m cuda tests/test_torch_cuda.py`. chip_smoke.py holds
the same kernels at the VO chunk's full shapes."""

import numpy as np
import pytest
import torch

from slamtpu_torch.ops.brief import PATCH_RADIUS
from slamtpu_torch.ops.corner import corner_response, corner_response_plain
from slamtpu_torch.ops.patch import extract_patches_batched, extract_patches_plain

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


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        corner_response(torch.zeros((1, 64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        extract_patches_batched(torch.zeros((1, 20, 20), device=cuda),
                                torch.zeros((1, 1, 2), dtype=torch.int32, device=cuda), PATCH_RADIUS)
