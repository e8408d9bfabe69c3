"""The five-point null space (`ops/five_point.py::_nullspace4`) on the CPU:
CPU tensors take the plain version and never build or launch the CUDA
kernel, the plain version is finite and orthonormal on degenerate samples,
and `_nullspace4.launches` does not move. The kernel itself is
held to the library QR on the card in `tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from slamtpu_torch import _build
from slamtpu_torch.ops import five_point
from slamtpu_torch.utils import metrics

DEGENERATE = ("repeated", "collinear", "zeros")


def degenerate_sample(name: str, dtype=torch.float32):
    """One [1, 5, 2] pair of normalized samples: a point repeated, five
    collinear points in both views, or all five at the origin."""
    rng = np.random.default_rng(7)
    p1 = rng.uniform(-0.8, 0.8, (1, 5, 2))
    p2 = p1 + rng.normal(0.0, 0.02, p1.shape)
    if name == "repeated":
        p1[0, 1], p2[0, 1] = p1[0, 0], p2[0, 0]
    elif name == "collinear":
        t = np.linspace(-0.5, 0.5, 5)
        p1 = np.stack([t, 0.3 * t + 0.1], -1)[None]
        p2 = np.stack([0.9 * t + 0.02, -0.2 * t + 0.05], -1)[None]
    elif name == "zeros":
        p1, p2 = np.zeros((1, 5, 2)), np.zeros((1, 5, 2))
    else:
        raise ValueError(name)
    return torch.from_numpy(p1).to(dtype).contiguous(), torch.from_numpy(p2).to(dtype).contiguous()


def design_matrix(p1, p2):
    """[..., 5, 9] f64 rows x2 (x) x1 of homogeneous points."""
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1).double()
    x2 = torch.cat([p2, torch.ones_like(p2[..., :1])], -1).double()
    return (x2[..., :, :, None] * x1[..., :, None, :]).reshape(*x1.shape[:-1], 9)


def gap_bound(p1, p2, atol=1e-5):
    """Per system, how far two Householder QRs of the same A^T may part:
    `atol`, or 4 eps kappa(A) where the conditioning says more (two orders
    of summation part the bases by about eps kappa(A), 1.6 eps kappa at
    most in 8,192 f32 systems against LAPACK)."""
    eps = torch.finfo(p1.dtype).eps
    s = torch.linalg.svdvals(design_matrix(p1.cpu(), p2.cpu()))
    return torch.clamp(4 * eps * s[..., 0] / s[..., -1], min=atol)


def assert_null_basis(basis, p1, p2, tol=1e-5):
    """Finite, orthonormal to `tol`, and ||A basis|| <= tol ||A||."""
    b = basis.reshape(*basis.shape[:-3], 4, 9).double().cpu()
    assert torch.isfinite(b).all()
    gram = b @ b.transpose(-1, -2)
    assert float((gram - torch.eye(4, dtype=torch.float64)).abs().max()) <= tol
    a = design_matrix(p1.cpu(), p2.cpu())
    resid = torch.linalg.matrix_norm(a @ b.transpose(-1, -2))
    assert bool((resid <= tol * torch.linalg.matrix_norm(a)).all())


def test_five_point_on_cpu_tensors_never_builds_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    rng = np.random.default_rng(0)
    p1 = torch.from_numpy(rng.uniform(-0.8, 0.8, (3, 4, 5, 2)).astype(np.float32))
    p2 = p1 + 0.01
    before = five_point._nullspace4.launches
    es, valid = five_point.five_point_candidates(p1, p2)
    assert es.shape == (3, 4, five_point.N_ROOT_SLOTS, 3, 3) and valid.any()
    assert five_point._nullspace4.launches == before
    torch.testing.assert_close(five_point._nullspace4(p1, p2), five_point._nullspace4_plain(p1, p2), rtol=0, atol=0)


@pytest.mark.parametrize("name", DEGENERATE)
def test_nullspace_plain_is_finite_and_orthonormal_on_degenerate_samples(name):
    p1, p2 = degenerate_sample(name)
    assert_null_basis(five_point._nullspace4_plain(p1, p2), p1, p2)


def test_nullspace_kernel_counter_stays_zero_on_the_cpu():
    p1, p2 = degenerate_sample("repeated")
    before = five_point._nullspace4.launches
    with metrics.tracing():
        five_point.five_point_candidates(p1, p2)
    rec = metrics.records()
    assert [s.name for s in rec.spans] == ["pose.nullspace"]
    assert five_point._nullspace4.launches == before


def test_nullspace_refuses_mixed_devices_before_building(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("refused points reached the CUDA build")

    monkeypatch.setattr(_build, "load", refuse)
    p1, p2 = degenerate_sample("repeated")
    with pytest.raises(ValueError):
        five_point._nullspace4(p1, p2.to("meta"))
