"""SO(3)/SE(3) operations on tensors (counterpart of slamtpu/ops/lie.py).

Batched over leading dimensions, branch-free (the small-angle limits use
`torch.where`), and dtype-preserving.
"""

from __future__ import annotations

import math

import torch

__all__ = ["hat", "so3_exp", "so3_log", "rotation_angle", "se3_matrix", "se3_inverse", "rt_from_matrix"]

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]x of a 3-vector [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: angle-axis [..., 3] -> rotation [..., 3, 3], with
    the identity short-circuit below 1e-8 expressed branch-free."""
    theta = torch.sqrt(torch.sum(omega * omega, dim=-1))
    small = theta < _EPS
    one = torch.ones_like(theta)
    safe_theta = torch.where(small, one, theta)
    a = torch.where(small, one, torch.sin(safe_theta) / safe_theta)
    b = torch.where(
        small, torch.full_like(theta, 0.5), (1.0 - torch.cos(safe_theta)) / (safe_theta * safe_theta)
    )
    w_hat = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a[..., None, None] * w_hat + b[..., None, None] * (w_hat @ w_hat)


def so3_log(rotation: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> angle-axis [..., 3] (inverse of `so3_exp`);
    near pi the axis comes from the diagonal."""
    trace = rotation.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_angle = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos_angle)
    vee = torch.stack(
        [
            rotation[..., 2, 1] - rotation[..., 1, 2],
            rotation[..., 0, 2] - rotation[..., 2, 0],
            rotation[..., 1, 0] - rotation[..., 0, 1],
        ],
        dim=-1,
    )
    small = angle < _EPS
    near_pi = math.pi - angle < 1e-4
    safe_sin = torch.where(small | near_pi, torch.ones_like(angle), torch.sin(angle))
    generic = vee * (angle / (2.0 * safe_sin))[..., None]

    diag = rotation.diagonal(dim1=-2, dim2=-1)
    axis_abs = torch.sqrt(
        torch.clamp((diag - cos_angle[..., None]) / (1.0 - cos_angle[..., None] + 1e-12), min=0.0)
    )
    signs = torch.sign(vee)
    signs = torch.where(signs == 0.0, torch.ones_like(signs), signs)
    pi_branch = axis_abs * signs * angle[..., None]

    out = torch.where(small[..., None], 0.5 * vee, generic)
    return torch.where(near_pi[..., None], pi_branch, out)


def rotation_angle(rotation: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians from trace(R) = 1 + 2 cos(theta), clamped."""
    trace = rotation.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def se3_matrix(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous transforms from (R [..., 3, 3], t [..., 3])."""
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(rotation: torch.Tensor, translation: torch.Tensor):
    """(R, t) -> (R^T, -R^T t): a world->camera pose as camera->world."""
    r_inv = rotation.transpose(-1, -2)
    return r_inv, -(r_inv @ translation[..., None])[..., 0]


def rt_from_matrix(transform: torch.Tensor):
    """Split 4x4 homogeneous transforms [..., 4, 4] into (R, t)."""
    return transform[..., :3, :3], transform[..., :3, 3]
