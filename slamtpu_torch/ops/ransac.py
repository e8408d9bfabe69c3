"""Fixed-iteration batched RANSAC for the essential matrix (counterpart of
slamtpu/ops/ransac.py).

All hypotheses of all frame pairs run as one batch. Sampling without
replacement per hypothesis is the top-k-of-uniforms trick: u ~ U[0,1)^N per
hypothesis, masked rows pushed to -inf, the top `sample_size` indices kept.
The uniforms are an input: the JAX package draws them with
`jax.random.uniform(key, (iters, N))`, and the parity tests hand the same
numbers to both; otherwise they come from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .epipolar import enforce_rank2, eight_point, sampson_error, sampson_parts
from .five_point import _topk_first, five_point_candidates
from .lie import hat, so3_exp

__all__ = ["RansacConfig", "RansacResult", "ransac_essential", "pair_uniforms"]


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """The JAX package's RansacConfig, same defaults. Options this slice
    does not port raise NotImplementedError when used: refit_method="irls",
    prescore_subset > 0 and homography_fallback (whose tuning fields come
    with its port)."""

    iters: int = 1000
    threshold: float = 1.0
    confidence: float = 0.999  # recorded for API parity; iteration count is fixed
    sample_size: int = 8
    refine_rounds: int = 3
    refit_method: str = "gn"  # "gn" (on-manifold Gauss-Newton) or "none"
    solver: str = "chol"  # smallest-eigvec method of the 8-point solver
    min_solver: str = "8pt"  # "8pt" or "5pt" (Nistér)
    prescore_subset: int = 0
    homography_fallback: bool = False
    octave_sigma: bool = True


class RansacResult(NamedTuple):
    essential: torch.Tensor  # [..., 3, 3]
    inliers: torch.Tensor  # [..., N] bool
    num_inliers: torch.Tensor  # [...] int32
    best_iter_inliers: torch.Tensor  # [...] int32 — winner's count before refit


def pair_uniforms(seed: int, pair_ids, iters: int, n: int, device) -> torch.Tensor:
    """[len(pair_ids), iters, n] f32 uniforms on `device`, one CPU
    torch.Generator per pair seeded from (seed, pair index): a pair draws
    the same numbers however a clip is cut into chunks, and on every device
    (CUDA's generator is Philox, the CPU's Mersenne Twister, so the draws
    are made on the CPU and copied). For a CUDA device the block is pinned
    and copied without blocking; a 32-step chunk at 64 x 500 is 4 MB."""
    dev = torch.device(device)
    out = torch.empty((len(pair_ids), iters, n), dtype=torch.float32, pin_memory=dev.type == "cuda")
    for row, pid in zip(out, pair_ids):
        gen = torch.Generator()
        gen.manual_seed(int(np.random.SeedSequence([seed, int(pid)]).generate_state(1, np.uint64)[0]))
        torch.rand((iters, n), generator=gen, out=row)
    return out.to(dev, non_blocking=True)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, D], idx [..., *J] (J extra dims) -> [..., *J, D]."""
    batch = x.shape[:-2]
    extra = idx.shape[len(batch):]
    flat = idx.reshape(*batch, -1)
    out = torch.gather(x, -2, flat[..., None].expand(*flat.shape, x.shape[-1]))
    return out.reshape(*batch, *extra, x.shape[-1])


def _gn_step(e, pts1, pts2, w):
    """One damped Gauss-Newton step on the weighted Sampson residual over
    the chart E(d) = exp(hat d[:3]) E exp(hat d[3:])^T at d = 0.

    The Jacobian is analytic: dE/dd_k = G_k E (left, k < 3) and -E G_k
    (right), with G_k = hat(e_k) — what jacfwd of the JAX residual
    evaluates — pushed through the Sampson numerator and the rsqrt of the
    denominator.
    """
    gens = hat(torch.eye(3, dtype=e.dtype, device=e.device))  # [3, 3, 3]: hat(e_k)
    e_ = e[..., None, :, :]
    de = torch.cat([gens @ e_, -(e_ @ gens)], dim=-3)  # [..., 6, 3, 3]

    num, denom = sampson_parts(e, pts1, pts2)  # [..., N]
    safe = torch.clamp(denom, min=1e-18)
    s = torch.rsqrt(safe)
    r0 = w * num * s

    u1, v1 = pts1[..., None, :, 0], pts1[..., None, :, 1]
    u2, v2 = pts2[..., None, :, 0], pts2[..., None, :, 1]
    ee = [[e[..., i, j][..., None, None] for j in range(3)] for i in range(3)]
    dd = [[de[..., i, j][..., None] for j in range(3)] for i in range(3)]
    ex1 = [ee[i][0] * u1 + ee[i][1] * v1 + ee[i][2] for i in range(2)]
    etx2 = [ee[0][j] * u2 + ee[1][j] * v2 + ee[2][j] for j in range(2)]
    dex1 = [dd[i][0] * u1 + dd[i][1] * v1 + dd[i][2] for i in range(3)]
    detx2 = [dd[0][j] * u2 + dd[1][j] * v2 + dd[2][j] for j in range(2)]
    dnum = u2 * dex1[0] + v2 * dex1[1] + dex1[2]  # [..., 6, N]
    ddenom = 2.0 * (ex1[0] * dex1[0] + ex1[1] * dex1[1] + etx2[0] * detx2[0] + etx2[1] * detx2[1])
    live = (denom > 1e-18).to(e.dtype)[..., None, :]
    jac_t = w[..., None, :] * (
        dnum * s[..., None, :] - 0.5 * (num * s * s * s)[..., None, :] * ddenom * live
    )  # [..., 6, N]

    jtj = jac_t @ jac_t.transpose(-1, -2)
    eye = torch.eye(6, dtype=e.dtype, device=e.device)
    damp = 1e-6 * (jtj.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0) + 1e-12
    delta, info = torch.linalg.solve_ex(jtj + damp[..., None, None] * eye, -(jac_t @ r0[..., None]))
    delta = delta[..., 0]
    ok = torch.isfinite(delta).all(dim=-1) & (info == 0)
    delta = torch.where(ok[..., None], delta, torch.zeros_like(delta))
    return so3_exp(delta[..., :3]) @ e @ so3_exp(delta[..., 3:]).transpose(-1, -2)


def ransac_essential(pts1, pts2, mask=None, threshold_norm=1.0 / 700.0, config=RansacConfig(),
                     sigma=None, uniforms=None, generator=None) -> RansacResult:
    """RANSAC essential-matrix fit on normalized correspondences.

    pts1, pts2: [..., N, 2]; mask [..., N] bool; threshold_norm: inlier
    threshold in normalized units (threshold_px / fx), float or tensor;
    sigma: optional [..., N] per-correspondence noise scale (per-point
    inlier band thresh * sigma, and Efraimidis-Spirakis weighted sampling);
    uniforms: optional [..., iters, N] f32 draws in [0, 1); otherwise drawn
    with `generator`. The winner is polished `refine_rounds` times by
    on-manifold Gauss-Newton ("gn") or kept as is ("none").
    """
    if config.refit_method not in ("gn", "none"):
        raise NotImplementedError(f"refit_method={config.refit_method!r} is not ported yet")
    if config.prescore_subset > 0:
        raise NotImplementedError("prescore_subset is not ported yet")
    batch, n = pts1.shape[:-2], pts1.shape[-2]
    dtype, device = pts1.dtype, pts1.device
    if mask is None:
        mask = torch.ones(batch + (n,), dtype=torch.bool, device=device)
    mask_f = mask.to(dtype)
    thresh = torch.as_tensor(threshold_norm, dtype=dtype, device=device)
    thresh_sq = thresh * thresh
    inv_sigma = None
    if sigma is not None:
        sigma = sigma.to(dtype)
        thresh_sq = thresh_sq * (sigma * sigma)  # [..., N]
        inv_sigma = 1.0 / torch.clamp(sigma, min=1e-6)
    thresh_row = thresh_sq[..., None, :] if thresh_sq.dim() else thresh_sq

    sample_size = 5 if config.min_solver == "5pt" else config.sample_size
    if uniforms is None:
        uniforms = torch.rand(batch + (config.iters, n), generator=generator, device=device)
    u = uniforms.to(torch.float32)
    if inv_sigma is not None:
        wgt = (inv_sigma * inv_sigma).to(torch.float32)
        u = torch.exp(torch.log(torch.clamp(u, min=1e-30)) / wgt[..., None, :])
    u = torch.where(mask[..., None, :], u, torch.full_like(u, float("-inf")))
    sample_idx = _topk_first(u, sample_size)  # [..., iters, S]
    s1 = _gather_rows(pts1, sample_idx)
    s2 = _gather_rows(pts2, sample_idx)

    p1, p2 = pts1[..., None, :, :], pts2[..., None, :, :]
    if config.min_solver == "5pt":
        cands, cand_valid = five_point_candidates(s1, s2)  # [..., iters, R, 3, 3]
        hyps = cands.reshape(*batch, -1, 3, 3)
        hyp_valid = cand_valid.reshape(*batch, -1)
        inlier_mat = (sampson_error(hyps, p1, p2) < thresh_row) & mask[..., None, :]
        counts = torch.sum(inlier_mat, dim=-1, dtype=torch.int32)
        counts = torch.where(hyp_valid, counts, torch.full_like(counts, -1))
    else:
        hyps = eight_point(s1, s2, method=config.solver)
        inlier_mat = (sampson_error(hyps, p1, p2) < thresh_row) & mask[..., None, :]
        counts = torch.sum(inlier_mat, dim=-1, dtype=torch.int32)

    best = torch.argmax(counts, dim=-1)  # first maximum, like jnp.argmax
    best_count = torch.gather(counts, -1, best[..., None])[..., 0]
    best_e = torch.gather(hyps, -3, best[..., None, None, None].expand(*batch, 1, 3, 3))[..., 0, :, :]

    def inliers_of(e):
        return (sampson_error(e, pts1, pts2) < thresh_sq) & mask

    e = enforce_rank2(best_e)
    inl = inliers_of(e)
    rounds = 0 if config.refit_method == "none" else config.refine_rounds
    for _ in range(rounds):
        w = inl.to(dtype) * mask_f
        if inv_sigma is not None:
            w = w * inv_sigma
        e_new = _gn_step(e, pts1, pts2, w)
        inl_new = inliers_of(e_new)
        better = torch.sum(inl_new, dim=-1) >= torch.sum(inl, dim=-1)
        e = torch.where(better[..., None, None], e_new, e)
        inl = torch.where(better[..., None], inl_new, inl)

    return RansacResult(
        essential=e,
        inliers=inl,
        num_inliers=torch.sum(inl, dim=-1, dtype=torch.int32),
        best_iter_inliers=best_count,
    )
