"""Fixed-iteration batched RANSAC for the essential matrix (counterpart of
slamtpu/ops/ransac.py).

All hypotheses of all frame pairs run as one batch. Sampling without
replacement per hypothesis is the top-k-of-uniforms trick: u ~ U[0,1)^N per
hypothesis, masked rows pushed to -inf, the top `sample_size` indices kept.
The uniforms are an input (`PairDraws`): the JAX package draws them with
`jax.random.uniform` from each pair's key, and the parity tests hand the
same numbers to both; otherwise they come from a seeded CPU
`torch.Generator` per pair and stream (`pair_draws`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import graphs
from ..utils.metrics import span
from .epipolar import enforce_rank2, eight_point, sampson_error, sampson_parts
from .five_point import _topk_first, five_point_candidates
from .lie import hat, so3_exp

__all__ = ["RansacConfig", "RansacResult", "PairDraws", "ransac_essential", "pair_uniforms", "pair_draws",
           "as_draws"]

# Draw streams of one pair. The essential stream's seed is (seed, pair), as
# it always was; every other stream appends its id.
ESSENTIAL, HOMOGRAPHY, PRESCORE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """The JAX package's RansacConfig, same defaults."""

    iters: int = 1000
    threshold: float = 1.0
    confidence: float = 0.999  # recorded for API parity; iteration count is fixed
    sample_size: int = 8
    refine_rounds: int = 3
    refit_method: str = "gn"  # "gn" (on-manifold Gauss-Newton), "irls" (weighted 8-point) or "none"
    solver: str = "chol"  # smallest-eigvec method of the 8-point solver
    min_solver: str = "8pt"  # "8pt" or "5pt" (Nistér)
    # 5pt only: score every root slot on this many live correspondences
    # first and keep each hypothesis's best slot (0: off).
    prescore_subset: int = 0
    # Also fit a homography and take its pose when S_H / (S_H + S_E)
    # exceeds homography_ratio (odometry/pose.py).
    homography_fallback: bool = False
    homography_ratio: float = 0.45
    homography_iters: int = 256
    octave_sigma: bool = True


class RansacResult(NamedTuple):
    essential: torch.Tensor  # [..., 3, 3]
    inliers: torch.Tensor  # [..., N] bool
    num_inliers: torch.Tensor  # [...] int32
    best_iter_inliers: torch.Tensor  # [...] int32 — winner's count before refit


class PairDraws(NamedTuple):
    """The uniforms of a batch of pairs, one field per stream."""

    essential: torch.Tensor | None = None  # [..., iters, N]: hypothesis samples
    homography: torch.Tensor | None = None  # [..., homography_iters, N]: homography samples
    prescore: torch.Tensor | None = None  # [..., N]: the prescore subset


def as_draws(uniforms) -> PairDraws:
    """A PairDraws from None, a bare essential-stream tensor or a PairDraws."""
    if uniforms is None:
        return PairDraws()
    if isinstance(uniforms, PairDraws):
        return uniforms
    return PairDraws(essential=uniforms)


def pair_uniforms(seed: int, pair_ids, iters: int, n: int, device, stream: int = ESSENTIAL) -> torch.Tensor:
    """[len(pair_ids), iters, n] f32 uniforms on `device`, one CPU
    torch.Generator per pair seeded from (seed, pair index), with the
    stream id appended for streams other than the essential one: a pair
    draws the same numbers however a clip is cut into chunks, and on every
    device (CUDA's generator is Philox, the CPU's Mersenne Twister, so the
    draws are made on the CPU and copied). For a CUDA device the block is
    pinned and copied without blocking; a 32-step chunk at 64 x 500 is 4 MB."""
    dev = torch.device(device)
    out = torch.empty((len(pair_ids), iters, n), dtype=torch.float32, pin_memory=dev.type == "cuda")
    for row, pid in zip(out, pair_ids):
        words = [seed, int(pid)] + ([stream] if stream != ESSENTIAL else [])
        gen = torch.Generator()
        gen.manual_seed(int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]))
        torch.rand((iters, n), generator=gen, out=row)
    return out.to(dev, non_blocking=True)


def pair_draws(seed: int, pair_ids, config: RansacConfig, n: int, device,
               given: PairDraws = PairDraws()) -> PairDraws:
    """Every stream `config` reads for each pair of `pair_ids`: the streams
    in `given` as they are (moved to `device`), the others drawn."""
    pair_ids = list(pair_ids)
    want = dict(essential=(config.iters, ESSENTIAL),
                homography=(config.homography_iters, HOMOGRAPHY) if config.homography_fallback else None,
                prescore=(1, PRESCORE) if config.min_solver == "5pt" and config.prescore_subset > 0 else None)
    out = {}
    for name, have in given._asdict().items():
        if have is not None:
            out[name] = torch.as_tensor(have).to(device)
        elif want[name] is not None:
            iters, stream = want[name]
            drawn = pair_uniforms(seed, pair_ids, iters, n, device, stream)
            out[name] = drawn[:, 0] if name == "prescore" else drawn
    return PairDraws(**out)


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

    if e.device.type == "cuda":
        # Products summed over the rows: cuBLAS picks a batched GEMM's kernel
        # (and so its rounding) by the batch size, a reduction's order
        # depends only on its length, and run_vo_batched must give each
        # sequence what run_vo gives it. The CPU's batched GEMM computes each
        # matrix alone, so it keeps the reference's matmuls.
        jtj = torch.sum(jac_t[..., :, None, :] * jac_t[..., None, :, :], dim=-1)
        jtr = torch.sum(jac_t * r0[..., None, :], dim=-1)[..., None]
    else:
        jtj = jac_t @ jac_t.transpose(-1, -2)
        jtr = jac_t @ r0[..., None]
    eye = torch.eye(6, dtype=e.dtype, device=e.device)
    damp = 1e-6 * (jtj.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0) + 1e-12
    delta, info = torch.linalg.solve_ex(jtj + damp[..., None, None] * eye, -jtr)
    delta = delta[..., 0]
    ok = torch.isfinite(delta).all(dim=-1) & (info == 0)
    delta = torch.where(ok[..., None], delta, torch.zeros_like(delta))
    return so3_exp(delta[..., :3]) @ e @ so3_exp(delta[..., 3:]).transpose(-1, -2)


def _hypotheses(pts1, pts2, mask, thresh_sq, inv_sigma, u_essential, u_prescore, config: RansacConfig,
                generator=None):
    """The `pose.hypotheses` region: (hypotheses [..., H, 3, 3], their
    validity [..., H], None from the 8-point solver)."""
    batch, n = pts1.shape[:-2], pts1.shape[-2]
    device = pts1.device
    sample_size = 5 if config.min_solver == "5pt" else config.sample_size
    uniforms = u_essential
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

    if config.min_solver != "5pt":
        return eight_point(s1, s2, method=config.solver), None
    cands, cand_valid = five_point_candidates(s1, s2)  # [..., iters, R, 3, 3]
    n_sub = config.prescore_subset
    if not 0 < n_sub < n:
        return cands.reshape(*batch, -1, 3, 3), cand_valid.reshape(*batch, -1)
    # Stage 1: every root slot on a subset of the live rows; each hypothesis
    # keeps its best slot.
    u_sub = u_prescore
    if u_sub is None:
        u_sub = torch.rand(batch + (n,), generator=generator, device=device)
    u_sub = u_sub.to(torch.float32)
    u_sub = torch.where(mask, u_sub, torch.full_like(u_sub, float("-inf")))
    sub_idx = _topk_first(u_sub, n_sub)  # [..., M]
    sub1, sub2 = _gather_rows(pts1, sub_idx), _gather_rows(pts2, sub_idx)
    sub_thresh = torch.gather(thresh_sq, -1, sub_idx)[..., None, None, :] if thresh_sq.dim() else thresh_sq
    sub_mask = torch.gather(mask, -1, sub_idx)[..., None, None, :]
    sub_err = sampson_error(cands, sub1[..., None, None, :, :], sub2[..., None, None, :, :])
    sub_counts = torch.sum((sub_err < sub_thresh) & sub_mask, dim=-1, dtype=torch.int32)
    sub_counts = torch.where(cand_valid, sub_counts, torch.full_like(sub_counts, -1))
    best_slot = torch.argmax(sub_counts, dim=-1)  # [..., iters]
    hyps = torch.gather(cands, -3, best_slot[..., None, None, None].expand(*best_slot.shape, 1, 3, 3))[..., 0, :, :]
    return hyps, torch.gather(cand_valid, -1, best_slot[..., None])[..., 0]


def _score(hyps, hyp_valid, pts1, pts2, mask, thresh_sq):
    """The `pose.score` region: (the winning hypothesis [..., 3, 3], its
    inlier count [...] int32)."""
    batch = pts1.shape[:-2]
    thresh_row = thresh_sq[..., None, :] if thresh_sq.dim() else thresh_sq
    p1, p2 = pts1[..., None, :, :], pts2[..., None, :, :]
    inlier_mat = (sampson_error(hyps, p1, p2) < thresh_row) & mask[..., None, :]
    counts = torch.sum(inlier_mat, dim=-1, dtype=torch.int32)
    if hyp_valid is not None:
        counts = torch.where(hyp_valid, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts, dim=-1)  # first maximum, like jnp.argmax
    best_count = torch.gather(counts, -1, best[..., None])[..., 0]
    best_e = torch.gather(hyps, -3, best[..., None, None, None].expand(*batch, 1, 3, 3))[..., 0, :, :]
    return best_e, best_count


def _polish(best_e, pts1, pts2, mask, thresh_sq, inv_sigma, config: RansacConfig):
    """The `pose.polish` region: (E [..., 3, 3], inliers [..., N], their
    count [...] int32) after the refit rounds."""
    batch, dtype, device = pts1.shape[:-2], pts1.dtype, pts1.device
    mask_f = mask.to(dtype)

    def inliers_of(e):
        return (sampson_error(e, pts1, pts2) < thresh_sq) & mask

    e = enforce_rank2(best_e)
    inl = inliers_of(e)
    rounds = 0 if config.refit_method == "none" else config.refine_rounds
    for _ in range(rounds):
        w = inl.to(dtype) * mask_f
        if inv_sigma is not None:
            w = w * inv_sigma
        if config.refit_method == "gn":
            e_new = _gn_step(e, pts1, pts2, w)
            better = torch.ones(batch, dtype=torch.bool, device=device)
        else:
            # Rows weighted by the Sampson rsqrt(denominator); an 8-point
            # refit needs >= sample_size inliers, else the model is kept.
            w = w * torch.rsqrt(torch.clamp(sampson_parts(e, pts1, pts2)[1], min=1e-18))
            e_new = enforce_rank2(eight_point(pts1, pts2, weights=w, method=config.solver))
            better = torch.sum(inl, dim=-1) >= config.sample_size
        inl_new = inliers_of(e_new)
        better = better & (torch.sum(inl_new, dim=-1) >= torch.sum(inl, dim=-1))
        e = torch.where(better[..., None, None], e_new, e)
        inl = torch.where(better[..., None], inl_new, inl)
    return e, inl, torch.sum(inl, dim=-1, dtype=torch.int32)


def ransac_essential(pts1, pts2, mask=None, threshold_norm=1.0 / 700.0, config=RansacConfig(),
                     sigma=None, uniforms=None, generator=None) -> RansacResult:
    """RANSAC essential-matrix fit on normalized correspondences.

    pts1, pts2: [..., N, 2]; mask [..., N] bool; threshold_norm: inlier
    threshold in normalized units (threshold_px / fx), float or tensor;
    sigma: optional [..., N] per-correspondence noise scale (per-point
    inlier band thresh * sigma, Efraimidis-Spirakis weighted sampling, and
    1/sigma row weights in the refit); uniforms: the essential stream
    [..., iters, N] of f32 draws in [0, 1), or a `PairDraws` (whose
    `prescore` [..., N] picks the prescore subset); a stream not given is
    drawn with `generator`. The winner is refined `refine_rounds` times by
    on-manifold Gauss-Newton ("gn"), by the Sampson-weighted 8-point refit
    ("irls"), or kept as is ("none"); a round is kept only when it loses no
    inlier.
    """
    if config.refit_method not in ("gn", "irls", "none"):
        raise ValueError(f"unknown refit_method {config.refit_method!r}")
    draws = as_draws(uniforms)
    batch, n = pts1.shape[:-2], pts1.shape[-2]
    dtype, device = pts1.dtype, pts1.device
    if mask is None:
        mask = torch.ones(batch + (n,), dtype=torch.bool, device=device)
    if torch.is_tensor(threshold_norm):
        thresh = threshold_norm.to(dtype=dtype, device=device)
    else:
        thresh = torch.full((), threshold_norm, dtype=dtype, device=device)
    thresh_sq = thresh * thresh
    inv_sigma = None
    if sigma is not None:
        sigma = sigma.to(dtype)
        thresh_sq = thresh_sq * (sigma * sigma)  # [..., N]
        inv_sigma = 1.0 / torch.clamp(sigma, min=1e-6)

    # Each region below is a CUDA graph once its shapes recur
    # (utils/graphs.py), unless it draws from `generator`.
    prescore = config.min_solver == "5pt" and 0 < config.prescore_subset < n
    with span("pose.hypotheses"):
        hyps, hyp_valid = graphs.run(
            "pose.hypotheses", functools.partial(_hypotheses, config=config, generator=generator),
            (pts1, pts2, mask, thresh_sq if prescore else None, inv_sigma, draws.essential,
             draws.prescore if prescore else None),
            static=config, eager=draws.essential is None or (prescore and draws.prescore is None))
    with span("pose.score"):
        best_e, best_count = graphs.run("pose.score", _score, (hyps, hyp_valid, pts1, pts2, mask, thresh_sq))
    with span("pose.polish"):
        e, inl, num_inliers = graphs.run("pose.polish", functools.partial(_polish, config=config),
                                         (best_e, pts1, pts2, mask, thresh_sq, inv_sigma), static=config)
        return RansacResult(essential=e, inliers=inl, num_inliers=num_inliers, best_iter_inliers=best_count)
