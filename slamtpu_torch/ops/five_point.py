"""Nistér 5-point minimal essential-matrix solver, batched and branch-free
(counterpart of slamtpu/ops/five_point.py).

Given 5 normalized correspondences it returns up to N_ROOT_SLOTS (18)
essential-matrix candidates with fixed shapes:
  1. the 4-dimensional null space of the 5x9 design matrix (complete QR;
     on CUDA tensors one launch of the hand-written kernel
     csrc/nullspace4.cu, whose note says why and what bounds it);
  2. the ten cubic constraints over 20 monomials, expanded by polynomial
     arithmetic whose tables are built once from the monomial orders;
  3. Gauss-Jordan elimination (pivoted, branch-free), Nistér's row
     combinations, and the degree-10 polynomial n(z) = det B(z);
  4. real roots by sign changes on a tan-spaced grid + bisection, plus
     Newton seeds for near-double root pairs and their siblings;
  5. (x, y) from the null vector of B(z) and E = x E1 + y E2 + z E3 + E4.

Every sum is taken in the JAX package's order: a polynomial product is one
outer product, then its terms are added column by column in the order the
JAX code appends them (padding with exact zeros).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from ..utils.graphs import device_constant, host_effect
from ..utils.metrics import span
from .epipolar import _homogeneous

__all__ = ["N_ROOT_SLOTS", "five_point_candidates"]

_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_DEG2 = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (1, 0, 0), (0, 2, 0),
    (0, 1, 1), (0, 1, 0), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
# Nistér's column order: the first 10 monomials are eliminated by
# Gauss-Jordan; the last 10 are x*(z^2, z, 1), y*(z^2, z, 1), (z^3..1).
_DEG3 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0),
    (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]

N_ROOT_SLOTS = 18  # 10 sign-change brackets + 4 Newton seeds + 4 siblings
_NULLSPACE_LAUNCHERS = {torch.float32: "launch_nullspace4", torch.float64: "launch_nullspace4_f64"}
_NULLSPACE_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache()
def _term_table(pairs_per_out: tuple) -> tuple:
    """[T][out_len] flat product indices, padded with the index of an
    appended zero column: out[k] = sum over t of P[table[t][k]] in order."""
    n_terms = max(len(p) for p in pairs_per_out)
    pad = -1
    return tuple(
        tuple(p[t] if t < len(p) else pad for p in pairs_per_out) for t in range(n_terms)
    )


@functools.lru_cache()
def _table_indices(table: tuple, zero_col: int, device: torch.device) -> tuple:
    return tuple(
        torch.tensor([zero_col if i < 0 else i for i in row], device=device) for row in table
    )


def _ordered_sum(products: torch.Tensor, table: tuple) -> torch.Tensor:
    """products [..., P] -> [..., out_len] by the term table (see _term_table)."""
    padded = torch.cat([products, torch.zeros_like(products[..., :1])], dim=-1)
    out = None
    for idx in _table_indices(table, products.shape[-1], products.device):
        col = padded.index_select(-1, idx)
        out = col if out is None else out + col
    return out


@functools.lru_cache()
def _poly_table(exps_a: tuple, exps_b: tuple, exps_out: tuple) -> tuple:
    out_idx = {e: i for i, e in enumerate(exps_out)}
    terms = [[] for _ in exps_out]
    for ia, ea in enumerate(exps_a):
        for ib, eb in enumerate(exps_b):
            key = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            terms[out_idx[key]].append(ia * len(exps_b) + ib)
    return _term_table(tuple(tuple(t) for t in terms))


def _poly_mul(a, b, exps_a, exps_b, exps_out):
    """Multiply coefficient vectors a [..., len_a] * b [..., len_b]."""
    products = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], a.shape[-1] * b.shape[-1])
    return _ordered_sum(products, _poly_table(tuple(exps_a), tuple(exps_b), tuple(exps_out)))


def _mul11(a, b):  # deg1 * deg1 -> deg2
    return _poly_mul(a, b, _DEG1, _DEG1, _DEG2)


def _mul21(a, b):  # deg2 * deg1 -> deg3
    return _poly_mul(a, b, _DEG2, _DEG1, _DEG3)


def _constraint_matrix(basis):
    """basis [..., 4, 3, 3] -> the [..., 10, 20] cubic-constraint matrix:
    det(E) = 0 and (E E^T - 1/2 tr(E E^T) I) E = 0 over `_DEG3`."""
    e = [[basis[..., :, i, j] for j in range(3)] for i in range(3)]
    rows = []
    det = None
    for (a, b, c), sign in (
        ((0, 1, 2), 1.0), ((1, 2, 0), 1.0), ((2, 0, 1), 1.0),
        ((0, 2, 1), -1.0), ((1, 0, 2), -1.0), ((2, 1, 0), -1.0),
    ):
        term = _mul21(_mul11(e[0][a], e[1][b]), e[2][c])
        det = term * sign if det is None else det + term * sign
    rows.append(det)

    t = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = _mul11(e[i][0], e[j][0])
            acc = acc + _mul11(e[i][1], e[j][1])
            acc = acc + _mul11(e[i][2], e[j][2])
            t[i][j] = acc
    half_tr = 0.5 * (t[0][0] + t[1][1] + t[2][2])
    for i in range(3):
        t[i][i] = t[i][i] - half_tr
    for i in range(3):
        for j in range(3):
            acc = _mul21(t[i][0], e[0][j])
            acc = acc + _mul21(t[i][1], e[1][j])
            acc = acc + _mul21(t[i][2], e[2][j])
            rows.append(acc)
    return torch.stack(rows, dim=-2)


@functools.lru_cache()
def _conv_table(la: int, lb: int) -> tuple:
    terms = [[] for _ in range(la + lb - 1)]
    for i in range(la):
        for j in range(lb):
            terms[i + j].append(i * lb + j)
    return _term_table(tuple(tuple(t) for t in terms))


def _conv1d(a, b):
    """Coefficient convolution: a [..., la] * b [..., lb] -> [..., la+lb-1]."""
    la, lb = a.shape[-1], b.shape[-1]
    products = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], la * lb)
    return _ordered_sum(products, _conv_table(la, lb))


def _polyval(coeffs, x):
    """Horner evaluation; coeffs [..., L] ascending, x broadcastable."""
    acc = coeffs[..., -1]
    for i in range(coeffs.shape[-1] - 2, -1, -1):
        acc = acc * x + coeffs[..., i]
    return acc


def _sign_eval(coeffs, coeffs_rev, z):
    """Sign-faithful evaluation of an even-degree polynomial on all of R:
    n(z) for |z| <= 1, the reversed polynomial at 1/z otherwise."""
    inner = z.abs() <= 1.0
    one = torch.ones_like(z)
    z_in = torch.where(inner, z, one)
    z_out = torch.where(inner, one, z)
    return torch.where(inner, _polyval(coeffs, z_in), _polyval(coeffs_rev, 1.0 / z_out))


def _linspace(start: float, stop: float, num: int, dtype, device) -> torch.Tensor:
    """jnp.linspace's formula (start (1 - s) + stop s, exact endpoint), so
    the grid is bit-identical to the JAX package's."""
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    start_t = device_constant(start, dtype, device)
    stop_t = device_constant(stop, dtype, device)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])


def _topk_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower index
    (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def _real_roots_deg10(coeffs, n_grid: int = 512, bisect_iters: int = 30, newton_iters: int = 16,
                      n_newton_seeds: int = 4):
    """Real roots of a batched degree-10 polynomial, coeffs [..., 11]
    ascending -> (roots [..., N_ROOT_SLOTS], valid [..., N_ROOT_SLOTS])."""
    dtype, device = coeffs.dtype, coeffs.device
    scale = coeffs.abs().amax(dim=-1, keepdim=True)
    c = coeffs / torch.where(scale > 0, scale, torch.ones_like(scale))
    c_rev = c.flip(-1)
    c_g, c_rev_g = c[..., None, :], c_rev[..., None, :]

    eps = 1e-3
    thetas = _linspace(-math.pi / 2 + eps, math.pi / 2 - eps, n_grid, dtype, device)
    grid_z = torch.tan(thetas)
    vals = _sign_eval(c_g, c_rev_g, grid_z)  # [..., G]

    sign = torch.sign(vals)
    change = (sign[..., :-1] * sign[..., 1:]) < 0
    score = change.to(torch.float32) * 2.0 - torch.arange(
        n_grid - 1, dtype=torch.float32, device=device
    ) / (n_grid - 1)
    cells = torch.topk(score, 10, dim=-1).indices  # scores are distinct
    valid = torch.gather(change, -1, cells)
    lo = thetas[cells]
    hi = thetas[cells + 1]
    f_lo = torch.gather(vals, -1, cells)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        f_mid = _sign_eval(c_g, c_rev_g, torch.tan(mid))
        go_right = torch.sign(f_mid) == torch.sign(f_lo)
        lo, hi, f_lo = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid), torch.where(
            go_right, f_mid, f_lo
        )
    roots = torch.tan(0.5 * (lo + hi))

    av = vals.abs()
    is_min = (av[..., 1:-1] <= av[..., :-2]) & (av[..., 1:-1] <= av[..., 2:])
    no_change = ~(change[..., :-1] | change[..., 1:])
    min_score = torch.where(
        is_min & no_change,
        -torch.log1p(av[..., 1:-1].to(torch.float32)),
        torch.full_like(av[..., 1:-1], float("-inf"), dtype=torch.float32),
    )
    seed_idx = _topk_first(min_score, n_newton_seeds)
    seed_ok = torch.gather(torch.isfinite(min_score) & (min_score > float("-inf")), -1, seed_idx)
    z = grid_z[seed_idx + 1]

    dcoef = c[..., 1:] * torch.arange(1, 11, dtype=dtype, device=device)
    dcoef_g = dcoef[..., None, :]

    def newton(z):
        f = _polyval(c_g, z)
        df = _polyval(dcoef_g, z)
        step = f / torch.where(df.abs() > 1e-30, df, torch.full_like(df, 1e-30))
        return z - torch.clamp(step, -1.0, 1.0)

    z = torch.clamp(z, -1e3, 1e3)
    for _ in range(newton_iters):
        z = newton(z)
    resid = _polyval(c_g, z).abs()
    newton_valid = seed_ok & torch.isfinite(z) & (resid < 1e-4)

    d2coef = dcoef[..., 1:] * torch.arange(1, 10, dtype=dtype, device=device)
    d1 = _polyval(dcoef_g, z)
    d2 = _polyval(d2coef[..., None, :], z)
    d2_safe = torch.where(d2.abs() > 1e-30, d2, torch.full_like(d2, 1e-30))
    sib = torch.clamp(z - 2.0 * d1 / d2_safe, -1e3, 1e3)
    for _ in range(newton_iters):
        sib = newton(sib)
    sib_resid = _polyval(c_g, sib).abs()
    sib_valid = seed_ok & torch.isfinite(sib) & (sib_resid < 1e-4)

    return torch.cat([roots, z, sib], dim=-1), torch.cat([valid, newton_valid, sib_valid], dim=-1)


def _nullspace4_plain(pts1, pts2):
    """[..., 5, 2] normalized pairs -> [..., 4, 3, 3] orthonormal basis of
    the design matrix's null space: the last 4 columns of the complete QR
    factor of A^T (any orthonormal kernel basis serves the Nistér form)."""
    x1 = _homogeneous(pts1)
    x2 = _homogeneous(pts2)
    a = (x2[..., :, :, None] * x1[..., :, None, :]).reshape(*x1.shape[:-1], 9)
    q = torch.linalg.qr(a.transpose(-1, -2), mode="complete")[0]
    basis = q[..., :, 5:].transpose(-1, -2)
    return basis.reshape(*basis.shape[:-1], 3, 3)


def _nullspace4(pts1, pts2):
    """`_nullspace4_plain`'s contract; on CUDA tensors (f32 or f64,
    contiguous, one device) one launch of the csrc/nullspace4.cu kernel,
    which repeats the card's library QR operation for operation (in float32
    the same basis to the bit), on CPU tensors the plain version."""
    with span("pose.nullspace"):
        if pts1.device.type == "cpu" and pts2.device.type == "cpu":
            return _nullspace4_plain(pts1, pts2)
        if pts1.device.type != "cuda" or pts2.device != pts1.device:
            raise ValueError(f"_nullspace4: points on {pts1.device} and {pts2.device}")
        if pts1.dtype not in _NULLSPACE_LAUNCHERS or pts2.dtype != pts1.dtype:
            raise ValueError(f"_nullspace4: needs float32 or float64 points, got {pts1.dtype} and {pts2.dtype}")
        if pts1.shape != pts2.shape or pts1.dim() < 2 or tuple(pts1.shape[-2:]) != (5, 2):
            raise ValueError(f"_nullspace4: needs two [..., 5, 2] tensors, got {tuple(pts1.shape)} and "
                             f"{tuple(pts2.shape)}")
        if not (pts1.is_contiguous() and pts2.is_contiguous()):
            raise ValueError("_nullspace4: needs contiguous points")
        basis = torch.empty((*pts1.shape[:-2], 4, 3, 3), dtype=pts1.dtype, device=pts1.device)
        m = basis.numel() // 36
        if m:
            launch = _build.load("nullspace4", _NULLSPACE_LAUNCHERS[pts1.dtype], _NULLSPACE_ARGTYPES)
            with torch.cuda.device(pts1.device):
                err = launch(m, pts1.data_ptr(), pts2.data_ptr(), basis.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"_nullspace4: kernel launch failed with CUDA error {err}")
            host_effect(_count_launch)
        return basis


def _count_launch():
    _nullspace4.launches += 1


_nullspace4.launches = 0


def _solve_pivoted(a, b):
    """Batched a x = b by branch-free Gauss-Jordan with partial pivoting;
    singular systems yield inf/NaN rows for the validity masks to absorb."""
    n = a.shape[-1]
    aug = torch.cat([a, b], dim=-1)
    used = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    neg_inf = device_constant(float("-inf"), a.dtype, a.device)
    for k in range(n):
        col = aug[..., :, k]
        p = torch.argmax(torch.where(used, neg_inf, col.abs()), dim=-1)
        onehot = torch.nn.functional.one_hot(p, n).to(aug.dtype)
        pivot_row = torch.gather(aug, -2, p[..., None, None].expand(*aug.shape[:-2], 1, aug.shape[-1]))[..., 0, :]
        norm_row = pivot_row / pivot_row[..., k : k + 1]
        aug = aug - col[..., :, None] * norm_row[..., None, :]
        aug = aug + onehot[..., :, None] * norm_row[..., None, :]
        used = used | (onehot > 0.5)
    # Leading n columns now hold the row permutation P: x = P^T rhs.
    return aug[..., :, :n].transpose(-1, -2) @ aug[..., :, n:]


def _z_shift(p):
    """Multiply an ascending-coefficient z-polynomial by z."""
    return torch.cat([torch.zeros_like(p[..., :1]), p], dim=-1)


def _row_tail(r, row):
    """Reduced row `row` -> (x-poly [3], y-poly [3], 1-poly [4]), ascending z."""
    px = torch.stack([r[..., row, 2], r[..., row, 1], r[..., row, 0]], dim=-1)
    py = torch.stack([r[..., row, 5], r[..., row, 4], r[..., row, 3]], dim=-1)
    p1 = torch.stack([r[..., row, 9], r[..., row, 8], r[..., row, 7], r[..., row, 6]], dim=-1)
    return px, py, p1


def five_point_candidates(pts1, pts2):
    """Essential-matrix candidates from exactly 5 correspondences.

    pts1, pts2: [..., 5, 2] K-normalized points. Returns (essentials
    [..., N_ROOT_SLOTS, 3, 3] unit-Frobenius, valid [..., N_ROOT_SLOTS]);
    invalid slots hold unspecified matrices.
    """
    basis = _nullspace4(pts1, pts2)
    m = _constraint_matrix(basis)
    r = _solve_pivoted(m[..., :, :10], m[..., :, 10:])

    def combo(row_top, row_bot):
        """<top> - z<bot>: rows with leading monomials (M z, M)."""
        tx, ty, t1 = _row_tail(r, row_top)
        bx, by, b1 = _row_tail(r, row_bot)
        pad = lambda p: torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)  # noqa: E731
        return pad(tx) - _z_shift(bx), pad(ty) - _z_shift(by), pad(t1) - _z_shift(b1)

    kx, ky, k1 = combo(4, 5)
    lx, ly, l1 = combo(6, 7)
    mx, my, m1 = combo(8, 9)

    n = (
        _conv1d(kx, _conv1d(ly, m1) - _conv1d(l1, my))
        - _conv1d(ky, _conv1d(lx, m1) - _conv1d(l1, mx))
        + _conv1d(k1, _conv1d(lx, my) - _conv1d(ly, mx))
    )
    z, valid = _real_roots_deg10(n)

    def rows(px, py, p1):
        return torch.stack(
            [_polyval(px[..., None, :], z), _polyval(py[..., None, :], z), _polyval(p1[..., None, :], z)],
            dim=-1,
        )

    rk, rl, rm = rows(kx, ky, k1), rows(lx, ly, l1), rows(mx, my, m1)
    cross = functools.partial(torch.linalg.cross, dim=-1)
    crosses = torch.stack([cross(rk, rl), cross(rk, rm), cross(rl, rm)], dim=-2)
    pick = torch.argmax(torch.linalg.vector_norm(crosses, dim=-1), dim=-1)
    v = torch.gather(crosses, -2, pick[..., None, None].expand(*crosses.shape[:-2], 1, 3))[..., 0, :]
    w = v[..., 2]
    w_safe = torch.where(w.abs() > 1e-18, w, torch.full_like(w, 1e-18))
    x = v[..., 0] / w_safe
    y = v[..., 1] / w_safe
    valid = valid & torch.isfinite(x) & torch.isfinite(y) & (w.abs() > 1e-18)

    coeff = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)  # [..., R, 4]
    es = (coeff @ basis.reshape(*basis.shape[:-3], 4, 9)).reshape(*coeff.shape[:-1], 3, 3)
    fro = torch.linalg.vector_norm(es, dim=(-2, -1), keepdim=True)
    return es / torch.clamp(fro, min=1e-18), valid
