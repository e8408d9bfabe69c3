"""Brute-force Hamming matcher with the reference's match filter
(counterpart of slamtpu/feature/matcher.py).

Matches are a fixed-size struct of tensors with a validity mask; every
query keeps a slot. Batched over leading dimensions (one per frame pair).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.hamming import descriptor_bits, hamming_matrix_from_bits

__all__ = ["Matches", "FeatureMatcher"]

_BIG = 1 << 20


class Matches(NamedTuple):
    """query_idx is implicit (= arange)."""

    train_idx: torch.Tensor  # [..., N] int64
    distance: torch.Tensor  # [..., N] int32
    mask: torch.Tensor  # [..., N] bool — True where the match slot is live

    def count(self) -> torch.Tensor:
        """Live matches, summed over every dimension (a 0-d int32 tensor)."""
        return torch.sum(self.mask, dtype=torch.int32)


class FeatureMatcher:
    """Brute-force Hamming matcher, crossCheck=false."""

    DIST_FLOOR = 30.0  # max(ratio * min_dist, 30.0)

    def match_descriptors(self, query_packed, train_packed, query_mask=None, train_mask=None) -> Matches:
        """Best live train match per query from packed descriptors [..., N, 32]
        and [..., M, 32] uint8; an empty side gives N dead slots."""
        n, m = query_packed.shape[-2], train_packed.shape[-2]
        if n == 0 or m == 0:
            shape, dev = query_packed.shape[:-1], query_packed.device
            return Matches(torch.zeros(shape, dtype=torch.int64, device=dev),
                           torch.zeros(shape, dtype=torch.int32, device=dev),
                           torch.zeros(shape, dtype=torch.bool, device=dev))
        q_bits, q_pop = descriptor_bits(query_packed)
        t_bits, t_pop = descriptor_bits(train_packed)
        return self.match_from_bits(q_bits, q_pop, query_mask, t_bits, t_pop, train_mask)

    def match_from_bits(self, q_bits, q_pop, q_mask, t_bits, t_pop, t_mask) -> Matches:
        """Best live train match per query from pre-unpacked bits
        (ops.hamming.descriptor_bits). Ties go to the lowest train index."""
        dist = hamming_matrix_from_bits(q_bits, q_pop, t_bits, t_pop)
        if t_mask is not None:
            dist = torch.where(t_mask[..., None, :], dist, torch.full_like(dist, _BIG))
        best = torch.amin(dist, dim=-1)
        idx = torch.argmin(dist, dim=-1)  # first minimum, like jnp.argmin
        mask = torch.ones(q_bits.shape[:-1], dtype=torch.bool, device=dist.device)
        if q_mask is not None:
            mask = mask & q_mask
        if t_mask is not None:
            mask = mask & torch.gather(t_mask, -1, idx)
        return Matches(idx, best, mask)

    def filter_good_matches(self, matches: Matches, ratio: float = 2.0) -> Matches:
        """Keep live matches with dist < max(ratio * min_dist, 30.0); min_dist
        is taken over live matches only (per pair)."""
        live = torch.where(matches.mask, matches.distance, torch.full_like(matches.distance, _BIG))
        min_dist = torch.amin(live, dim=-1, keepdim=True).to(torch.float32)
        threshold = torch.clamp(ratio * min_dist, min=self.DIST_FLOOR)
        good = matches.mask & (matches.distance.to(torch.float32) < threshold)
        return Matches(matches.train_idx, matches.distance, good)
