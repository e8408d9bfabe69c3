"""Brute-force Hamming distances as one matmul on unpacked bits
(counterpart of slamtpu/ops/hamming.py).

For bit vectors a, b in {0,1}^256: hamming(a, b) = |a| + |b| - 2 <a, b>.
The product runs in bf16: every operand is 0 or 1 and every partial sum an
integer <= 256, all exact in bf16, so the distances are exact whatever the
summation order. Bit order: bit k of byte j is (byte[j] >> k) & 1.
"""

from __future__ import annotations

import torch

from ..utils.graphs import device_constant

__all__ = ["unpack_bits", "pack_bits", "descriptor_bits", "hamming_matrix", "hamming_matrix_from_bits",
           "hamming_matrix_popcount", "match_best", "match_top2"]


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., B] -> uint8 bits [..., B*8] (little bit order)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(packed[..., :, None], shifts), 1)
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bits [..., B*8] -> uint8 [..., B] (little bit order)."""
    n = bits.shape[-1]
    if n % 8:
        raise ValueError("bit count must be a multiple of 8")
    grouped = bits.to(torch.int32).reshape(*bits.shape[:-1], n // 8, 8)
    weights = device_constant(tuple(1 << i for i in range(8)), torch.int32, bits.device)
    return torch.sum(grouped * weights, dim=-1).to(torch.uint8)


def descriptor_bits(packed: torch.Tensor):
    """[..., N, B] uint8 -> (bits [..., N, B*8] bf16, popcounts [..., N] f32),
    unpacked once per frame for repeated matching."""
    bits = unpack_bits(packed).to(torch.bfloat16)
    pops = torch.sum(bits.to(torch.float32), dim=-1)
    return bits, pops


def hamming_matrix_from_bits(q_bits, q_pop, t_bits, t_pop) -> torch.Tensor:
    """Pairwise distances [..., N, M] int32 from pre-unpacked bits."""
    dots = torch.matmul(q_bits, t_bits.transpose(-1, -2)).to(torch.float32)
    dist = q_pop[..., :, None] + t_pop[..., None, :] - 2.0 * dots
    return dist.to(torch.int32)


def hamming_matrix(query_packed, train_packed) -> torch.Tensor:
    """Pairwise distances [..., N, M] int32 from packed descriptors
    [..., N, B] and [..., M, B] uint8: one matmul on unpacked bits."""
    q_bits, q_pop = descriptor_bits(query_packed)
    t_bits, t_pop = descriptor_bits(train_packed)
    return hamming_matrix_from_bits(q_bits, q_pop, t_bits, t_pop)


_POPCOUNT8 = tuple(bin(i).count("1") for i in range(256))


def hamming_matrix_popcount(query_packed, train_packed) -> torch.Tensor:
    """Reference path: XOR of the packed bytes and a popcount table,
    [N, B] x [M, B] uint8 -> [N, M] int32."""
    table = device_constant(_POPCOUNT8, torch.int32, query_packed.device)
    xored = torch.bitwise_xor(query_packed[:, None, :], train_packed[None, :, :])
    return torch.sum(table[xored.to(torch.int64)], dim=-1, dtype=torch.int32)


def match_best(query_packed, train_packed, big: int = 1 << 30):
    """Best train match per query: (train_idx [N] int32, distance [N]
    int32), the first minimum on ties; with M == 0, index 0 at `big`."""
    dist = hamming_matrix(query_packed, train_packed)
    if dist.shape[-1] == 0:
        n = dist.shape[-2]
        return (torch.zeros((n,), dtype=torch.int32, device=dist.device),
                torch.full((n,), big, dtype=torch.int32, device=dist.device))
    return torch.argmin(dist, dim=-1).to(torch.int32), torch.amin(dist, dim=-1)


def match_top2(query_packed, train_packed):
    """Best and second-best distances per query, for ratio tests:
    (train_idx [N], best [N], second [N]) int32; ties go to the lower
    train index, as jax.lax.top_k orders them."""
    dist = hamming_matrix(query_packed, train_packed)
    order = torch.sort(dist, dim=-1, stable=True)
    return (order.indices[..., 0].to(torch.int32), order.values[..., 0].to(torch.int32),
            order.values[..., 1].to(torch.int32))
