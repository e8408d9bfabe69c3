"""Brute-force Hamming distances as one matmul on unpacked bits
(counterpart of slamtpu/ops/hamming.py).

For bit vectors a, b in {0,1}^256: hamming(a, b) = |a| + |b| - 2 <a, b>.
The product runs in bf16: every operand is 0 or 1 and every partial sum an
integer <= 256, all exact in bf16, so the distances are exact whatever the
summation order. Bit order: bit k of byte j is (byte[j] >> k) & 1.
"""

from __future__ import annotations

import torch

__all__ = ["unpack_bits", "pack_bits", "descriptor_bits", "hamming_matrix_from_bits"]


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
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.int32, device=bits.device)
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
