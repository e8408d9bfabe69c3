"""LightGlue (Lindenberger, Sarlin, Pollefeys, "LightGlue: Local Feature
Matching at Light Speed", ICCV 2023, arXiv:2306.13643) as
github.com/cvg/LightGlue builds `LightGlue(features="superpoint")`:
descriptor_dim 256, 9 layers, 4 heads of 64, no scale or orientation
input, adaptive depth and width off. The submodules carry upstream's names
(`posenc.Wr`, `transformers.{i}.self_attn.*`, `transformers.{i}.cross_attn.*`,
`log_assignment.{i}.*`, `token_confidence.{i}.token.0`), so
`superpoint_lightglue.pth` loads with strict=True once `rename_old_keys`
has mapped its older `self_attn.{i}` / `cross_attn.{i}` keys.

Fixed shapes: both images of a pair hold K slots with a mask. A dead slot
is excluded from attention as upstream's padded path excludes its padding
(here as a key mask, so a live token never attends to a dead one), its rows
and columns of the log-assignment are -inf, and it matches nothing. The
two images of B pairs run stacked as [2B, K, ...] (images 0, then images
1): the self block is one batch, the cross block one attention call of
each image over the other (upstream's flash form of its bidirectional
block: one softmax per direction over the same similarity).

Attention runs through F.scaled_dot_product_attention. The position
encoding and the assignment's log-softmaxes and log-sigmoids run in
float32, whatever the network's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.graphs import device_constant, host_effect
from ..utils.metrics import count, span

__all__ = ["LightGlue", "normalize_keypoints", "rotate_half", "apply_cached_rotary_emb", "split_qkv",
           "sigmoid_log_double_softmax", "filter_matches", "rename_old_keys"]


def normalize_keypoints(kpts: torch.Tensor, size: tuple) -> torch.Tensor:
    """Pixels [..., N, 2] of an image of size (w, h) -> centred on the image
    and divided by half its longer side (upstream's `normalize_keypoints`)."""
    shift = device_constant((size[0] / 2, size[1] / 2), kpts.dtype, kpts.device)
    return (kpts - shift) / (max(size) / 2)


class LearnableFourierPositionalEncoding(nn.Module):
    def __init__(self, m: int, dim: int, f_dim: int):
        super().__init__()
        self.Wr = nn.Linear(m, f_dim // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, 2] -> the rotary encoding [2, B, 1, N, dim] (cos, sin)."""
        projected = self.Wr(x)
        emb = torch.stack([torch.cos(projected), torch.sin(projected)], 0).unsqueeze(-3)
        return emb.repeat_interleave(2, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Adjacent channel pairs (x1, x2) -> (-x2, x1)."""
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(dim=-1)
    return torch.stack((-x2, x1), dim=-1).flatten(start_dim=-2)


def apply_cached_rotary_emb(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (t * freqs[0]) + (rotate_half(t) * freqs[1])


def split_qkv(qkv: torch.Tensor, heads: int) -> tuple:
    """Wqkv's output [B, N, 3E], unflattened as (heads, E / heads, 3):
    q, k, v [B, heads, N, E / heads]."""
    qkv = qkv.unflatten(-1, (heads, -1, 3)).transpose(1, 2)
    return qkv[..., 0], qkv[..., 1], qkv[..., 2]


def _attention(q, k, v, key_mask):
    """softmax(q k^T / sqrt(d)) v over the live keys (key_mask [B, N]); a
    query with no live key gets 0, as upstream's nan_to_num gives it."""
    out = F.scaled_dot_product_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         attn_mask=key_mask[:, None, None, :])
    return out.nan_to_num()


def _ffn(dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * dim, 2 * dim), nn.LayerNorm(2 * dim, elementwise_affine=True), nn.GELU(),
                         nn.Linear(2 * dim, dim))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).flatten(start_dim=-2)


class SelfBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.Wqkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.ffn = _ffn(embed_dim)

    def forward(self, x, encoding, key_mask):
        q, k, v = split_qkv(self.Wqkv(x), self.num_heads)
        q, k = apply_cached_rotary_emb(encoding, q), apply_cached_rotary_emb(encoding, k)
        message = self.out_proj(_merge_heads(_attention(q, k, v, key_mask)))
        return x + self.ffn(torch.cat([x, message], -1))


def _swap(x: torch.Tensor, b: int) -> torch.Tensor:
    """Stacked [2B, ...] (images 0, images 1) -> the other image of each."""
    return torch.cat([x[b:], x[:b]])


class CrossBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.heads = num_heads
        self.to_qk = nn.Linear(embed_dim, embed_dim)
        self.to_v = nn.Linear(embed_dim, embed_dim)
        self.to_out = nn.Linear(embed_dim, embed_dim)
        self.ffn = _ffn(embed_dim)

    def forward(self, x, key_mask, b: int):
        qk, v = (t.unflatten(-1, (self.heads, -1)).transpose(1, 2) for t in (self.to_qk(x), self.to_v(x)))
        message = self.to_out(_merge_heads(_attention(qk, _swap(qk, b), _swap(v, b), _swap(key_mask, b))))
        return x + self.ffn(torch.cat([x, message], -1))


class TransformerLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.self_attn = SelfBlock(embed_dim, num_heads)
        self.cross_attn = CrossBlock(embed_dim, num_heads)

    def forward(self, x, encoding, key_mask, b: int):
        return self.cross_attn(self.self_attn(x, encoding, key_mask), key_mask, b)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.matchability = nn.Linear(dim, 1)
        self.final_proj = nn.Linear(dim, dim)

    def forward(self, x, mask, b: int) -> torch.Tensor:
        """Stacked [2B, N, D] -> the log-assignment [B, N + 1, N + 1] f32."""
        mdesc = self.final_proj(x) / x.shape[-1] ** 0.25
        sim = torch.matmul(mdesc[:b], mdesc[b:].transpose(-1, -2)).float()
        z = self.matchability(x).float()
        return sigmoid_log_double_softmax(sim, z[:b], z[b:], mask[:b], mask[b:])


class TokenConfidence(nn.Module):
    """Adaptive depth's exit classifier: held for strict loading, not run
    (depth_confidence=-1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.token = nn.Sequential(nn.Linear(dim, 1), nn.Sigmoid())


def sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1) -> torch.Tensor:
    """Upstream's log-assignment from the similarity [B, M, N] and the
    matchability logits z [B, *, 1], over the live slots (mask0 [B, M],
    mask1 [B, N]); every entry of a dead row or column is -inf."""
    b, m, n = sim.shape
    valid = mask0[:, :, None] & mask1[:, None, :]
    sim = sim.masked_fill(~valid, float("-inf"))
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    scores0 = F.log_softmax(sim, 2)
    scores1 = F.log_softmax(sim.transpose(-1, -2).contiguous(), 2).transpose(-1, -2)
    scores = sim.new_full((b, m + 1, n + 1), 0)
    scores[:, :m, :n] = (scores0 + scores1 + certainties).masked_fill(~valid, float("-inf"))
    scores[:, :-1, -1] = F.logsigmoid(-z0.squeeze(-1)).masked_fill(~mask0, float("-inf"))
    scores[:, -1, :-1] = F.logsigmoid(-z1.squeeze(-1)).masked_fill(~mask1, float("-inf"))
    return scores


def filter_matches(scores: torch.Tensor, th: float) -> tuple:
    """Upstream's `filter_matches` on the image-0 side: mutual arg-max of the
    inner block with exp(score) above `th`. (matches0 [B, M], -1 where
    none; mscores0 [B, M])."""
    inner = scores[:, :-1, :-1]
    max0, max1 = inner.max(2), inner.max(1)
    m0, m1 = max0.indices, max1.indices
    indices0 = torch.arange(m0.shape[1], device=m0.device)[None]
    mutual0 = indices0 == m1.gather(1, m0)
    max0_exp = max0.values.exp()
    mscores0 = torch.where(mutual0, max0_exp, torch.zeros_like(max0_exp))
    valid0 = mutual0 & (mscores0 > th)
    return torch.where(valid0, m0, torch.full_like(m0, -1)), mscores0


def rename_old_keys(state_dict: dict, n_layers: int) -> dict:
    """Upstream's rename of a published file's older keys: `self_attn.{i}`
    -> `transformers.{i}.self_attn`, `cross_attn.{i}` ->
    `transformers.{i}.cross_attn`."""
    for i in range(n_layers):
        for old, new in ((f"self_attn.{i}", f"transformers.{i}.self_attn"),
                         (f"cross_attn.{i}", f"transformers.{i}.cross_attn")):
            state_dict = {k.replace(old, new): v for k, v in state_dict.items()}
    return state_dict


class LightGlue(nn.Module):
    """Upstream's LightGlue module at fixed shapes (see the module's
    docstring); `forward` takes both images of B pairs stacked."""

    def __init__(self, descriptor_dim: int = 256, n_layers: int = 9, num_heads: int = 4,
                 filter_threshold: float = 0.1):
        super().__init__()
        self.filter_threshold = filter_threshold
        head_dim = descriptor_dim // num_heads
        self.posenc = LearnableFourierPositionalEncoding(2, head_dim, head_dim)
        self.transformers = nn.ModuleList([TransformerLayer(descriptor_dim, num_heads) for _ in range(n_layers)])
        self.log_assignment = nn.ModuleList([MatchAssignment(descriptor_dim) for _ in range(n_layers)])
        self.token_confidence = nn.ModuleList([TokenConfidence(descriptor_dim) for _ in range(n_layers - 1)])

    def forward(self, kpts, desc, mask, size: tuple) -> tuple:
        """Stacked keypoints [2B, N, 2] (pixels, f32), descriptors [2B, N, D]
        and masks [2B, N] of B pairs in images of size (w, h) ->
        (log-assignment [B, N + 1, N + 1] f32, matches0 [B, N], mscores0)."""
        b = kpts.shape[0] // 2
        dtype = self.log_assignment[-1].final_proj.weight.dtype
        encoding = self.posenc(normalize_keypoints(kpts, size)).to(dtype)
        x = desc.to(dtype)
        with span("lg.layers"):
            for layer in self.transformers:
                x = layer(x, encoding, mask, b)
        host_effect(lambda: (count("lg.pairs", b), count("lg.layers", b * len(self.transformers))))
        with span("lg.assign"):
            scores = self.log_assignment[-1](x, mask, b)
            matches0, mscores0 = filter_matches(scores, self.filter_threshold)
        return scores, matches0, mscores0
