"""DINOv2's vision transformer (Oquab et al., arXiv:2304.07193), the
encoder of Depth Anything V2, as upstream's dinov2.py builds it for
Depth Anything V2: no register tokens, blocks in one flat list
(block_chunks=0), MLP feed-forward, LayerScale, and the position table
interpolated bicubically by scale factors offset by 0.1 without
antialiasing. The submodules carry upstream's names, so a checkpoint's
`pretrained.*` tensors load with strict=True.

Attention runs through F.scaled_dot_product_attention (flash attention on
the H100 in bf16), with q scaled by 1 / sqrt(head size) inside it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

POS_OFFSET = 0.1  # DINOv2's interpolate_offset
LN_EPS = 1e-6


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)  # [B, gh gw, D]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)  # [B, heads, N, d]
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    """x += ls1 * Attn(LN(x)); x += ls2 * MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    """ViT of `depth` blocks `embed_dim` wide; the position table is the
    (img_size / patch_size)^2 grid of pretraining."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16, mlp_ratio: int = 4,
                 patch_size: int = 14, img_size: int = 518):
        super().__init__()
        self.patch_size = patch_size
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))  # training only; kept for the checkpoint
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def interpolate_pos_encoding(self, gh: int, gw: int) -> torch.Tensor:
        """The position table at a gh x gw patch grid, [1, 1 + gh gw, D],
        interpolated in float32 and cast to the table's dtype."""
        table = self.pos_embed
        n = table.shape[1] - 1
        if gh * gw == n and gh == gw:
            return table
        g = int(math.sqrt(n))
        grid = table.float()[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((gh + POS_OFFSET) / g, (gw + POS_OFFSET) / g), mode="bicubic",
                             antialias=False)
        if tuple(grid.shape[-2:]) != (gh, gw):
            raise ValueError(f"position table interpolated to {tuple(grid.shape[-2:])}, not {(gh, gw)}")
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([table.float()[:, :1], grid], dim=1).to(table.dtype)

    def get_intermediate_layers(self, x: torch.Tensor, layers) -> list:
        """[B, 3, H, W] -> the patch tokens after blocks `layers`, each
        through the final LayerNorm, class token dropped: [B, gh gw, D]."""
        gh, gw = x.shape[-2] // self.patch_size, x.shape[-1] // self.patch_size
        t = self.patch_embed(x)
        t = torch.cat([self.cls_token.expand(t.shape[0], -1, -1), t], dim=1)
        t = t + self.interpolate_pos_encoding(gh, gw)
        out = []
        for i, block in enumerate(self.blocks[: max(layers) + 1]):
            t = block(t)
            if i in layers:
                out.append(self.norm(t)[:, 1:])
        return out
