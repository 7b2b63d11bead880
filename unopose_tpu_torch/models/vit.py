"""DINOv2-style ViT backbone with four pyramid taps (counterpart of
``unopose_tpu/models/vit.py`` on its exact path: plain attention with a
softmax over the scores, exact-erf GELU, no int8 GEMMs).

The 12 blocks of ViT-B are four segments ``blocks0..3`` (``nn.ModuleList``
each, the flax scanned segments); the final LayerNorm of each segment's
output is one pyramid tap.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unopose_tpu_torch.models.layers import Dense, LayerNorm


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm block with LayerScale (timm ``Block``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: Optional[float], dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, dtype)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.attn_proj = Dense(dim, dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        if init_values is not None:
            self.ls1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.ls2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x):
        B, N, D = x.shape
        hd = D // self.num_heads
        q, k, v = self.qkv(self.norm1(x)).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-1, -2)) / hd**0.5
        if self.dtype.itemsize >= 4:
            attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        else:
            attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, D)
        out = self.attn_proj(out)
        if self.ls1 is not None:
            out = out * self.ls1.to(self.dtype)
        x = x + out
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = h * self.ls2.to(self.dtype)
        return x + h


class ViTPyramid(nn.Module):
    """ViT returning ``norm(x)`` after each of 4 segments, and the final cls token.
    Images are channels-last (B, H, W, 3)."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 14,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        init_values: Optional[float] = 1e-5,
        reg_tokens: int = 4,
        no_embed_class: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if not no_embed_class:
            raise NotImplementedError("only the no_embed_class (reg4) ViT variants are ported")
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.reg_tokens = reg_tokens
        self.dtype = dtype
        g = img_size // patch_size
        self.patch_embed = Dense(patch_size * patch_size * 3, embed_dim, dtype)
        self.pos_embed = nn.Parameter(torch.randn(1, g * g, embed_dim) * 0.02)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 0.02)
        self.reg_token = nn.Parameter(torch.randn(1, reg_tokens, embed_dim) * 0.02) if reg_tokens else None
        self.norm = LayerNorm(embed_dim, dtype)
        n = depth // 4
        for si, seg_len in enumerate([depth - 3 * n] + [n] * 3):
            blocks = nn.ModuleList(
                ViTBlock(embed_dim, num_heads, mlp_ratio, init_values, dtype) for _ in range(seg_len)
            )
            setattr(self, f"blocks{si}", blocks)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_prefix_tokens(self) -> int:
        return 1 + self.reg_tokens

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        B, H, W, _ = x.shape
        g, P, D = self.grid, self.patch_size, self.embed_dim
        if H != self.img_size or W != self.img_size:
            raise ValueError(f"expected {self.img_size}px images, got {H}x{W}")
        patches = x.reshape(B, g, P, g, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, P * P * 3)
        tokens = self.patch_embed(patches) + self.pos_embed.to(self.dtype)
        prefix = [self.cls_token.to(self.dtype).expand(B, 1, D)]
        if self.reg_token is not None:
            prefix.append(self.reg_token.to(self.dtype).expand(B, self.reg_tokens, D))
        tokens = torch.cat(prefix + [tokens], dim=1)
        outs = []
        for si in range(4):
            for blk in getattr(self, f"blocks{si}"):
                tokens = blk(tokens)
            outs.append(self.norm(tokens))
        return outs, outs[-1][:, 0, :]


VIT_VARIANTS = {
    "vit_small_patch14_reg4_dinov2": dict(embed_dim=384, depth=12, num_heads=6, init_values=1e-5, reg_tokens=4, patch_size=14),
    "vit_base_patch14_reg4_dinov2": dict(embed_dim=768, depth=12, num_heads=12, init_values=1e-5, reg_tokens=4, patch_size=14),
    "vit_large_patch14_reg4_dinov2": dict(embed_dim=1024, depth=24, num_heads=16, init_values=1e-5, reg_tokens=4, patch_size=14),
    "vit_tiny_test": dict(embed_dim=32, depth=4, num_heads=2, init_values=1e-5, reg_tokens=4, patch_size=14),
}


def make_vit(vit_type: str, img_size: int = 224, dtype: torch.dtype = torch.float32) -> ViTPyramid:
    if vit_type not in VIT_VARIANTS:
        raise ValueError(f"unknown or unported vit_type {vit_type}; known: {sorted(VIT_VARIANTS)}")
    return ViTPyramid(img_size=img_size, dtype=dtype, **VIT_VARIANTS[vit_type])
