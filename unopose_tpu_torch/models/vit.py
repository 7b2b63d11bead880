"""DINOv2-style ViT backbone with four pyramid taps (counterpart of
``unopose_tpu/models/vit.py``).

Two modes, as in the JAX package: the exact path (plain attention with a
softmax over the scores, exact-erf GELU), and with ``fused_attn`` the
production inference path: the fused attention ``ops/vit_attn.py:mha_fused``
(kernel ``vit_attn.cu`` on the card), tanh-GELU, and with ``int8_gemm`` the
W8A8 ``DenseQ`` GEMMs of every block. ``forward(x, train=True)`` runs the
exact path whatever the module was built with: the JAX package's auto gate
turns the production mode on for inference only.

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
from unopose_tpu_torch.ops.vit_attn import mha_fused


def quantize_rows(x: torch.Tensor):
    """Per-token int8 codes of x (..., K): (codes int8, scales (..., 1)
    float32), ``sx = max(max|x|, 1e-6) / 127`` and ``round(x / sx)``."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6) * (1.0 / 127.0)
    return torch.round(xf / sx).to(torch.int8), sx


class DenseQ(Dense):
    """``Dense`` with the JAX package's W8A8 path (``models/vit.py:DenseQ``):
    per-token activation scales ``sx = max(max|x|, 1e-6) / 127``, codes
    ``round(x / sx)`` (half to even), per-output-channel weight scales
    ``sw = max(max|W|, 1e-12) / 127``, an int8 x int8 -> int32 product
    (``torch._int_mm``), then ``y * (sx * sw) + bias`` in float32, cast to
    the compute dtype. The same leaves (``weight``, ``bias``) as ``Dense``.
    The weight codes and scales are made once per weight set (keyed on the
    weight's storage and in-place version; ``.to()`` drops them)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32, int8: bool = False):
        super().__init__(in_features, out_features, dtype)
        self.int8 = int8
        self._quant = None  # (key, (codes (in, out) int8 view, scales (out,) float32))

    def quantized_weight(self):
        key = (self.weight.data_ptr(), self.weight._version)
        if self._quant is None or self._quant[0] != key:
            with torch.no_grad():
                w = self.weight.float()
                sw = torch.clamp_min(w.abs().amax(dim=1), 1e-12) * (1.0 / 127.0)
                codes = torch.round(w / sw[:, None]).to(torch.int8)
            self._quant = (key, (codes.t(), sw))
        return self._quant[1]

    def _apply(self, fn, *args, **kwargs):
        self._quant = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        if not self.int8 or exact:
            return super().forward(x)
        K, N = self.in_features, self.out_features
        if K % 8 or N % 8:
            raise ValueError(f"the int8 product needs in and out features that are multiples of 8, got {K}, {N}")
        xq, sx = quantize_rows(x)
        xq = xq.reshape(-1, K)
        M = xq.shape[0]
        if M <= 16:  # the card's int8 product takes more than 16 rows
            xq = F.pad(xq, (0, 0, 0, 17 - M))
        codes, sw = self.quantized_weight()
        y = torch._int_mm(xq, codes)[:M].reshape(*x.shape[:-1], N)
        return (y.float() * (sx * sw) + self.bias.float()).to(self.compute_dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, gelu_tanh: bool = False, int8: bool = False):
        super().__init__()
        self.fc1 = DenseQ(dim, hidden, dtype, int8)
        self.fc2 = DenseQ(hidden, dim, dtype, int8)
        self.approximate = "tanh" if gelu_tanh else "none"

    def forward(self, x, exact: bool = False):
        approximate = "none" if exact else self.approximate
        return self.fc2(F.gelu(self.fc1(x, exact), approximate=approximate), exact)


class ViTBlock(nn.Module):
    """Pre-norm block with LayerScale (timm ``Block``). With ``fused_attn``
    the attention is ``mha_fused`` on the three column slices of the qkv
    output and the MLP's GELU is tanh-approximate; ``int8`` makes every
    GEMM of the block a ``DenseQ`` W8A8 product."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: Optional[float], dtype: torch.dtype,
                 fused_attn: bool = False, int8: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.fused_attn = fused_attn
        self.norm1 = LayerNorm(dim, dtype)
        self.qkv = DenseQ(dim, 3 * dim, dtype, int8)
        self.attn_proj = DenseQ(dim, dim, dtype, int8)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, gelu_tanh=fused_attn, int8=int8)
        if init_values is not None:
            self.ls1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.ls2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x, exact: bool = False):
        B, N, D = x.shape
        hd = D // self.num_heads
        qkv = self.qkv(self.norm1(x), exact)
        if self.fused_attn and not exact:
            out = mha_fused(*qkv.split(D, dim=-1), self.num_heads)
        else:
            q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
            attn = torch.matmul(q, k.transpose(-1, -2)) / hd**0.5
            if self.dtype.itemsize >= 4:
                attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
            else:
                attn = torch.softmax(attn, dim=-1)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, D)
        out = self.attn_proj(out, exact)
        if self.ls1 is not None:
            out = out * self.ls1.to(self.dtype)
        x = x + out
        h = self.mlp(self.norm2(x), exact)
        if self.ls2 is not None:
            h = h * self.ls2.to(self.dtype)
        return x + h


class ViTPyramid(nn.Module):
    """ViT returning ``norm(x)`` after each of 4 segments, and the final cls token.
    Images are channels-last (B, H, W, 3). ``fused_attn`` selects the
    production inference blocks; ``int8_gemm`` applies only with it, as in
    the JAX package (``int8=int8_gemm and fused``)."""

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
        fused_attn: bool = False,
        int8_gemm: bool = False,
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
                ViTBlock(embed_dim, num_heads, mlp_ratio, init_values, dtype, fused_attn, int8_gemm and fused_attn)
                for _ in range(seg_len)
            )
            setattr(self, f"blocks{si}", blocks)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_prefix_tokens(self) -> int:
        return 1 + self.reg_tokens

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[List[torch.Tensor], torch.Tensor]:
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
                tokens = blk(tokens, exact=train)
            outs.append(self.norm(tokens))
        return outs, outs[-1][:, 0, :]


VIT_VARIANTS = {
    "vit_small_patch14_reg4_dinov2": dict(embed_dim=384, depth=12, num_heads=6, init_values=1e-5, reg_tokens=4, patch_size=14),
    "vit_base_patch14_reg4_dinov2": dict(embed_dim=768, depth=12, num_heads=12, init_values=1e-5, reg_tokens=4, patch_size=14),
    "vit_large_patch14_reg4_dinov2": dict(embed_dim=1024, depth=24, num_heads=16, init_values=1e-5, reg_tokens=4, patch_size=14),
    "vit_tiny_test": dict(embed_dim=32, depth=4, num_heads=2, init_values=1e-5, reg_tokens=4, patch_size=14),
}


def make_vit(vit_type: str, img_size: int = 224, dtype: torch.dtype = torch.float32, fused_attn: bool = False,
             int8_gemm: bool = False) -> ViTPyramid:
    if vit_type not in VIT_VARIANTS:
        raise ValueError(f"unknown or unported vit_type {vit_type}; known: {sorted(VIT_VARIANTS)}")
    return ViTPyramid(img_size=img_size, dtype=dtype, fused_attn=fused_attn, int8_gemm=int8_gemm,
                      **VIT_VARIANTS[vit_type])
