"""Attention layers of the matching transformers (counterpart of
``unopose_tpu/models/attention.py``): post-norm MHA, RPE MHA with the
positional projection folded onto the query side, and focused linear
attention with its float32 island."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unopose_tpu_torch.models.layers import Dense, LayerNorm


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, N, h*c) -> (B, h, N, c)."""
    B, N, D = x.shape
    return x.reshape(B, N, h, D // h).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, h, N, c) -> (B, N, h*c)."""
    B, h, N, c = x.shape
    return x.transpose(1, 2).reshape(B, N, h * c)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.proj_q = Dense(d_model, d_model, dtype)
        self.proj_k = Dense(d_model, d_model, dtype)
        self.proj_v = Dense(d_model, d_model, dtype)

    def forward(self, q_in, k_in, v_in):
        h = self.num_heads
        q, k, v = (_heads(p(x), h) for p, x in ((self.proj_q, q_in), (self.proj_k, k_in), (self.proj_v, v_in)))
        scores = torch.matmul(q, k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
        attn = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        return _merge(torch.matmul(attn, v))


class FoldedPosProj(nn.Module):
    """proj_p applied on the query side: q . (e W + b) == (W^T q) . e + q . b,
    so the (B, N, M, C) embedding is only read, never projected."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.weight = nn.Parameter(torch.empty(d_model, d_model))  # (out, in), like nn.Linear
        self.bias = nn.Parameter(torch.zeros(d_model))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, q):
        """q (B, h, N, c) -> (q_tilde (B, h, N, d_model), q_bias (B, h, N))."""
        h, c = self.num_heads, q.shape[-1]
        W = self.weight.t().reshape(-1, h, c).to(self.dtype)  # (d_in, h, c)
        b = self.bias.reshape(h, c).to(self.dtype)
        return torch.einsum("bhnc,dhc->bhnd", q, W), torch.einsum("bhnc,hc->bhn", q, b)


class RPEMultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.proj_q = Dense(d_model, d_model, dtype)
        self.proj_k = Dense(d_model, d_model, dtype)
        self.proj_v = Dense(d_model, d_model, dtype)
        self.proj_p = FoldedPosProj(d_model, num_heads, dtype)

    def forward(self, q_in, k_in, v_in, embed_qk):
        """``embed_qk`` is (B, N, M, C), or the fused embedding's (e, scale)
        with e holding int8 codes (already in the model dtype, see
        ``UNOPose.forward``) and scale (C,) the per-channel dequant factor,
        which is folded into q-tilde."""
        h = self.num_heads
        q, k, v = (_heads(p(x), h) for p, x in ((self.proj_q, q_in), (self.proj_k, k_in), (self.proj_v, v_in)))
        qt, qb = self.proj_p(q)
        if isinstance(embed_qk, tuple):
            embed_qk, esc = embed_qk
            qt = qt * esc.to(self.dtype)[None, None, None, :]
        scores_p = torch.einsum("bhnd,bnmd->bhnm", qt, embed_qk.to(self.dtype)) + qb[..., None]
        scores = (torch.matmul(q, k.transpose(-1, -2)) + scores_p) / (q.shape[-1] ** 0.5)
        attn = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        return _merge(torch.matmul(attn, v))


class AttentionOutput(nn.Module):
    """FFN expand 2x -> relu -> squeeze, residual + LayerNorm."""

    def __init__(self, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.expand = Dense(d_model, 2 * d_model, dtype)
        self.squeeze = Dense(2 * d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x):
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.attention = MultiHeadAttention(d_model, num_heads, dtype)
        self.linear = Dense(d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)
        self.output = AttentionOutput(d_model, dtype)

    def forward(self, x, memory):
        hidden = self.linear(self.attention(x, memory, memory))
        return self.output(self.norm(hidden + x))


class RPETransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.attention = RPEMultiHeadAttention(d_model, num_heads, dtype)
        self.linear = Dense(d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)
        self.output = AttentionOutput(d_model, dtype)

    def forward(self, x, memory, position_states):
        hidden = self.linear(self.attention(x, memory, memory, position_states))
        return self.output(self.norm(hidden + x))


class LinearAttention(nn.Module):
    """Focused linear attention: relu kernel / softplus scale, features raised
    to ``focusing_factor`` and renormalised, all in float32."""

    def __init__(self, d_model: int, num_heads: int, focusing_factor: float, dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.focusing_factor, self.dtype = num_heads, focusing_factor, dtype
        self.proj_q = Dense(d_model, d_model, dtype)
        self.proj_k = Dense(d_model, d_model, dtype)
        self.proj_v = Dense(d_model, d_model, dtype)
        self.scale = nn.Parameter(torch.zeros(1, 1, d_model))

    def forward(self, q_in, k_in, v_in):
        q, k, v = self.proj_q(q_in), self.proj_k(k_in), self.proj_v(v_in)
        scale = F.softplus(self.scale.float())
        q = (F.relu(q.float()) + 1e-6) / scale
        k = (F.relu(k.float()) + 1e-6) / scale
        q_norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        k_norm = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
        q = q**self.focusing_factor
        k = k**self.focusing_factor
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True) * q_norm
        k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True) * k_norm

        h = self.num_heads
        B = q.shape[0]
        q, k, v = (_heads(x, h).flatten(0, 1) for x in (q, k, v.float()))  # (B*h, n, c)
        i, j, c, d = q.shape[-2], k.shape[-2], k.shape[-1], v.shape[-1]
        z = 1.0 / (torch.einsum("bic,bc->bi", q, k.sum(dim=1)) + 1e-6)
        if i * j * (c + d) > c * d * (i + j):
            kv = torch.einsum("bjc,bjd->bcd", k, v)
            x = torch.einsum("bic,bcd->bid", q, kv) * z[..., None]
        else:
            x = torch.einsum("bij,bjd->bid", torch.einsum("bic,bjc->bij", q, k), v) * z[..., None]
        return _merge(x.reshape(B, h, i, d)).to(self.dtype)


class LinearTransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, focusing_factor: float, dtype: torch.dtype):
        super().__init__()
        self.attention = LinearAttention(d_model, num_heads, focusing_factor, dtype)
        self.linear = Dense(d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)
        self.output = AttentionOutput(d_model, dtype)

    def forward(self, x, memory):
        hidden = self.linear(self.attention(x, memory, memory))
        return self.output(self.norm(hidden + x))
