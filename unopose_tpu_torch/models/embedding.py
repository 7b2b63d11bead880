"""Geometric structure embedding (counterpart of ``unopose_tpu/models/embedding.py``):
pairwise-distance and k-NN angle sinusoids, each through a learned
projection, max over the k angles; exact (``fused_table=0``) or fused from
pre-projected tables (``ops/geo_fused.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from unopose_tpu_torch.models.layers import Dense
from unopose_tpu_torch.ops.geo_fused import build_taylor_table, geo_rpe_fused
from unopose_tpu_torch.ops.geometry import pairwise_sqdist, sqrt_rn


def bounded_sincos(om: torch.Tensor):
    """(sin, cos) by quadrant reduction and degree-7/6 polynomials on |r| <= pi/4."""
    om = om.float()
    k = torch.round(om * np.float32(2.0 / np.pi).item())
    r = om - k * np.float32(np.pi / 2.0).item()
    r2 = r * r
    sr = r * (1.0 - r2 / 6.0 * (1.0 - r2 / 20.0 * (1.0 - r2 / 42.0)))
    cr = 1.0 - r2 / 2.0 * (1.0 - r2 / 12.0 * (1.0 - r2 / 30.0))
    q = k.to(torch.int32) & 3
    sin = torch.where(q == 0, sr, torch.where(q == 1, cr, torch.where(q == 2, -sr, -cr)))
    cos = torch.where(q == 0, cr, torch.where(q == 1, -sr, torch.where(q == 2, -cr, sr)))
    return sin, cos


def sinusoidal_embedding(indices: torch.Tensor, d_model: int, poly_xmax: float | None = None) -> torch.Tensor:
    """Concatenated [sin..., cos...] of index * 10000^(-2i/d). With a static
    bound |index| <= poly_xmax, frequencies whose argument stays <= 0.5 use
    small-angle polynomials."""
    if d_model % 2:
        raise ValueError(f"odd d_model: {d_model}")
    div = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=indices.device) * np.float32(-np.log(10000.0) / d_model).item()
    )
    x = indices[..., None].float()
    if poly_xmax is None:
        s, c = bounded_sincos(x * div)
        return torch.cat([s, c], dim=-1)
    i0 = int(np.ceil(d_model / 2 * np.log(2.0 * poly_xmax) / np.log(10000.0)))
    i0 = max(0, min(d_model // 2, i0))
    sin_hi, cos_hi = bounded_sincos(x * div[:i0])
    om = x * div[i0:]
    om2 = om * om
    sin_lo = om * (1.0 - om2 / 6.0 * (1.0 - om2 / 20.0))
    cos_lo = 1.0 - om2 / 2.0 * (1.0 - om2 / 12.0)
    return torch.cat([sin_hi, sin_lo, cos_hi, cos_lo], dim=-1)


def knn_anchor_vectors(points: torch.Tensor, k: int):
    """(B, N, 3) -> (pairwise distances (B, N, N), vectors to each point's
    k nearest other points (B, N, k, 3))."""
    dist = sqrt_rn(pairwise_sqdist(points, points))
    knn_idx = torch.topk(-dist, k + 1, dim=-1).indices[..., 1:]  # nearest k, self excluded
    knn_pts = torch.gather(
        points[:, None].expand(-1, points.shape[1], -1, -1), 2, knn_idx[..., None].expand(-1, -1, -1, 3)
    )
    return dist, knn_pts - points[:, :, None, :]


class GeometricStructureEmbedding(nn.Module):
    """points (B, N, 3) -> embeddings (B, N, N, hidden_dim) in ``dtype``.

    ``fused_table`` > 0 (with ``d_index_max`` set and ``reduction_a="max"``,
    the JAX package's conditions) takes the fused path of ``ops/geo_fused.py``
    (the ``geo_rpe`` kernel on the card) on T-point pre-projected tables:
    with ``quant_int8`` it returns (e8 (B, N, N, D) int8, scale (D,) float32),
    else the embedding in ``dtype`` (float32 with the float32 contraction, or
    bf16 with the bf16 one), which the RPE layers read as they read the exact
    path's.
    """

    def __init__(self, hidden_dim: int = 256, sigma_d: float = 0.2, sigma_a: float = 15.0, angle_k: int = 3,
                 reduction_a: str = "max", d_index_max: float | None = None, dtype: torch.dtype = torch.float32,
                 fused_table: int = 0, quant_int8: bool = False):
        super().__init__()
        if reduction_a not in ("max", "mean"):
            raise ValueError(reduction_a)
        self.hidden_dim, self.sigma_d, self.sigma_a = hidden_dim, sigma_d, sigma_a
        self.angle_k, self.reduction_a, self.d_index_max = angle_k, reduction_a, d_index_max
        self.dtype = dtype
        self.fused_table = fused_table if d_index_max is not None and reduction_a == "max" else 0
        self.quant_int8 = quant_int8
        self.proj_d = Dense(hidden_dim, hidden_dim, dtype)
        self.proj_a = Dense(hidden_dim, hidden_dim, dtype)

    def forward(self, points: torch.Tensor, train: bool = False):
        """In training the exact path runs whatever ``fused_table`` says (the
        JAX package's gate: the fused kernel has no backward); the gradient
        reaches the two projections, not the points."""
        points = points.detach().float()
        k = self.angle_k
        factor_a = 180.0 / (self.sigma_a * math.pi)
        dist, ref_vec = knn_anchor_vectors(points, k)
        if self.fused_table and not train:
            T = self.fused_table
            # the raw float32 projections: nn.Linear (out, in) -> the flax (in, out) kernel
            tab_d, scale_d = build_taylor_table(self.proj_d.weight.t(), self.proj_d.bias, float(self.d_index_max), T)
            tab_a, scale_a = build_taylor_table(self.proj_a.weight.t(), self.proj_a.bias, float(np.pi * factor_a), T)
            return geo_rpe_fused(points, ref_vec, tab_d, tab_a, scale_d, scale_a, self.sigma_d, factor_a,
                                 out_dtype=self.dtype, quantize=self.quant_int8)

        d_indices = dist / self.sigma_d
        ax = points[:, None, :, 0] - points[:, :, None, 0]
        ay = points[:, None, :, 1] - points[:, :, None, 1]
        az = points[:, None, :, 2] - points[:, :, None, 2]

        d_emb = self.proj_d(sinusoidal_embedding(d_indices, self.hidden_dim, poly_xmax=self.d_index_max))
        a_emb = None
        for kk in range(k):
            rx = ref_vec[:, :, kk, 0][:, :, None]
            ry = ref_vec[:, :, kk, 1][:, :, None]
            rz = ref_vec[:, :, kk, 2][:, :, None]
            cx = ry * az - rz * ay
            cy = rz * ax - rx * az
            cz = rx * ay - ry * ax
            sin_v = sqrt_rn(cx * cx + cy * cy + cz * cz)
            cos_v = rx * ax + ry * ay + rz * az
            # a degenerate anchor gives angle 0, not atan2(0, -0.0) = pi
            cos_v = torch.where((sin_v == 0.0) & (cos_v == 0.0), torch.ones_like(cos_v), cos_v)
            a_idx = torch.atan2(sin_v, cos_v) * factor_a
            e = self.proj_a(sinusoidal_embedding(a_idx, self.hidden_dim, poly_xmax=float(np.pi * factor_a)))
            if a_emb is None:
                a_emb = e
            elif self.reduction_a == "max":
                a_emb = torch.maximum(a_emb, e)
            else:
                a_emb = a_emb + e
        if self.reduction_a == "mean":
            a_emb = a_emb / k
        return d_emb + a_emb
