"""Global and per-neighbourhood local reference frames (counterpart of
``unopose_tpu/ops/lrf.py``): z is the smallest covariance eigenvector with a
sign vote, x a border-weighted in-plane direction, y = x cross z."""

from __future__ import annotations

import torch

from unopose_tpu_torch.ops.geometry import sqrt_rn

from unopose_tpu_torch.ops.eig3 import smallest_eigvec_sym3, smallest_eigvec_sym3_planar


def _lrf_axes(rel: torch.Tensor, r_lrf: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """rel (..., M, 3) points minus centre, r_lrf (...,) -> (..., 3, 3) rows (x, y, z)."""
    rel = rel.float()
    M = rel.shape[-2]
    cov = torch.einsum("...mi,...mj->...ij", rel, rel) / M
    z = smallest_eigvec_sym3(cov)

    center_proj = -torch.einsum("...i,...mi->...m", z, rel)
    vote = (center_proj > 1e-3).sum(-1, dtype=torch.int32) - (center_proj < -1e-3).sum(-1, dtype=torch.int32)
    sign = torch.where(vote < 0, -1.0, 1.0)
    z = z * sign[..., None]

    norm = torch.einsum("...i,...mi->...m", z, rel)
    vi = rel - norm[..., None] * z[..., None, :]
    x_l2 = torch.linalg.vector_norm(rel, dim=-1)
    alpha = (r_lrf[..., None] - x_l2) ** 2
    beta = norm * norm
    vi_c = ((alpha * beta)[..., None] * vi).sum(-2)
    x = vi_c / (torch.linalg.vector_norm(vi_c, dim=-1, keepdim=True) + eps)
    y = torch.linalg.cross(x, z, dim=-1)
    return torch.stack([x, y, z], dim=-2)


def global_lrf(pts: torch.Tensor, r_lrf: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) -> (B, N, 3) coordinates in each cloud's global LRF, divided
    by r_lrf (default: max distance to the centroid)."""
    pts = pts.float()
    rel = pts - pts.mean(dim=-2, keepdim=True)
    if r_lrf is None:
        r_lrf = torch.linalg.vector_norm(rel, dim=-1).amax(dim=-1)
    lrf = _lrf_axes(rel, r_lrf)
    return torch.einsum("...ij,...mj->...mi", lrf, rel) / r_lrf[..., None, None]


def batch_lrf(centers: torch.Tensor, grouped_pts: torch.Tensor, r_lrf: float) -> torch.Tensor:
    """(B, P, M, 3) neighbour coordinates in each group's LRF, divided by
    r_lrf: centers (B, P, 3), grouped_pts (B, P, M, 3) absolute."""
    rel = grouped_pts.float() - centers.float()[..., None, :]
    r = torch.full(rel.shape[:-2], r_lrf, dtype=torch.float32, device=rel.device)
    return torch.einsum("...ij,...mj->...mi", _lrf_axes(rel, r), rel) / r_lrf


def batch_lrf_planar(center, grouped, r_lrf: float, mask=None, use_newton: bool = False):
    """Per-neighbourhood LRF coordinates in planar form.

    center: (cx, cy, cz) each (B, P); grouped: (gx, gy, gz) each (B, P, M)
    absolute neighbour coordinates; mask: optional (B, P, M) weights (bool
    or multiset multiplicities) for the moments, votes and sums;
    ``use_newton``: the acos-free eigenvalues of the fused PE kernel
    (``_masked_lrf_block_t`` of the JAX package). Returns (o0, o1, o2) each
    (B, P, M), divided by r_lrf.
    """
    cx, cy, cz = (c.float()[..., None] for c in center)
    gx, gy, gz = (g.float() for g in grouped)
    rx, ry, rz = gx - cx, gy - cy, gz - cz

    if mask is None:
        def mean(t):
            return t.mean(dim=-1)

        def msum(t):
            return t.sum(dim=-1)
    else:
        m = mask.float()
        cnt = torch.clamp_min(m.sum(dim=-1), 1.0)

        def mean(t):
            return (t * m).sum(dim=-1) / cnt

        def msum(t):
            return (t * m).sum(dim=-1)

    z0, z1, z2 = smallest_eigvec_sym3_planar(
        mean(rx * rx), mean(rx * ry), mean(rx * rz), mean(ry * ry), mean(ry * rz), mean(rz * rz),
        use_newton=use_newton,
    )

    cp = -(z0[..., None] * rx + z1[..., None] * ry + z2[..., None] * rz)
    vote = msum((cp > 1e-3).float()) - msum((cp < -1e-3).float())
    sgn = torch.where(vote < 0, -1.0, 1.0)
    z0, z1, z2 = z0 * sgn, z1 * sgn, z2 * sgn

    norm = z0[..., None] * rx + z1[..., None] * ry + z2[..., None] * rz
    x_l2 = sqrt_rn(rx * rx + ry * ry + rz * rz)
    w = (r_lrf - x_l2) ** 2 * (norm * norm)
    vx = msum(w * (rx - norm * z0[..., None]))
    vy = msum(w * (ry - norm * z1[..., None]))
    vz = msum(w * (rz - norm * z2[..., None]))
    vn = sqrt_rn(vx * vx + vy * vy + vz * vz) + 1e-10
    x0, x1, x2 = vx / vn, vy / vn, vz / vn

    y0 = x1 * z2 - x2 * z1
    y1 = x2 * z0 - x0 * z2
    y2 = x0 * z1 - x1 * z0

    inv_r = 1.0 / r_lrf
    o0 = (x0[..., None] * rx + x1[..., None] * ry + x2[..., None] * rz) * inv_r
    o1 = (y0[..., None] * rx + y1[..., None] * ry + y2[..., None] * rz) * inv_r
    o2 = (z0[..., None] * rx + z1[..., None] * ry + z2[..., None] * rz) * inv_r
    return o0, o1, o2
