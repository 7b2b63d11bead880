"""Weighted Procrustes / Kabsch without a general SVD (counterpart of
``unopose_tpu/ops/procrustes.py``).

The rotation is the top eigenvector of Horn's symmetric 4x4 (Davenport
q-method) matrix, found by repeated normalised squaring. Kept instead of
``torch.linalg.svd``, whose sign conventions differ, so both packages pick
the same rotation on degenerate correlations.
"""

from __future__ import annotations

import torch


def _top_eigvec_sym4_planar(k_entries, n_squarings: int = 14) -> torch.Tensor:
    """k_entries: 10 arrays (k00, k01, k02, k03, k11, k12, k13, k22, k23, k33)
    -> (..., 4) unit top eigenvectors."""
    a, b, c, d, e, f, g, h, i, j = (x.float() for x in k_entries)
    fro = torch.sqrt(a * a + e * e + h * h + j * j + 2 * (b * b + c * c + d * d + f * f + g * g + i * i)) + 1e-12
    a, b, c, d, e, f, g, h, i, j = (x / fro for x in (a, b, c, d, e, f, g, h, i, j))
    a, e, h, j = a + 1.2, e + 1.2, h + 1.2, j + 1.2

    for _ in range(n_squarings):
        na = a * a + b * b + c * c + d * d
        nb = a * b + b * e + c * f + d * g
        nc = a * c + b * f + c * h + d * i
        nd = a * d + b * g + c * i + d * j
        ne = b * b + e * e + f * f + g * g
        nf = b * c + e * f + f * h + g * i
        ng = b * d + e * g + f * i + g * j
        nh = c * c + f * f + h * h + i * i
        ni = c * d + f * g + h * i + i * j
        nj = d * d + g * g + i * i + j * j
        fro = torch.sqrt(
            na * na + ne * ne + nh * nh + nj * nj + 2 * (nb * nb + nc * nc + nd * nd + nf * nf + ng * ng + ni * ni)
        ) + 1e-12
        a, b, c, d, e, f, g, h, i, j = (x / fro for x in (na, nb, nc, nd, ne, nf, ng, nh, ni, nj))

    n0 = a * a + b * b + c * c + d * d
    n1 = b * b + e * e + f * f + g * g
    n2 = c * c + f * f + h * h + i * i
    n3 = d * d + g * g + i * i + j * j
    cols = ((a, b, c, d), (b, e, f, g), (c, f, h, i), (d, g, i, j))
    best = torch.argmax(torch.stack([n0, n1, n2, n3]), dim=0)
    v = []
    for comp in range(4):
        val = cols[3][comp]
        for cand in (2, 1, 0):
            val = torch.where(best == cand, cols[cand][comp], val)
        v.append(val)
    q = torch.stack(v, dim=-1)
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)


def _k_entries(Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz):
    return (
        Sxx + Syy + Szz,
        Syz - Szy,
        Szx - Sxz,
        Sxy - Syx,
        Sxx - Syy - Szz,
        Sxy + Syx,
        Szx + Sxz,
        -Sxx + Syy - Szz,
        Syz + Szy,
        -Sxx - Syy + Szz,
    )


def _quat_entries(q: torch.Tensor):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z),
        2 * (x * y - z * w),
        2 * (x * z + y * w),
        2 * (x * y + z * w),
        1 - 2 * (x * x + z * z),
        2 * (y * z - x * w),
        2 * (x * z - y * w),
        2 * (y * z + x * w),
        1 - 2 * (x * x + y * y),
    )


def kabsch_rotation_planar(h_entries):
    """9 correlation-entry arrays (Hxx .. Hzz) -> 9 rotation-entry arrays (r00 .. r22)."""
    q = _top_eigvec_sym4_planar(_k_entries(*(x.float() for x in h_entries)))
    return _quat_entries(q)


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) correlation H = sum w s r^T -> (..., 3, 3) rotation R with r ~= R s."""
    H = H.float()
    r = kabsch_rotation_planar(tuple(H[..., i, j] for i in range(3) for j in range(3)))
    return torch.stack(r, dim=-1).reshape(H.shape)


def weighted_procrustes(
    src_points: torch.Tensor,
    ref_points: torch.Tensor,
    weights: torch.Tensor | None = None,
    weight_thresh: float = 0.0,
    eps: float = 1e-5,
):
    """Weighted rigid alignment src -> ref: (B, N, 3) twice, (B, N) weights
    -> R (B, 3, 3), t (B, 3) with ref ~= R src + t."""
    src_points = src_points.float()
    ref_points = ref_points.float()
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], dtype=torch.float32, device=src_points.device)
    weights = torch.where(weights < weight_thresh, torch.zeros_like(weights), weights)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    w = weights[..., None]

    src_centroid = (src_points * w).sum(dim=-2, keepdim=True)
    ref_centroid = (ref_points * w).sum(dim=-2, keepdim=True)
    src_c = src_points - src_centroid
    ref_c = ref_points - ref_centroid
    H = torch.einsum("...ni,...nj->...ij", src_c, w * ref_c)
    R = kabsch_rotation(H)
    t = ref_centroid[..., 0, :] - torch.einsum("...ij,...j->...i", R, src_centroid[..., 0, :])
    return R, t
