"""Closed-form eigenvectors of symmetric 3x3 matrices (counterpart of
``unopose_tpu/ops/eig3.py``): trigonometric eigenvalues plus the
Cayley-Hamilton projector, all elementwise float32."""

from __future__ import annotations

import math

import torch

from unopose_tpu_torch.ops.geometry import sqrt_rn


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, descending."""
    A = A.float()
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = sqrt_rn(torch.clamp_min(p2 / 6.0, 0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Bm = (A - q[..., None, None] * eye) / safe_p[..., None, None]
    detB = (
        Bm[..., 0, 0] * (Bm[..., 1, 1] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 1])
        - Bm[..., 0, 1] * (Bm[..., 1, 0] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 0])
        + Bm[..., 0, 2] * (Bm[..., 1, 0] * Bm[..., 2, 1] - Bm[..., 1, 1] * Bm[..., 2, 0])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    iso = p2 <= 1e-30
    l1 = torch.where(iso, q, l1)
    l2 = torch.where(iso, q, l2)
    l3 = torch.where(iso, q, l3)
    return torch.stack([l1, l2, l3], dim=-1)


def _eigvec_for(A: torch.Tensor, lam_a: torch.Tensor, lam_b: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the remaining eigenvalue: largest column of (A - la I)(A - lb I)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = torch.matmul(A - lam_a[..., None, None] * eye, A - lam_b[..., None, None] * eye)
    norms = torch.linalg.vector_norm(M, dim=-2)  # column norms
    best = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(M, best[..., None, None].expand(*M.shape[:-1], 1), dim=-1)[..., 0]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device).expand(v.shape)
    scale = A.abs().amax(dim=(-2, -1))[..., None]
    ok = vn > 1e-20 * torch.clamp_min(scale, 1e-30) ** 2
    return torch.where(ok, v / torch.clamp_min(vn, 1e-30), fallback)


def smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3) A."""
    A = A.float()
    lams = eigvals_sym3(A)
    return _eigvec_for(A, lams[..., 0], lams[..., 1])


def largest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for the largest eigenvalue of symmetric (..., 3, 3) A."""
    A = A.float()
    lams = eigvals_sym3(A)
    return _eigvec_for(A, lams[..., 1], lams[..., 2])


def _cos_acos_div3_newton(r: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """cos(arccos(r) / 3) without acos: Newton on the triple-angle cubic
    4c^3 - 3c = r, whose root lies in [1/2, 1] for r in [-1, 1]."""
    r = torch.clamp(r, -1.0, 1.0)
    c = 0.5 + 0.5 * sqrt_rn(torch.clamp_min((r + 1.0) * 0.5, 0.0))
    for _ in range(iters):
        f = 4.0 * c * c * c - 3.0 * c - r
        df = torch.clamp_min(12.0 * c * c - 3.0, 1e-3)
        c = torch.clamp(c - f / df, 0.5, 1.0)
    return c


def cos_phi_pair(r: torch.Tensor, use_newton: bool = False):
    """(cos(phi), cos(phi + 2 pi / 3)) for phi = arccos(r) / 3, r in [-1, 1];
    ``use_newton`` takes the acos-free trisection of the fused PE kernel."""
    if use_newton:
        c1 = _cos_acos_div3_newton(r)
        s1 = sqrt_rn(torch.clamp_min(1.0 - c1 * c1, 0.0))  # sin(phi) >= 0 on [0, pi/3]
        return c1, -0.5 * c1 - (math.sqrt(3.0) / 2.0) * s1
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    return torch.cos(phi), torch.cos(phi + 2.0 * math.pi / 3.0)


def smallest_eigvec_sym3_planar(a, b, c, d, e, f, use_newton: bool = False):
    """Planar form for [[a, b, c], [b, d, e], [c, e, f]] given as 6 arrays;
    returns the three components of the unit smallest eigenvector.
    ``use_newton``: the eigenvalues by the acos-free trisection, as the fused
    PE (``ops/pe_fused.py``) and its kernel compute them."""
    a, b, c, d, e, f = (t.float() for t in (a, b, c, d, e, f))
    p1 = b * b + c * c + e * e
    q = (a + d + f) / 3.0
    p2 = (a - q) ** 2 + (d - q) ** 2 + (f - q) ** 2 + 2.0 * p1
    p = sqrt_rn(torch.clamp_min(p2 / 6.0, 0.0))
    sp = torch.where(p > 0, p, torch.ones_like(p))
    ba, bd, bf = (a - q) / sp, (d - q) / sp, (f - q) / sp
    bb, bc, be = b / sp, c / sp, e / sp
    detB = ba * (bd * bf - be * be) - bb * (bb * bf - be * bc) + bc * (bb * be - bd * bc)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    cp1, cp3 = cos_phi_pair(r, use_newton)
    l1 = q + 2.0 * p * cp1
    l3 = q + 2.0 * p * cp3
    l2 = 3.0 * q - l1 - l3
    iso = p2 <= 1e-30
    l1 = torch.where(iso, q, l1)
    l2 = torch.where(iso, q, l2)

    # columns of M = (A - l1 I)(A - l2 I) span the smallest eigenspace
    s, pr = l1 + l2, l1 * l2
    m00 = (a * a + b * b + c * c) - s * a + pr
    m01 = (a * b + b * d + c * e) - s * b
    m02 = (a * c + b * e + c * f) - s * c
    m11 = (b * b + d * d + e * e) - s * d + pr
    m12 = (b * c + d * e + e * f) - s * e
    m22 = (c * c + e * e + f * f) - s * f + pr

    n0 = m00 * m00 + m01 * m01 + m02 * m02
    n1 = m01 * m01 + m11 * m11 + m12 * m12
    n2 = m02 * m02 + m12 * m12 + m22 * m22
    best01 = n0 >= n1
    use2 = n2 > torch.where(best01, n0, n1)
    v0 = torch.where(use2, m02, torch.where(best01, m00, m01))
    v1 = torch.where(use2, m12, torch.where(best01, m01, m11))
    v2 = torch.where(use2, m22, torch.where(best01, m02, m12))
    nrm = sqrt_rn(v0 * v0 + v1 * v1 + v2 * v2)
    scale = torch.clamp_min(torch.maximum(torch.maximum(a.abs(), d.abs()), f.abs()), 1e-30)
    ok = nrm > 1e-20 * scale * scale
    inv = torch.where(ok, 1.0 / torch.clamp_min(nrm, 1e-30), torch.zeros_like(nrm))
    return v0 * inv, v1 * inv, torch.where(ok, v2 * inv, torch.ones_like(v2))
