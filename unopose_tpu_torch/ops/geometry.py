"""Core geometry ops (counterpart of ``unopose_tpu/ops/geometry.py``)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in full float32 inside the block, whatever
    the caller set ``torch.backends.cuda.matmul.allow_tf32`` to."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest, as IEEE float32 square roots are (the
    JAX package's, and torch's on the card). On the CPU torch's vectorised
    float32 root lands one ulp off on some inputs (0.6% of uniform draws on
    an AVX-512 host, none on a short tensor), which makes the plain versions
    depend on the host: there the root is taken in float64 and rounded to
    float32, which rounds it correctly (53 >= 2 x 24 + 2 bits)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (*, N, M) between (*, N, C) and (*, M, C), clamped at 0.

    Expansion form x2 - 2 x.y + y2 in float32; the package keeps TF32 off,
    since a truncated cross term cancels catastrophically on clouds far from
    the origin.
    """
    x = x.float()
    y = y.float()
    xy = torch.matmul(x, y.transpose(-1, -2))
    x2 = (x * x).sum(-1)[..., :, None]
    y2 = (y * y).sum(-1)[..., None, :]
    return (x2 - 2.0 * xy + y2).clamp_min(0.0)


def normalize_vec(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=dim, keepdim=True) + eps)


def compute_feature_similarity(
    feat1: torch.Tensor,
    feat2: torch.Tensor,
    temp: float = 1.0,
    normalize_feat: bool = True,
) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N, M) temperature-scaled cosine similarity,
    float32 (the model's ``sim_type="cosine"``; the port refuses other types)."""
    if normalize_feat:
        feat1 = normalize_vec(feat1)
        feat2 = normalize_vec(feat2)
    return torch.matmul(feat1.float(), feat2.float().transpose(-1, -2)) / temp
