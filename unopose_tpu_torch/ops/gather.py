"""Planar neighbour gather (counterpart of ``unopose_tpu/ops/gather_pallas.py``).

``gather_planar`` dispatches on device: CPU tensors take the plain
``gather_planar_plain``, CUDA tensors the kernel ``kernels/csrc/
gather_planar.cu`` through ``gather_planar_cuda``, which replaces the TPU
kernel ``unopose_tpu/ops/gather_pallas.py:gather_planar``. Indices are
clamped to [0, N - 1] by both; in range the two agree bit for bit.

The gradient with respect to the planes is the JAX package's scatter-add
(``gather_pallas.py``'s ``segment_sum``, no kernel there either): plain
``index_add_`` into each plane, on either device. The train step sends no
gradient through it (the grouped coordinates are data); it is there for a
caller whose planes require one.
"""

from __future__ import annotations

import ctypes

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build


def _check(x, y, z, idx):
    if x.dim() != 2 or y.shape != x.shape or z.shape != x.shape:
        raise ValueError(f"planes must share a (B, N) shape, got {x.shape}, {y.shape}, {z.shape}")
    if idx.dim() < 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"idx must be (B, ...), got {tuple(idx.shape)} for planes {tuple(x.shape)}")
    if idx.dtype not in (torch.int16, torch.int32, torch.int64):
        raise ValueError(f"idx must be an integer tensor, got {idx.dtype}")


def gather_planar_plain(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, idx: torch.Tensor):
    """Three (B, N) planes at (B, ...) indices -> three (B, ...) planes."""
    _check(x, y, z, idx)
    B, N = x.shape
    flat = idx.reshape(B, -1).long().clamp(0, N - 1)
    return tuple(torch.gather(p.float(), 1, flat).reshape(idx.shape) for p in (x, y, z))


def gather_planar_cuda(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, idx: torch.Tensor):
    """The gather on the card (``csrc/gather_planar.cu``); int16 or int32 indices."""
    _check(x, y, z, idx)
    if not (x.device.type == "cuda" and y.device == x.device and z.device == x.device and idx.device == x.device):
        raise ValueError("gather_planar_cuda needs all tensors on one CUDA device")
    if idx.dtype == torch.int64:
        raise ValueError("gather_planar_cuda takes int16 or int32 indices")
    B, N = x.shape
    x, y, z = (p.float().contiguous() for p in (x, y, z))
    idx = idx.contiguous()
    per_batch = idx.numel() // B if B else 0
    outs = [torch.empty(idx.shape, dtype=torch.float32, device=x.device) for _ in range(3)]
    lib = build.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(x.device):
        err = lib.unopose_gather_planar(
            ptr(x.data_ptr()), ptr(y.data_ptr()), ptr(z.data_ptr()), ptr(idx.data_ptr()), idx.element_size(),
            ptr(outs[0].data_ptr()), ptr(outs[1].data_ptr()), ptr(outs[2].data_ptr()),
            B, N, per_batch, ptr(build.stream_of(x)),
        )
    build.check(err, "gather_planar")
    LAUNCHES["gather_planar"] += 1
    return tuple(outs)


def _gather(x, y, z, idx):
    if x.device.type == "cpu":
        return gather_planar_plain(x, y, z, idx)
    return gather_planar_cuda(x, y, z, idx)


class _GatherPlanar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, z, idx):
        ctx.save_for_backward(idx)
        ctx.plane_shape = x.shape
        ctx.mark_non_differentiable(idx)
        return _gather(x, y, z, idx)

    @staticmethod
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        B, N = ctx.plane_shape
        offsets = torch.arange(B, device=idx.device)[:, None] * N
        flat = (idx.reshape(B, -1).long().clamp(0, N - 1) + offsets).reshape(-1)
        out = []
        for g in grads:
            acc = torch.zeros(B * N, dtype=torch.float32, device=flat.device)
            out.append(acc.index_add_(0, flat, g.reshape(-1).float()).view(B, N))
        return (*out, None)


def gather_planar(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, idx: torch.Tensor):
    """Gather three (B, N) planes at (B, P, S) indices, dispatched by device;
    differentiable with respect to the planes (scatter-add backward)."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in (x, y, z)):
        return _GatherPlanar.apply(x, y, z, idx)
    return _gather(x, y, z, idx)
