"""Furthest point sampling and point gathers (counterpart of ``unopose_tpu/ops/fps.py``).

``fps`` dispatches on the tensor's device: a CPU tensor takes the plain
PyTorch loop ``fps_plain``, a CUDA tensor the hand-written kernel
``kernels/csrc/fps.cu`` through ``fps_cuda``, which replaces the TPU kernel
``unopose_tpu/ops/fps.py:fps_pallas``. Both start at index 0 and break
argmax ties by the smallest index, and both sum the squared distance as
((dx*dx + dy*dy) + dz*dz) with every operation rounded on its own, so
their indices are equal.
"""

from __future__ import annotations

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build

_BIG = 1e10
MAX_N = 232448 // 16  # the largest cloud the kernel takes (its first version's shared-memory bound, kept)


def fps_plain(pts: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 FPS indices, one torch op at a time."""
    pts = pts.float()
    B, N, _ = pts.shape
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    mind = torch.full((B, N), _BIG, dtype=torch.float32, device=pts.device)
    out = torch.zeros((B, npoint), dtype=torch.int64, device=pts.device)
    last = torch.zeros((B, 1), dtype=torch.int64, device=pts.device)
    for j in range(1, npoint):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        d = dx * dx + dy * dy + dz * dz
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1, keepdim=True)  # first occurrence on ties
        out[:, j] = last[:, 0]
    return out.to(torch.int32)


def fps_cuda(pts: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS on the card (``csrc/fps.cu``): one 1024-thread block per cloud,
    the points in registers, one barrier a step. N <= ``MAX_N``."""
    if pts.device.type != "cuda":
        raise ValueError(f"fps_cuda needs a CUDA tensor, got {pts.device}")
    if pts.dim() != 3 or pts.shape[-1] != 3:
        raise ValueError(f"fps_cuda expects (B, N, 3), got {tuple(pts.shape)}")
    B, N, _ = pts.shape
    if not 1 <= npoint <= N:
        raise ValueError(f"npoint {npoint} out of range for N={N}")
    if N > MAX_N:
        raise ValueError(f"fps_cuda takes clouds of at most {MAX_N} points, got N={N}")
    pts = pts.float().contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=pts.device)
    lib = build.load()
    with build.on_device(pts.device):
        err = lib.unopose_fps(pts.data_ptr(), out.data_ptr(), B, N, npoint, build.stream_of(pts))
    build.check(err, "fps")
    LAUNCHES["fps"] += 1
    return out


def fps(pts: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices (B, npoint) int32 of a (B, N, 3) cloud, dispatched by device."""
    if pts.device.type == "cpu":
        return fps_plain(pts, npoint)
    return fps_cuda(pts, npoint)


def gather_points(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (B, N, *C) at (B, *M) indices -> (B, *M, *C)."""
    B = data.shape[0]
    tail = data.shape[2:]
    flat_idx = idx.reshape(B, -1).long()
    gi = flat_idx.reshape(flat_idx.shape + (1,) * len(tail)).expand(flat_idx.shape + tail)
    return torch.gather(data, 1, gi).reshape(idx.shape + tail)


def sample_pts_feats(pts: torch.Tensor, feats: torch.Tensor, npoint: int):
    """FPS-subsample a cloud and its features."""
    idx = fps(pts.detach().float(), npoint)
    return gather_points(pts, idx), gather_points(feats, idx)


def sample_pts_feats_wlrf(pts: torch.Tensor, pts_lrf: torch.Tensor, feats: torch.Tensor, npoint: int):
    """FPS-subsample points, their LRF coordinates and their features; also
    returns the FPS indices."""
    idx = fps(pts.detach().float(), npoint)
    return gather_points(pts, idx), gather_points(pts_lrf, idx), gather_points(feats, idx), idx
