"""Fused multi-head self-attention of the production ViT (counterpart of
``unopose_tpu/ops/vit_attn.py:mha_fused``), inference only.

softmax(q kᵀ / √hd) v per head, heads packed along the features (columns
h*hd:(h+1)*hd are head h), with the TPU kernel's rounding points: float32
scores from the operands, times hd**-0.5, minus the row max, ``exp``, the
row sum, then ``p / l`` cast to v's dtype, and a float32-accumulated
``p @ v`` cast to q's dtype. The row max and sum are exact over all keys
before the division: not the online rescaling of flash attention.

``mha_fused`` dispatches on device: CPU tensors take ``mha_fused_plain``;
CUDA tensors the kernel ``kernels/csrc/vit_attn.cu`` through
``mha_fused_cuda``, which replaces the TPU kernel
``unopose_tpu/ops/vit_attn.py:_attn_kernel``. The kernel reads q, k and v in
place from the (B, N, 3D) qkv output through its row stride.
"""

from __future__ import annotations

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build


def _check(q, k, v, num_heads: int) -> int:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] % num_heads:
        raise ValueError(f"D={q.shape[-1]} is not a multiple of num_heads={num_heads}")
    return q.shape[-1] // num_heads


def mha_fused_plain(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention with the TPU kernel's rounding points (module
    docstring). q, k, v (B, N, D) -> (B, N, D) in q's dtype."""
    hd = _check(q, k, v, num_heads)
    B, N, D = q.shape

    def heads(x):
        return x.reshape(B, N, num_heads, hd).transpose(1, 2).float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * hd**-0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    o = torch.matmul(p.float(), heads(v)).to(q.dtype)
    return o.transpose(1, 2).reshape(B, N, D)


def mha_fused_cuda(q, k, v, num_heads: int) -> torch.Tensor:
    """The attention on the card (``csrc/vit_attn.cu``): one block per
    (image, head), its K and V staged once, its warps walking 16-row query
    tiles with the scores in registers (N <= 272; longer rows recompute
    them per pass). bf16 runs on the tensor cores; float32
    (the tiny float32 configs) runs a scalar variant with the same rounding
    points. q, k, v may be column slices of one tensor: each needs a unit
    feature stride, and the three must share their batch and row strides. An
    N whose K and V slices do not fit in a block's shared memory raises the
    launcher's error."""
    hd = _check(q, k, v, num_heads)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("mha_fused_cuda needs q, k, v on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mha_fused_cuda takes bf16 or float32 q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    st = q.stride()
    if st[-1] != 1 or k.stride() != st or v.stride() != st:
        raise ValueError(f"q, k, v need a unit feature stride and equal strides, got {st}, {k.stride()}, "
                         f"{v.stride()}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and ((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 or st[0] % 8 or st[1] % 8):
        raise ValueError("mha_fused_cuda reads bf16 rows in 16-byte vectors: pointers 16-byte aligned, "
                         "batch and row strides multiples of 8")
    B, N, D = q.shape
    if hd % 16 or hd > 128:
        raise ValueError(f"mha_fused_cuda takes hd a multiple of 16 up to 128, got {hd}")
    out = torch.empty((B, N, D), dtype=q.dtype, device=dev)
    lib = build.load()
    with build.on_device(dev):
        err = lib.unopose_mha_fused(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, num_heads, hd,
                                    st[0], st[1], int(bf16), hd**-0.5, build.stream_of(q))
    build.check(err, "mha_fused")
    LAUNCHES["mha_fused"] += 1
    return out


def mha_fused(q, k, v, num_heads: int) -> torch.Tensor:
    """Fused multi-head self-attention, dispatched by device (module docstring)."""
    fn = mha_fused_plain if q.device.type == "cpu" else mha_fused_cuda
    return fn(q, k, v, num_heads)
