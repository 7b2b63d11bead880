"""The fused fine positional encoding, PE-v5 (counterpart of
``unopose_tpu/ops/pe_fused.py:pe_fused_v5``), on the index grouping of
``ops/ball_query.py:two_scale_group_first_k_packed_idx``.

Two stages, each dispatched by device (CPU tensors take the plain PyTorch
twin, CUDA tensors the kernel):

- ``pe_channels``: gather each point's slot coordinates from the permuted
  planes, compute both scales' weighted LRFs (acos-free eigenvalues) and
  store the 12 channels (rel xyz, LRF-1, rel xyz, LRF-2) as bf16 in a
  (B, P, S2, 12) layout, a slot's channels together. Kernel
  ``kernels/csrc/pe_channels.cu`` (TPU kernel A, ``_pe_kernel_channels_t``).
- ``pe_mlp_pool``: the folded-BN MLP 6 -> 32 -> 64 -> 128 of each scale on
  the channels with bf16 operands and float32 accumulation, bias + ReLU and
  a bf16 cast after each layer, then the max over the slots of weight > 0.
  Kernel ``kernels/csrc/pe_mlp_pool.cu`` (TPU kernel B, ``_pe_kernel_mlp_v5``).

A point needs 64 * ceil(total2 / 64) slots (at least 64): the slots past
total2 carry weight 0 in both scales, so they change neither the LRF sums
nor the masked max. The kernels process and write only those slots; the
plain versions compute every slot (the channels) or every 64-slot chunk any
point needs (the pool), which gives the same values.

``pe_fused_masked`` is the masked point-major PE (counterpart of
``unopose_tpu/ops/pe_fused.py:pe_fused``) on two materialised groupings
with their validity masks: the subset mode, and the unpacked first_k
grouping with all-ones masks. Per scale: the LRF over the valid slots, the
six channels rounded to bf16, the same MLP, and the max over the valid
slots as a multiply by the mask after the ReLU. Kernel
``kernels/csrc/pe_masked.cu`` (the TPU kernel ``_pe_kernel``), dispatched by
device like the others.
"""

from __future__ import annotations

import ctypes

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.lrf import batch_lrf_planar

CHUNK = 64  # slots per MLP chunk
_K_PAD = (16, 32, 64)  # the kernel's K of each layer (layer 1: 6 channels zero-padded)
_ROW_PAD = 8  # bf16 per weight row of padding in the kernel's shared memory
_MLP_DIMS = (32, 64, 128)
_PACKED_PER_SCALE = sum(d * (k + _ROW_PAD) for d, k in zip(_MLP_DIMS, _K_PAD))


def chunks_needed(total2: torch.Tensor, s2: int) -> torch.Tensor:
    """64-slot chunks each point's neighbourhood needs: ceil(total2 / 64), in [1, s2 / 64]."""
    return torch.clamp((total2 + CHUNK - 1) // CHUNK, 1, s2 // CHUNK)


def _check(planes, idx_p, w1, w2, total2, center):
    B, N = planes[0].shape
    if any(p.shape != (B, N) for p in planes) or any(c.shape != idx_p.shape[:2] for c in center):
        raise ValueError("planes must be (B, N) and centres (B, P)")
    _, P, S2 = idx_p.shape
    if idx_p.shape[0] != B or w1.shape != idx_p.shape or w2.shape != idx_p.shape or total2.shape != (B, P):
        raise ValueError(f"idx_p, w1, w2 must be (B, P, S2) and total2 (B, P), got {tuple(idx_p.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(total2.shape)}")
    if S2 % CHUNK or not 0 < S2 <= 256:
        raise ValueError(f"S2 must be a multiple of {CHUNK} up to 256, got {S2}")


def pe_channels_plain(planes, idx_p, w1, w2, total2, center, r1: float, r2: float) -> torch.Tensor:
    """(B, P, S2, 12) bf16 channels of every slot (see module docstring)."""
    _check(planes, idx_p, w1, w2, total2, center)
    B, P, S2 = idx_p.shape
    flat = idx_p.reshape(B, -1).long()
    g = tuple(torch.gather(p.float(), 1, flat).reshape(B, P, S2) for p in planes)
    rel = [gi - c.float()[..., None] for gi, c in zip(g, center)]
    l1 = batch_lrf_planar(center, g, r1, mask=w1.float(), use_newton=True)
    l2 = batch_lrf_planar(center, g, r2, mask=w2.float(), use_newton=True)
    return torch.stack([*rel, *l1, *rel, *l2], dim=-1).to(torch.bfloat16)


def _check_cuda(name, tensors):
    dev = tensors[0].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{name} needs all tensors on one CUDA device")


def pe_channels_cuda(planes, idx_p, w1, w2, total2, center, r1: float, r2: float) -> torch.Tensor:
    """The channels on the card (``csrc/pe_channels.cu``): one warp per point.
    Slots past a point's 64 * ceil(total2 / 64) are left unwritten."""
    _check(planes, idx_p, w1, w2, total2, center)
    _check_cuda("pe_channels_cuda", (*planes, idx_p, w1, w2, total2, *center))
    B, N = planes[0].shape
    _, P, S2 = idx_p.shape
    if N > 4096 or idx_p.dtype != torch.int16:
        raise ValueError(f"pe_channels_cuda takes N <= 4096 and int16 indices (N={N}, {idx_p.dtype})")
    xp, yp, zp = (p.float().contiguous() for p in planes)
    cx, cy, cz = (c.float().contiguous() for c in center)
    idx_p, total2 = idx_p.contiguous(), total2.to(torch.int32).contiguous()
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    out = torch.empty((B, P, S2, 12), dtype=torch.bfloat16, device=xp.device)
    lib = build.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(xp.device):
        err = lib.unopose_pe_channels(
            *(ptr(t.data_ptr()) for t in (xp, yp, zp, idx_p, w1, w2, total2, cx, cy, cz, out)),
            B, N, P, S2, float(r1), float(r2), float(1.0 / r1), float(1.0 / r2), ptr(build.stream_of(xp)),
        )
    build.check(err, "pe_channels")
    LAUNCHES["pe_channels"] += 1
    return out


def pe_channels(planes, idx_p, w1, w2, total2, center, r1: float, r2: float) -> torch.Tensor:
    """(B, P, S2, 12) bf16 channels, dispatched by device."""
    fn = pe_channels_plain if planes[0].device.type == "cpu" else pe_channels_cuda
    return fn(planes, idx_p, w1, w2, total2, center, r1, r2)


def _check_mlp(chans, w1, w2, total2):
    B, P, S2, C = chans.shape
    if C != 12 or w1.shape != (B, P, S2) or w2.shape != (B, P, S2) or total2.shape != (B, P):
        raise ValueError(f"chans must be (B, P, S2, 12) with w1, w2 (B, P, S2) and total2 (B, P), got "
                         f"{tuple(chans.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(total2.shape)}")
    if S2 % CHUNK or not 0 < S2 <= 256:
        raise ValueError(f"S2 must be a multiple of {CHUNK} up to 256, got {S2}")


def _check_weights(mlp1, mlp2):
    for Ws, bs in (mlp1, mlp2):
        shapes = [tuple(W.shape) for W in Ws] + [tuple(b.shape) for b in bs]
        if shapes != [(6, 32), (32, 64), (64, 128), (32,), (64,), (128,)]:
            raise ValueError(f"the PE MLP must be 6 -> 32 -> 64 -> 128, got {shapes}")


def pe_mlp_pool_plain(chans, w1, w2, total2, mlp1, mlp2) -> torch.Tensor:
    """(B, P, S2, 12) bf16 channels -> (B, P, 256) float32 pooled features;
    ``mlp1``/``mlp2`` are each scale's folded (Ws, bs)."""
    _check_mlp(chans, w1, w2, total2)
    _check_weights(mlp1, mlp2)
    S2 = chans.shape[2]
    n_chunks = int(chunks_needed(total2, S2).max()) if total2.numel() else 1
    out = []
    for sc, ((Ws, bs), w) in enumerate(((mlp1, w1), (mlp2, w2))):
        Wb = [W.to(torch.bfloat16).float() for W in Ws]
        pooled = None
        for c in range(n_chunks):
            h = chans[:, :, c * CHUNK:(c + 1) * CHUNK, 6 * sc:6 * sc + 6].float()
            for W, b in zip(Wb, bs):
                h = torch.relu(torch.matmul(h, W) + b.float()).to(torch.bfloat16).float()
            keep = w[:, :, c * CHUNK:(c + 1) * CHUNK, None].float() > 0
            m = torch.where(keep, h, torch.zeros_like(h)).amax(dim=2)  # ReLU outputs are >= 0
            pooled = m if pooled is None else torch.maximum(pooled, m)
            del h
        out.append(pooled)
    return torch.cat(out, dim=-1)


def pack_mlp(mlp1, mlp2):
    """Both scales' weights as ``pe_mlp_pool_cuda`` reads them: transposed to
    (out, in), K zero-padded and rows padded as the kernel keeps them in
    shared memory, bf16; and the biases, float32. Made once per set of
    weights by the caller (``FinePositionalEncoding``), not per forward."""
    _check_weights(mlp1, mlp2)
    device = mlp1[0][0].device
    blocks = []
    for Ws, _ in (mlp1, mlp2):
        for W, kpad in zip(Ws, _K_PAD):
            cin, cout = W.shape
            Wt = torch.zeros((cout, kpad + _ROW_PAD), dtype=torch.float32, device=device)
            Wt[:, :cin] = W.float().t()
            blocks.append(Wt.reshape(-1))
    bias = torch.cat([b.float() for _, bs in (mlp1, mlp2) for b in bs]).to(device)
    return torch.cat(blocks).to(torch.bfloat16).contiguous(), bias.contiguous()


def _check_packed(packed):
    wpack, bpack = packed
    if (wpack.numel(), wpack.dtype, bpack.numel(), bpack.dtype) != (
            2 * _PACKED_PER_SCALE, torch.bfloat16, 2 * sum(_MLP_DIMS), torch.float32):
        raise ValueError(f"packed must be pack_mlp's output, got {wpack.numel()} {wpack.dtype} and "
                         f"{bpack.numel()} {bpack.dtype} values")
    return wpack, bpack


def pe_mlp_pool_cuda(chans, w1, w2, total2, packed) -> torch.Tensor:
    """The MLP and pool on the card (``csrc/pe_mlp_pool.cu``): one warp per
    point, mma.sync bf16 tensor-core products chained in registers.
    ``packed`` is both scales' ``pack_mlp``."""
    _check_mlp(chans, w1, w2, total2)
    wpack, bpack = _check_packed(packed)
    _check_cuda("pe_mlp_pool_cuda", (chans, w1, w2, total2, wpack, bpack))
    B, P, S2, _ = chans.shape
    if chans.dtype != torch.bfloat16:
        raise ValueError(f"pe_mlp_pool_cuda takes bf16 channels, got {chans.dtype}")
    chans, total2 = chans.contiguous(), total2.to(torch.int32).contiguous()
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    out = torch.empty((B, P, 256), dtype=torch.float32, device=chans.device)
    lib = build.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(chans.device):
        err = lib.unopose_pe_mlp_pool(
            *(ptr(t.data_ptr()) for t in (chans, w1, w2, total2, wpack, bpack, out)),
            B * P, S2, ptr(build.stream_of(chans)),
        )
    build.check(err, "pe_mlp_pool")
    LAUNCHES["pe_mlp_pool"] += 1
    return out


def pe_mlp_pool(chans, w1, w2, total2, mlp1, mlp2, packed) -> torch.Tensor:
    """(B, P, 256) float32 pooled features, dispatched by device: the plain
    version reads ``mlp1``/``mlp2``, the kernel their ``pack_mlp``
    (``packed``, may be None on the CPU)."""
    if chans.device.type == "cpu":
        return pe_mlp_pool_plain(chans, w1, w2, total2, mlp1, mlp2)
    return pe_mlp_pool_cuda(chans, w1, w2, total2, packed)


def pe_fused_v5(planes, idx_p, w1, w2, total2, center, w1_mlp, b1_mlp, w2_mlp, b2_mlp, r1: float, r2: float,
                packed):
    """PE-v5 on the index grouping: channels, then the chunked MLP and masked
    max. Returns (B, P, 256) float32 features ahead of the PE's output Dense.
    ``packed``: the weights' ``pack_mlp`` for the MLP kernel (None on the CPU)."""
    chans = pe_channels(planes, idx_p, w1, w2, total2, center, r1, r2)
    return pe_mlp_pool(chans, w1, w2, total2, (w1_mlp, b1_mlp), (w2_mlp, b2_mlp), packed)


def _check_masked(grouped1, mask1, grouped2, mask2, center):
    B, P = center[0].shape
    if any(c.shape != (B, P) for c in center):
        raise ValueError("centres must be three (B, P) planes")
    for grouped, mask in ((grouped1, mask1), (grouped2, mask2)):
        S = mask.shape[-1]
        if mask.shape != (B, P, S) or any(g.shape != (B, P, S) for g in grouped):
            raise ValueError(f"each scale's planes and mask must be (B, P, S) with centres (B, P) = {(B, P)}, got "
                             f"{[tuple(g.shape) for g in grouped]} and {tuple(mask.shape)}")
        if not 0 < S <= 256:
            raise ValueError(f"S must be in 1..256, got {S}")


def _masked_scale_plain(center, grouped, mask, r: float, Ws, bs) -> torch.Tensor:
    """One scale of ``pe_fused_masked_plain``: (B, P, 128) float32."""
    rel = [g.float() - c.float()[..., None] for g, c in zip(grouped, center)]
    lrf = batch_lrf_planar(center, grouped, r, mask=mask, use_newton=True)
    chans = torch.stack([*rel, *lrf], dim=-1).to(torch.bfloat16)  # (B, P, S, 6)
    keep = mask[..., None].float()
    Wb = [W.to(torch.bfloat16).float() for W in Ws]
    pooled = None
    for c in range(0, chans.shape[2], CHUNK):  # 64-slot chunks bound the activations' memory
        h = chans[:, :, c:c + CHUNK].float()
        for W, b in zip(Wb, bs):
            h = torch.relu(torch.matmul(h, W) + b.float()).to(torch.bfloat16).float()
        m = (h * keep[:, :, c:c + CHUNK]).amax(dim=2)  # ReLU outputs are >= 0
        pooled = m if pooled is None else torch.maximum(pooled, m)
    return pooled


def pe_fused_masked_plain(grouped1, mask1, grouped2, mask2, center, mlp1, mlp2, r1: float, r2: float) -> torch.Tensor:
    """Plain twin of the masked PE: scale 1's planes (three (B, P, S1)) and
    bool mask, scale 2's, the centres (three (B, P)) and each scale's folded
    (Ws, bs) -> (B, P, 256) float32 (see module docstring)."""
    _check_masked(grouped1, mask1, grouped2, mask2, center)
    _check_weights(mlp1, mlp2)
    f1 = _masked_scale_plain(center, grouped1, mask1, r1, *mlp1)
    f2 = _masked_scale_plain(center, grouped2, mask2, r2, *mlp2)
    return torch.cat([f1, f2], dim=-1)


def pe_fused_masked_cuda(grouped1, mask1, grouped2, mask2, center, r1: float, r2: float, packed) -> torch.Tensor:
    """The masked PE on the card (``csrc/pe_masked.cu``): one warp per point,
    the LRF on the lanes, the MLP on mma.sync bf16 tiles staged in shared
    memory. ``packed`` is both scales' ``pack_mlp``."""
    _check_masked(grouped1, mask1, grouped2, mask2, center)
    wpack, bpack = _check_packed(packed)
    _check_cuda("pe_fused_masked_cuda", (*grouped1, mask1, *grouped2, mask2, *center, wpack, bpack))
    B, P = center[0].shape
    S1, S2 = mask1.shape[-1], mask2.shape[-1]
    g1 = [g.float().contiguous() for g in grouped1]
    g2 = [g.float().contiguous() for g in grouped2]
    m1, m2 = (m.to(torch.bool).contiguous() for m in (mask1, mask2))
    cx, cy, cz = (c.float().contiguous() for c in center)
    out = torch.empty((B, P, 256), dtype=torch.float32, device=cx.device)
    lib = build.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(cx.device):
        err = lib.unopose_pe_masked(
            *(ptr(t.data_ptr()) for t in (*g1, m1, *g2, m2, cx, cy, cz, wpack, bpack, out)),
            B * P, S1, S2, float(r1), float(r2), float(1.0 / r1), float(1.0 / r2), ptr(build.stream_of(cx)),
        )
    build.check(err, "pe_masked")
    LAUNCHES["pe_masked"] += 1
    return out


def pe_fused_masked(grouped1, mask1, grouped2, mask2, center, mlp1, mlp2, r1: float, r2: float,
                    packed) -> torch.Tensor:
    """(B, P, 256) float32 features of the masked PE, dispatched by device:
    the plain version reads ``mlp1``/``mlp2``, the kernel their ``pack_mlp``
    (``packed``, may be None on the CPU)."""
    if mask1.device.type == "cpu":
        return pe_fused_masked_plain(grouped1, mask1, grouped2, mask2, center, mlp1, mlp2, r1, r2)
    return pe_fused_masked_cuda(grouped1, mask1, grouped2, mask2, center, r1, r2, packed)
