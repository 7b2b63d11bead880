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

The packed first_k PE in the JAX package's other layouts, each behind the
switch its routing reads (``models/matching.py``), each dispatched by device:

- ``pe_fused_packed`` (row 10, ``pe_fused_packed``): point-major on the
  materialised slots (B, P, S2). A block of 64 points whose hit counts all
  fit S2 / 2 takes the fast path: the first S2 / 2 slots, each scale's LRF
  weighted by its multiset weights and its max masked by weight > 0.
  Otherwise scale 1 as on the fast path over all S2 slots and scale 2 with
  an unweighted LRF over all S2 slots (the pads are materialised
  duplicates) and an unmasked max. Kernel ``kernels/csrc/pe_packed.cu``.
- ``pe_channels_packed`` (plain PyTorch, as XLA in the JAX package) and
  ``pe_mlp_pool_packed`` (row 13): the 12 channels with scale 1 zeroed
  where w1 = 0 and the acos-form LRF, in four (B, 12, P, S2 / 4) chunks;
  then the MLP, whose last ReLU output stays float32, and the unmasked max
  over the first clip(ceil(bmax / w), 1, 4) chunks of each 64-point block.
  Kernel ``kernels/csrc/pe_mlp_pool_packed.cu``.
- ``pe_fused_gather_t`` (row 12): PE-v5's function in one kernel
  (``kernels/csrc/pe_gather_fused.cu``), tiers 64 / 128 / S2 slots per
  128-point block; its plain twin is PE-v5's pair.
- ``pe_fused_packed_t`` (row 11): slot-major (B, S2, P) slots, both
  scales' LRFs weighted over all S2 slots, the MLP over the tier prefix
  (64 / 128 / S2 per 128-point block) and the max masked by weight > 0.
  Kernel ``kernels/csrc/pe_packed_t.cu``.

All four take every S2 the JAX package's gates admit, a multiple of 256 up
to the cloud's N (at most ``MAX_SLOTS_PACKED``), and raise on any other; past
512 slots the kernels walk a point's slots in windows of 512. The JAX kernels' block-diagonal scale packing adds exact
zeros on the TPU's matrix unit and is not reproduced: each scale runs its
own MLP.
"""

from __future__ import annotations

import ctypes

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.lrf import batch_lrf_planar

CHUNK = 64  # slots per MLP chunk
MAX_SLOTS = 256  # the PE-v5 kernels K5, K6 and the masked PE K16 (pe_common.cuh:kMaxSlots)
MAX_SLOTS_PACKED = 4096  # K19-K22 and the plain versions, S2 <= N <= 4096 (pe_common.cuh:kMaxSlotsPacked)
_K_PAD = (16, 32, 64)  # the kernel's K of each layer (layer 1: 6 channels zero-padded)
_ROW_PAD = 8  # bf16 per weight row of padding in the kernel's shared memory
_MLP_DIMS = (32, 64, 128)
_PACKED_PER_SCALE = sum(d * (k + _ROW_PAD) for d, k in zip(_MLP_DIMS, _K_PAD))


def chunks_needed(total2: torch.Tensor, s2: int) -> torch.Tensor:
    """64-slot chunks each point's neighbourhood needs: ceil(total2 / 64), in [1, s2 / 64]."""
    return torch.clamp((total2 + CHUNK - 1) // CHUNK, 1, s2 // CHUNK)


def _check(planes, idx_p, w1, w2, total2, center, max_slots: int = MAX_SLOTS_PACKED):
    B, N = planes[0].shape
    if any(p.shape != (B, N) for p in planes) or any(c.shape != idx_p.shape[:2] for c in center):
        raise ValueError("planes must be (B, N) and centres (B, P)")
    _, P, S2 = idx_p.shape
    if idx_p.shape[0] != B or w1.shape != idx_p.shape or w2.shape != idx_p.shape or total2.shape != (B, P):
        raise ValueError(f"idx_p, w1, w2 must be (B, P, S2) and total2 (B, P), got {tuple(idx_p.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(total2.shape)}")
    if S2 % CHUNK or not 0 < S2 <= max_slots:
        raise ValueError(f"S2 must be a multiple of {CHUNK} up to {max_slots}, got {S2}")


def _channels_plain(g, w1, w2, center, r1: float, r2: float) -> torch.Tensor:
    """(B, P, S2, 12) bf16 channels of the slots g (three (B, P, S2) planes)."""
    rel = [gi.float() - c.float()[..., None] for gi, c in zip(g, center)]
    l1 = batch_lrf_planar(center, g, r1, mask=w1.float(), use_newton=True)
    l2 = batch_lrf_planar(center, g, r2, mask=w2.float(), use_newton=True)
    return torch.stack([*rel, *l1, *rel, *l2], dim=-1).to(torch.bfloat16)


def pe_channels_plain(planes, idx_p, w1, w2, total2, center, r1: float, r2: float) -> torch.Tensor:
    """(B, P, S2, 12) bf16 channels of every slot (see module docstring)."""
    _check(planes, idx_p, w1, w2, total2, center)
    B, P, S2 = idx_p.shape
    flat = idx_p.reshape(B, -1).long()
    g = tuple(torch.gather(p.float(), 1, flat).reshape(B, P, S2) for p in planes)
    return _channels_plain(g, w1, w2, center, r1, r2)


def _check_cuda(name, tensors):
    dev = tensors[0].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{name} needs all tensors on one CUDA device")


def pe_channels_cuda(planes, idx_p, w1, w2, total2, center, r1: float, r2: float) -> torch.Tensor:
    """The channels on the card (``csrc/pe_channels.cu``): a warp per 16 points.
    Slots past a point's 64 * ceil(total2 / 64) are left unwritten."""
    _check(planes, idx_p, w1, w2, total2, center, MAX_SLOTS)
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


def _check_mlp(chans, w1, w2, total2, max_slots: int = MAX_SLOTS_PACKED):
    B, P, S2, C = chans.shape
    if C != 12 or w1.shape != (B, P, S2) or w2.shape != (B, P, S2) or total2.shape != (B, P):
        raise ValueError(f"chans must be (B, P, S2, 12) with w1, w2 (B, P, S2) and total2 (B, P), got "
                         f"{tuple(chans.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(total2.shape)}")
    if S2 % CHUNK or not 0 < S2 <= max_slots:
        raise ValueError(f"S2 must be a multiple of {CHUNK} up to {max_slots}, got {S2}")


def _check_weights(mlp1, mlp2):
    for Ws, bs in (mlp1, mlp2):
        shapes = [tuple(W.shape) for W in Ws] + [tuple(b.shape) for b in bs]
        if shapes != [(6, 32), (32, 64), (64, 128), (32,), (64,), (128,)]:
            raise ValueError(f"the PE MLP must be 6 -> 32 -> 64 -> 128, got {shapes}")


def _chunked_mlp_max(chans, Ws, bs, keep=None, round_last: bool = True) -> torch.Tensor:
    """(..., S, 6) bf16 channels -> (..., 128) float32: the folded MLP with
    bf16 operands (float32 products of bf16 values), bias + ReLU and a bf16
    cast after each layer (after the last only with ``round_last``), then
    the max over S, of the slots where ``keep`` (..., S) holds if given (a
    multiply after the ReLU, whose outputs are >= 0), in 64-slot chunks to
    bound the activations' memory."""
    Wb = [W.to(torch.bfloat16).float() for W in Ws]
    pooled = None
    for c in range(0, chans.shape[-2], CHUNK):
        h = chans[..., c:c + CHUNK, :].float()
        for i, (W, b) in enumerate(zip(Wb, bs)):
            h = torch.relu(torch.matmul(h, W) + b.float())
            if round_last or i < len(Wb) - 1:
                h = h.to(torch.bfloat16).float()
        if keep is not None:
            h = torch.where(keep[..., c:c + CHUNK, None], h, torch.zeros_like(h))
        m = h.amax(dim=-2)
        pooled = m if pooled is None else torch.maximum(pooled, m)
        del h
    return pooled


def pe_mlp_pool_plain(chans, w1, w2, total2, mlp1, mlp2) -> torch.Tensor:
    """(B, P, S2, 12) bf16 channels -> (B, P, 256) float32 pooled features;
    ``mlp1``/``mlp2`` are each scale's folded (Ws, bs)."""
    _check_mlp(chans, w1, w2, total2)
    _check_weights(mlp1, mlp2)
    n = (int(chunks_needed(total2, chans.shape[2]).max()) if total2.numel() else 1) * CHUNK
    return torch.cat([_chunked_mlp_max(chans[:, :, :n, 6 * sc:6 * sc + 6], *mlp, keep=w[:, :, :n].float() > 0)
                      for sc, (mlp, w) in enumerate(((mlp1, w1), (mlp2, w2)))], dim=-1)


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
    """The MLP and pool on the card (``csrc/pe_mlp_pool.cu``): a warp takes
    a point's 64-slot chunks one at a time, packs each scale's kept slots
    to the front and runs mma.sync bf16 tensor-core products on them only,
    chained in registers, the max taken on the raw last-layer sums.
    ``packed`` is both scales' ``pack_mlp``."""
    _check_mlp(chans, w1, w2, total2, MAX_SLOTS)
    wpack, bpack = _check_packed(packed)
    _check_cuda("pe_mlp_pool_cuda", (chans, w1, w2, total2, wpack, bpack))
    B, P, S2, _ = chans.shape
    if chans.dtype != torch.bfloat16:
        raise ValueError(f"pe_mlp_pool_cuda takes bf16 channels, got {chans.dtype}")
    chans, total2 = chans.contiguous(), total2.to(torch.int32).contiguous()
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    if chans.data_ptr() % 4:
        raise ValueError("pe_mlp_pool_cuda reads the channels in 4-byte words: a 4-byte aligned tensor needed")
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


def _scale_plain(center, grouped, r: float, Ws, bs, lrf_w=None, keep=None) -> torch.Tensor:
    """One scale of the fused PE's plain versions: the LRF over the slots
    weighted by ``lrf_w`` (unweighted if None), the six channels rounded to
    bf16, the MLP and the max over the slots where ``keep`` holds (all if
    None): (B, P, 128) float32."""
    rel = [g.float() - c.float()[..., None] for g, c in zip(grouped, center)]
    lrf = batch_lrf_planar(center, grouped, r, mask=lrf_w, use_newton=True)
    chans = torch.stack([*rel, *lrf], dim=-1).to(torch.bfloat16)  # (B, P, S, 6)
    return _chunked_mlp_max(chans, Ws, bs, keep=keep)


def pe_fused_masked_plain(grouped1, mask1, grouped2, mask2, center, mlp1, mlp2, r1: float, r2: float) -> torch.Tensor:
    """Plain twin of the masked PE: scale 1's planes (three (B, P, S1)) and
    bool mask, scale 2's, the centres (three (B, P)) and each scale's folded
    (Ws, bs) -> (B, P, 256) float32 (see module docstring)."""
    _check_masked(grouped1, mask1, grouped2, mask2, center)
    _check_weights(mlp1, mlp2)
    f1 = _scale_plain(center, grouped1, r1, *mlp1, lrf_w=mask1, keep=mask1.bool())
    f2 = _scale_plain(center, grouped2, r2, *mlp2, lrf_w=mask2, keep=mask2.bool())
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


# ------------------------------------------------------------------ the packed PE in the JAX package's other layouts
def _check_packed_s2(S2: int, N: int):
    if S2 % 256 or not 0 < S2 <= min(N, MAX_SLOTS_PACKED):
        raise ValueError(f"the packed PE takes S2 a multiple of 256 up to the cloud's N = {N} (at most "
                         f"{MAX_SLOTS_PACKED}), got {S2}")


def block_max(total2: torch.Tensor, block: int) -> torch.Tensor:
    """(B, P) hit counts -> (B, P): the largest count of each point's block of ``block`` points."""
    B, P = total2.shape
    if P % block:
        raise ValueError(f"P must be a multiple of {block}, got {P}")
    return total2.view(B, P // block, block).amax(-1).repeat_interleave(block, dim=1)


def _check_grouped(grouped2, w1, w2, total2, center, block: int, slot_major: bool = False):
    B, P = total2.shape
    shape = (B, grouped2[0].shape[1], P) if slot_major else (B, P, grouped2[0].shape[-1])
    if any(tuple(t.shape) != shape for t in (*grouped2, w1, w2)) or any(c.shape != (B, P) for c in center):
        raise ValueError(f"the slots and weights must be {shape} with total2 and the centres (B, P) = {(B, P)}, got "
                         f"{[tuple(t.shape) for t in (*grouped2, w1, w2)]}")
    _check_packed_s2(shape[1] if slot_major else shape[2], P)
    if P % block:
        raise ValueError(f"P must be a multiple of {block}, got {P}")


def _packed_weights(packed, name: str, tensors):
    wpack, bpack = _check_packed(packed)
    _check_cuda(name, (*tensors, wpack, bpack))
    return wpack, bpack


def pe_fused_packed_plain(grouped2, w1, w2, total2, center, mlp1, mlp2, r1: float, r2: float) -> torch.Tensor:
    """Plain twin of row 10: (B, P, S2) slots, weights and (B, P) hit counts
    -> (B, P, 256) float32 (see module docstring; P % 64 == 0)."""
    _check_grouped(grouped2, w1, w2, total2, center, 64)
    _check_weights(mlp1, mlp2)
    S2 = w1.shape[-1]
    fast = block_max(total2, 64) <= S2 // 2
    out = torch.empty(total2.shape + (256,), dtype=torch.float32, device=total2.device)
    for half, sel in ((True, fast), (False, ~fast)):
        if not bool(sel.any()):
            continue
        n = S2 // 2 if half else S2
        g = tuple(x[sel][None, :, :n].float() for x in grouped2)  # (1, points, n)
        c = tuple(x[sel][None].float() for x in center)
        m1, m2 = (w[sel][None, :, :n].float() for w in (w1, w2))
        f1 = _scale_plain(c, g, r1, *mlp1, lrf_w=m1, keep=m1 > 0)
        f2 = _scale_plain(c, g, r2, *mlp2, lrf_w=m2, keep=m2 > 0) if half else _scale_plain(c, g, r2, *mlp2)
        out[sel] = torch.cat([f1, f2], dim=-1)[0]
    return out


def pe_fused_packed_cuda(grouped2, w1, w2, total2, center, r1: float, r2: float, packed) -> torch.Tensor:
    """Row 10 on the card (``csrc/pe_packed.cu``): a warpgroup per 64-point block, the MLP on wgmma."""
    _check_grouped(grouped2, w1, w2, total2, center, 64)
    tensors = (*grouped2, w1, w2, total2, *center)
    wpack, bpack = _packed_weights(packed, "pe_fused_packed_cuda", tensors)
    B, P, S2 = w1.shape
    g = [x.float().contiguous() for x in grouped2]
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    c = [x.float().contiguous() for x in center]
    out = torch.empty((B, P, 256), dtype=torch.float32, device=w1.device)
    build.launch("pe_packed", "unopose_pe_packed",
                 (*g, w1, w2, total2.to(torch.int32).contiguous(), *c, wpack, bpack, out), B, P, S2,
                 float(r1), float(r2), float(1.0 / r1), float(1.0 / r2))
    return out


def pe_fused_packed(grouped2, w1, w2, total2, center, w1_mlp, b1_mlp, w2_mlp, b2_mlp, r1: float, r2: float,
                    packed) -> torch.Tensor:
    """Row 10, dispatched by device: (B, P, 256) float32 features ahead of
    the PE's output Dense. ``packed``: the weights' ``pack_mlp`` (None on the CPU)."""
    if w1.device.type == "cpu":
        return pe_fused_packed_plain(grouped2, w1, w2, total2, center, (w1_mlp, b1_mlp), (w2_mlp, b2_mlp), r1, r2)
    return pe_fused_packed_cuda(grouped2, w1, w2, total2, center, r1, r2, packed)


def pe_channels_packed(grouped2, w1, w2, center, r1: float, r2: float, nchunks: int = 4):
    """Row 13's channels (``pe_channels_packed`` of the JAX package, XLA
    there, plain PyTorch here on either device): scale 1 = rel xyz and its
    w1-weighted LRF, zeroed where w1 = 0; scale 2 = rel xyz and its
    unweighted LRF over all S2 slots; both LRFs in the acos form. Returns
    (``nchunks`` (B, 12, P, S2 / nchunks) bf16 views of one tensor, their width)."""
    gx, gy, gz = (g.float() for g in grouped2)
    cx, cy, cz = (c.float()[..., None] for c in center)
    rel = (gx - cx, gy - cy, gz - cz)
    l1 = batch_lrf_planar(center, grouped2, r1, mask=w1)
    l2 = batch_lrf_planar(center, grouped2, r2, mask=None)
    m1 = (w1 > 0).float()
    chans = torch.stack([*(r * m1 for r in rel), *(l * m1 for l in l1), *rel, *l2], dim=1).to(torch.bfloat16)
    w = chans.shape[-1] // nchunks
    return [chans[..., c * w:(c + 1) * w] for c in range(nchunks)], w


def _check_chunks(chunks, total2):
    if len(chunks) != 4:
        raise ValueError(f"the packed MLP/pool takes 4 chunks, got {len(chunks)}")
    B, C, P, w = chunks[0].shape
    if C != 12 or any(tuple(c.shape) != (B, 12, P, w) for c in chunks) or total2.shape != (B, P):
        raise ValueError(f"chunks must be four (B, 12, P, w) and total2 (B, P), got "
                         f"{[tuple(c.shape) for c in chunks]}, {tuple(total2.shape)}")
    _check_packed_s2(4 * w, P)
    if P % 64:
        raise ValueError(f"P must be a multiple of 64, got {P}")


def chunk_tiers(total2: torch.Tensor, w: int) -> torch.Tensor:
    """Row 13's chunks per point: clip(ceil(bmax / w), 1, 4) of its 64-point block."""
    return torch.clamp((block_max(total2, 64) + w - 1) // w, 1, 4)


def pe_mlp_pool_packed_plain(chunks, total2, mlp1, mlp2) -> torch.Tensor:
    """Plain twin of row 13: four (B, 12, P, w) bf16 chunks -> (B, P, 256)
    float32, the MLP's last ReLU output in float32 and the unmasked max over
    each point's first ``chunk_tiers`` chunks."""
    _check_chunks(chunks, total2)
    _check_weights(mlp1, mlp2)
    tiers = chunk_tiers(total2, chunks[0].shape[-1])
    pooled = None
    for c, chunk in enumerate(chunks):
        m = torch.cat([_chunked_mlp_max(chunk[:, 6 * sc:6 * sc + 6].permute(0, 2, 3, 1), *mlp, round_last=False)
                       for sc, mlp in enumerate((mlp1, mlp2))], dim=-1)
        pooled = m if pooled is None else torch.where((tiers > c)[..., None], torch.maximum(pooled, m), pooled)
    return pooled


def pe_mlp_pool_packed_cuda(chunks, total2, packed) -> torch.Tensor:
    """Row 13 on the card (``csrc/pe_mlp_pool_packed.cu``): one warp per
    point. The chunks are read in place when they are the views
    ``pe_channels_packed`` returns, or four contiguous tensors."""
    _check_chunks(chunks, total2)
    wpack, bpack = _packed_weights(packed, "pe_mlp_pool_packed_cuda", (*chunks, total2))
    B, _, P, w = chunks[0].shape
    if any(c.dtype != torch.bfloat16 for c in chunks):
        raise ValueError("pe_mlp_pool_packed_cuda takes bf16 chunks")
    ld = chunks[0].stride(2)
    if any(c.stride() != (12 * P * ld, P * ld, ld, 1) for c in chunks):
        chunks, ld = [c.contiguous() for c in chunks], w
    out = torch.empty((B, P, 256), dtype=torch.float32, device=total2.device)
    build.launch("pe_mlp_pool_packed", "unopose_pe_mlp_pool_packed",
                 (*chunks, total2.to(torch.int32).contiguous(), wpack, bpack, out), B, P, w, ld)
    return out


def pe_mlp_pool_packed(chunks, total2, w1_mlp, b1_mlp, w2_mlp, b2_mlp, packed) -> torch.Tensor:
    """Row 13's MLP and pool, dispatched by device (``packed`` may be None on the CPU)."""
    if total2.device.type == "cpu":
        return pe_mlp_pool_packed_plain(chunks, total2, (w1_mlp, b1_mlp), (w2_mlp, b2_mlp))
    return pe_mlp_pool_packed_cuda(chunks, total2, packed)


def slot_tiers(total2: torch.Tensor, s2: int) -> torch.Tensor:
    """Rows 11 and 12's slots per point: 64, 128 or all s2, the least that
    holds every hit of its 128-point block."""
    bmax = block_max(total2, 128)
    return torch.where(bmax <= 64, 64, torch.where(bmax <= 128, 128, s2))


def pe_fused_gather_t_cuda(planes, idx_p, w1, w2, total2, center, r1: float, r2: float, packed) -> torch.Tensor:
    """Row 12 on the card (``csrc/pe_gather_fused.cu``): PE-v5's channels and
    MLP/pool in one launch, one warp per point, the channels in shared memory."""
    _check(planes, idx_p, w1, w2, total2, center)
    B, N = planes[0].shape
    _, P, S2 = idx_p.shape
    _check_packed_s2(S2, N)
    if P % 128 or N > 4096 or idx_p.dtype != torch.int16:
        raise ValueError(f"pe_fused_gather_t_cuda takes P % 128 == 0, N <= 4096 and int16 indices "
                         f"(P={P}, N={N}, {idx_p.dtype})")
    tensors = (*planes, idx_p, w1, w2, total2, *center)
    wpack, bpack = _packed_weights(packed, "pe_fused_gather_t_cuda", tensors)
    xp, yp, zp = (p.float().contiguous() for p in planes)
    c = [x.float().contiguous() for x in center]
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    out = torch.empty((B, P, 256), dtype=torch.float32, device=xp.device)
    build.launch("pe_gather_fused", "unopose_pe_gather_fused",
                 (xp, yp, zp, idx_p.contiguous(), w1, w2, total2.to(torch.int32).contiguous(), *c, wpack, bpack, out),
                 B, N, P, S2, float(r1), float(r2), float(1.0 / r1), float(1.0 / r2))
    return out


def pe_fused_gather_t_plain(planes, idx_p, w1, w2, total2, center, mlp1, mlp2, r1: float, r2: float) -> torch.Tensor:
    """Plain twin of row 12: PE-v5's plain pair (the same function) at any packed S2."""
    _check_packed_s2(idx_p.shape[-1], planes[0].shape[-1])
    chans = pe_channels_plain(planes, idx_p, w1, w2, total2, center, r1, r2)
    return pe_mlp_pool_plain(chans, w1, w2, total2, mlp1, mlp2)


def pe_fused_gather_t(planes, idx_p, w1, w2, total2, center, w1_mlp, b1_mlp, w2_mlp, b2_mlp, r1: float, r2: float,
                      packed) -> torch.Tensor:
    """Row 12 (PE-v4) on the index grouping, dispatched by device (``packed`` may be None on the CPU)."""
    if planes[0].device.type == "cpu":
        return pe_fused_gather_t_plain(planes, idx_p, w1, w2, total2, center, (w1_mlp, b1_mlp), (w2_mlp, b2_mlp),
                                       r1, r2)
    return pe_fused_gather_t_cuda(planes, idx_p, w1, w2, total2, center, r1, r2, packed)


def pe_fused_packed_t_plain(grouped2_t, w1_t, w2_t, total2, center, mlp1, mlp2, r1: float, r2: float) -> torch.Tensor:
    """Plain twin of row 11: slot-major (B, S2, P) slots and weights -> (B,
    P, 256) float32. Both LRFs w-weighted over all S2 slots; the MLP and
    masked max over the 64-slot chunks any point needs, which hold every
    weight > 0 (the kernel runs each point's ``slot_tiers`` prefix, whose
    extra slots add only masked zeros)."""
    _check_grouped(grouped2_t, w1_t, w2_t, total2, center, 128, slot_major=True)
    g = tuple(x.transpose(1, 2) for x in grouped2_t)
    w1, w2 = w1_t.transpose(1, 2), w2_t.transpose(1, 2)
    return pe_mlp_pool_plain(_channels_plain(g, w1, w2, center, r1, r2), w1, w2, total2, mlp1, mlp2)


def pe_fused_packed_t_cuda(grouped2_t, w1_t, w2_t, total2, center, r1: float, r2: float, packed) -> torch.Tensor:
    """Row 11 on the card (``csrc/pe_packed_t.cu``): the slot columns of 8
    points at a time staged through shared memory, coalesced over points,
    then one warp per point."""
    _check_grouped(grouped2_t, w1_t, w2_t, total2, center, 128, slot_major=True)
    tensors = (*grouped2_t, w1_t, w2_t, total2, *center)
    wpack, bpack = _packed_weights(packed, "pe_fused_packed_t_cuda", tensors)
    B, S2, P = w1_t.shape
    g = [x.float().contiguous() for x in grouped2_t]
    w1_t, w2_t = (w.to(torch.bfloat16).contiguous() for w in (w1_t, w2_t))
    c = [x.float().contiguous() for x in center]
    out = torch.empty((B, P, 256), dtype=torch.float32, device=w1_t.device)
    build.launch("pe_packed_t", "unopose_pe_packed_t",
                 (*g, w1_t, w2_t, total2.to(torch.int32).contiguous(), *c, wpack, bpack, out),
                 B, P, S2, float(r1), float(r2), float(1.0 / r1), float(1.0 / r2))
    return out


def pe_fused_packed_t(grouped2_t, w1_t, w2_t, total2, center, w1_mlp, b1_mlp, w2_mlp, b2_mlp, r1: float, r2: float,
                      packed) -> torch.Tensor:
    """Row 11, dispatched by device (``packed`` may be None on the CPU)."""
    if w1_t.device.type == "cpu":
        return pe_fused_packed_t_plain(grouped2_t, w1_t, w2_t, total2, center, (w1_mlp, b1_mlp), (w2_mlp, b2_mlp),
                                       r1, r2)
    return pe_fused_packed_t_cuda(grouped2_t, w1_t, w2_t, total2, center, r1, r2, packed)
