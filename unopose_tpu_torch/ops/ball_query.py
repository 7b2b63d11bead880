"""Neighbour grouping for the fine PE (counterpart of
``unopose_tpu/ops/ball_query.py``): first_k, and the subset mode.

Reference semantics (the CUDA ball query of the original model): around
every point, each scale keeps the first <= k in-radius points by original
index and pads the remaining slots with the first hit. The packed
inference path reproduces that as multisets: the candidates are scanned in
a fixed permuted order in ``CHUNKS`` chunks, each keeping at most
k2 / CHUNKS hits, the kept hits are packed left, and scale 1 becomes
per-slot weights on scale 2's slots. Any budget overflow is detected
exactly and the caller falls back to ``two_scale_group_exact_planar``.

``first_k_select`` dispatches on device: CPU tensors take the plain
``first_k_select_plain``, which mirrors the XLA branch of the JAX
``_first_k_budget_select`` (slot order included); CUDA tensors take the
kernel ``kernels/csrc/first_k_select.cu``, which replaces the TPU pair
``_first_k_keys_pallas`` (int8-mask mode) + ``_compact_stage_pallas``.
The two produce the same outputs bit for bit: both compute
d2 = (cn - 2 xy) + pn elementwise in one fixed order (``sqdist_expansion``).

Subset mode (``ball_group_planar(mode="subset")``, ``ball_group_subset``):
the cloud in the fixed permuted order is cut into G = N / S candidates per
slot (permuted column g * S + s is slot s's candidate g), and each slot
takes its first candidate strictly inside the radius. ``ball_group_subset``
dispatches on device: the plain ``ball_group_subset_plain`` on CPU tensors,
the kernel ``kernels/csrc/ball_group_subset.cu`` (which replaces the TPU
kernel ``ball_group_subset_pallas``) on CUDA tensors; both compute the
distance by direct differences as the TPU kernel does, contracted into
fused multiply-adds as XLA compiles it (``subset_sqdist``), and agree bit for
bit with each other and with the JAX kernel in interpret mode.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.gather import gather_planar
from unopose_tpu_torch.ops.geometry import pairwise_sqdist

PERM_SEED = 20240613  # the fixed decorrelating permutation of the JAX package
CHUNKS = 4  # the JAX package's chunk count; fixed in the kernel too
SELECT_KEYS = ("idx_p", "validslot", "m1slot", "cnt1", "enc1", "total2", "q_first", "overflow")


def sqdist_expansion(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, P, 3) x (B, N, 3) -> (B, P, N) squared distances as
    (cn - 2 xy) + pn, each dot product summed left to right, one rounded
    elementwise op at a time (the same on CPU and GPU, and in the kernel)."""
    a = a.float()
    b = b.float()
    ax, ay, az = (t[..., :, None] for t in a.unbind(-1))
    bx, by, bz = (t[..., None, :] for t in b.unbind(-1))
    cn = ax * ax + ay * ay + az * az
    pn = bx * bx + by * by + bz * bz
    xy = ax * bx + ay * by + az * bz
    return cn - 2.0 * xy + pn


def first_k_in_radius(mask: torch.Tensor, nsample: int) -> torch.Tensor:
    """First ``nsample`` True positions per row of a (..., N) mask in index
    order, padded with the first True position (0 for all-False rows). With
    ``nsample > N`` the slots past N are pads, as in the reference's ball
    query."""
    N = mask.shape[-1]
    iota = torch.arange(N, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, 2 * N - iota, N - iota)  # unique keys: a plain top-k is exact
    top = torch.topk(key, min(nsample, N), dim=-1, sorted=True).values
    idx = torch.where(top > N, 2 * N - top, N - top)
    if nsample > N:
        idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], nsample - N)], dim=-1)
    cnt = mask.sum(dim=-1, dtype=torch.int32)[..., None]
    slot = torch.arange(nsample, dtype=torch.int32, device=mask.device)
    first = torch.where(cnt > 0, idx[..., :1], torch.zeros_like(idx[..., :1]))
    return torch.where(slot < cnt, idx, first).to(torch.int32)


def _check_select(pts, pts_p, r1, k1, r2, k2):
    B, N, _ = pts.shape
    if pts_p.shape != pts.shape:
        raise ValueError(f"pts_p {tuple(pts_p.shape)} != pts {tuple(pts.shape)}")
    if not (N % CHUNKS == 0 and k2 % CHUNKS == 0 and r1 < r2 and k1 <= k2 and N <= 4096):
        raise ValueError(f"unsupported first_k select: N={N} k1={k1} k2={k2} r1={r1} r2={r2}")
    if k2 > N:
        raise ValueError(f"the chunked budget select needs N >= k2 (N={N}, k2={k2})")


def first_k_select_plain(pts, pts_p, perm, inv_perm, r1: float, k1: int, r2: float, k2: int):
    """Plain PyTorch select (the XLA branch of the JAX ``_first_k_budget_select``
    with ``global_compact=True``). pts (B, N, 3) centres, pts_p the same
    cloud in permuted order. Returns the dict of ``SELECT_KEYS``."""
    _check_select(pts, pts_p, r1, k1, r2, k2)
    B, N, _ = pts.shape
    C, W, budget = CHUNKS, N // CHUNKS, k2 // CHUNKS
    dev = pts.device
    d2 = sqdist_expansion(pts, pts_p)  # columns in permuted order
    mask2 = d2 < r2 * r2
    mask1 = d2 < r1 * r1
    del d2

    ccnt = mask2.view(B, N, C, W).sum(dim=-1, dtype=torch.int32)
    total2 = ccnt.sum(dim=-1, dtype=torch.int32)
    cnt1 = mask1.sum(dim=-1, dtype=torch.int32)
    permb = perm.to(torch.int32).view(1, 1, N)
    posb = torch.arange(N, dtype=torch.int32, device=dev).view(1, 1, N)
    first2_orig = torch.where(mask2, permb, N).amin(dim=-1)
    enc1 = torch.where(mask1, permb * 4096 + posb, N * 4096).amin(dim=-1)

    # per chunk: r1 hits, then r2-only hits, each by ascending position
    wiota = torch.arange(W, dtype=torch.int32, device=dev)
    key = W - wiota + torch.where(mask2.view(B, N, C, W), 2 * W, 0) + torch.where(mask1.view(B, N, C, W), 4 * W, 0)
    top = torch.topk(key, budget, dim=-1, sorted=True).values  # unique keys within a chunk
    m1slot = top > 4 * W
    validslot = top > 2 * W
    w = W - (top - torch.where(validslot, 2 * W, 0) - torch.where(m1slot, 4 * W, 0))
    idx_p = (torch.arange(C, dtype=torch.int32, device=dev).view(1, 1, C, 1) * W + w).reshape(B, N, k2)
    validslot = validslot.reshape(B, N, k2)
    m1slot = m1slot.reshape(B, N, k2)
    # stable left compaction of the kept hits across chunks
    order = torch.argsort((~validslot).to(torch.int32), dim=-1, stable=True)
    idx_p = torch.take_along_dim(idx_p, order, dim=-1)
    m1slot = torch.take_along_dim(m1slot, order, dim=-1)
    validslot = torch.take_along_dim(validslot, order, dim=-1)

    q_first = inv_perm.to(torch.int32)[torch.where(total2 > 0, first2_orig, 0).long()]
    idx_p = torch.where(validslot, idx_p, q_first[..., None]).to(torch.int16)
    overflow = (ccnt > budget).any() | (total2 > k2).any() | (cnt1 > k1).any()
    return dict(
        idx_p=idx_p, validslot=validslot, m1slot=m1slot, cnt1=cnt1, enc1=enc1,
        total2=total2, q_first=q_first, overflow=overflow,
    )


def first_k_select_cuda(pts, pts_p, perm, inv_perm, r1: float, k1: int, r2: float, k2: int):
    """The select on the card (``csrc/first_k_select.cu``), one warp per
    centre row; any N % 4 == 0 up to 4096 with k2 <= N, as the plain select."""
    _check_select(pts, pts_p, r1, k1, r2, k2)
    tensors = (pts, pts_p, perm, inv_perm)
    if any(t.device.type != "cuda" or t.device != pts.device for t in tensors):
        raise ValueError("first_k_select_cuda needs all tensors on one CUDA device")
    B, N, _ = pts.shape
    pts, pts_p = pts.float().contiguous(), pts_p.float().contiguous()
    perm, inv_perm = perm.to(torch.int32).contiguous(), inv_perm.to(torch.int32).contiguous()
    dev = pts.device
    out = dict(
        idx_p=torch.empty((B, N, k2), dtype=torch.int16, device=dev),
        validslot=torch.empty((B, N, k2), dtype=torch.bool, device=dev),
        m1slot=torch.empty((B, N, k2), dtype=torch.bool, device=dev),
        cnt1=torch.empty((B, N), dtype=torch.int32, device=dev),
        enc1=torch.empty((B, N), dtype=torch.int32, device=dev),
        total2=torch.empty((B, N), dtype=torch.int32, device=dev),
        q_first=torch.empty((B, N), dtype=torch.int32, device=dev),
    )
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = build.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.unopose_first_k_select(
            *(ptr(t.data_ptr()) for t in (pts, pts_p, perm, inv_perm)),
            B, N, k1, k2, float(r1 * r1), float(r2 * r2),
            *(ptr(out[k].data_ptr()) for k in SELECT_KEYS[:-1]),
            ptr(flag.data_ptr()), ptr(build.stream_of(pts)),
        )
    build.check(err, "first_k_select")
    LAUNCHES["first_k_select"] += 1
    out["overflow"] = flag[0] != 0
    return out


def first_k_select(pts, pts_p, perm, inv_perm, r1: float, k1: int, r2: float, k2: int):
    """Chunked-budget first_k select, dispatched by device (see module docstring)."""
    if pts.device.type == "cpu":
        return first_k_select_plain(pts, pts_p, perm, inv_perm, r1, k1, r2, k2)
    return first_k_select_cuda(pts, pts_p, perm, inv_perm, r1, k1, r2, k2)


def permutation(N: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The fixed candidate permutation and its inverse, int32 on ``device``."""
    perm = np.random.default_rng(PERM_SEED).permutation(N).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N, dtype=np.int32)
    return torch.from_numpy(perm).to(device), torch.from_numpy(inv).to(device)


def _select_permuted(r1: float, k1: int, r2: float, k2: int, pts: torch.Tensor):
    """The select dict on the permuted cloud, plus its (xp, yp, zp) planes."""
    pts = pts.float()
    N = pts.shape[1]
    perm, inv_perm = permutation(N, pts.device)
    pts_p = pts.index_select(1, perm.long())
    sel = first_k_select(pts, pts_p, perm, inv_perm, r1, k1, r2, k2)
    sel.update(inv_perm=inv_perm)
    return sel, tuple(t.contiguous() for t in pts_p.unbind(-1))


def first_k_budget_select(r1: float, k1: int, r2: float, k2: int, pts: torch.Tensor):
    """Select plus the scale-2 slot gather (``_first_k_budget_select`` with
    ``global_compact=True``). Returns the select dict plus ``g2`` (three
    (B, N, k2) pad-filled planes) and the permuted planes."""
    sel, (xp, yp, zp) = _select_permuted(r1, k1, r2, k2, pts)
    sel["g2"] = gather_planar(xp, yp, zp, sel["idx_p"])
    sel.update(xp=xp, yp=yp, zp=zp)
    return sel


def packed_multiset_weights(sel, k1: int, k2: int):
    """Per-slot multiset weights (bf16, exact) of both scales on the compacted slots."""
    idx = sel["idx_p"].to(torch.int32)
    first1_pp = sel["enc1"] & 4095  # permuted position of the scan-first r1 hit
    npads1 = (k1 - sel["cnt1"]).float()
    bump = (idx == first1_pp[..., None]).float() * npads1[..., None]
    w1 = torch.where(sel["m1slot"], 1.0 + bump, torch.zeros_like(bump)).to(torch.bfloat16)
    bump2 = (idx == sel["q_first"][..., None]).float() * (k2 - sel["total2"]).float()[..., None]
    w2 = torch.where(sel["validslot"], 1.0 + bump2, torch.zeros_like(bump2)).to(torch.bfloat16)
    return w1, w2


def two_scale_group_first_k_packed(r1: float, k1: int, r2: float, k2: int, pts: torch.Tensor):
    """Packed exact first_k grouping: (g2 planes, w1, w2, total2, overflow).
    On overflow the fast outputs are invalid and the caller must use
    ``two_scale_group_exact_planar``."""
    sel = first_k_budget_select(r1, k1, r2, k2, pts)
    w1, w2 = packed_multiset_weights(sel, k1, k2)
    return sel["g2"], w1, w2, sel["total2"], sel["overflow"]


def two_scale_group_first_k_packed_idx(r1: float, k1: int, r2: float, k2: int, pts: torch.Tensor):
    """``two_scale_group_first_k_packed`` without the slot gather, for the
    fused PE (``ops/pe_fused.py``), which gathers in its own kernel:
    ((xp, yp, zp) permuted (B, N) planes, idx_p (B, N, k2) int16 pad-filled
    permuted slot positions, w1, w2, total2, overflow)."""
    sel, planes = _select_permuted(r1, k1, r2, k2, pts)
    w1, w2 = packed_multiset_weights(sel, k1, k2)
    return planes, sel["idx_p"], w1, w2, sel["total2"], sel["overflow"]


def two_scale_group_first_k_fast(r1: float, k1: int, r2: float, k2: int, pts: torch.Tensor):
    """The train path's exact first_k grouping (``two_scale_group_first_k_fast``
    of the JAX package): scale 2's pad-filled slots from the chunked select
    and the gather, scale 1 sorted out of them (its r1 hits, which are a
    subset of scale 2's kept hits when nothing overflows, then pads of the
    r1 hit with the smallest original index). On overflow the exact two-sort
    grouping runs instead (a host branch on the overflow flag).

    The select writes its slots globally compacted; the JAX package's train
    path keeps the per-chunk order. Each neighbourhood's multiset of points
    is the same, and the PE is invariant to the slot order.

    Returns ((g1x, g1y, g1z) each (B, N, k1), (g2x, g2y, g2z) each (B, N, k2))."""
    pts = pts.float()
    sel = first_k_budget_select(r1, k1, r2, k2, pts)
    if bool(sel["overflow"].item()):
        return two_scale_group_exact_planar(r1, k1, r2, k2, pts)
    g2 = sel["g2"]
    siota = torch.arange(k2, dtype=torch.int32, device=pts.device)
    key1 = torch.where(sel["m1slot"], 2 * k2 - siota, k2 - siota)  # r1 hits first, each in slot order
    top, order = torch.topk(key1, k1, dim=-1, sorted=True)
    valid1 = top > k2
    first1_orig = sel["enc1"] >> 12
    q1 = sel["inv_perm"][torch.where(sel["cnt1"] > 0, first1_orig, 0).long()]
    pads = gather_planar(sel["xp"], sel["yp"], sel["zp"], q1[..., None])
    g1 = tuple(torch.where(valid1, torch.gather(g, -1, order), p) for g, p in zip(g2, pads))
    return g1, g2


def two_scale_group_exact_planar(r1: float, k1: int, r2: float, k2: int, pts: torch.Tensor):
    """Exact reference grouping: two independent first-k ball queries of the
    cloud around its own points, padded with the first hit. Returns
    ((g1x, g1y, g1z) each (B, N, k1), (g2x, g2y, g2z) each (B, N, k2))."""
    pts = pts.float()
    x, y, z = (t.contiguous() for t in pts.unbind(-1))
    d2 = sqdist_expansion(pts, pts)
    idx1 = first_k_in_radius(d2 < r1 * r1, k1)
    idx2 = first_k_in_radius(d2 < r2 * r2, k2)
    return gather_planar(x, y, z, idx1), gather_planar(x, y, z, idx2)


def ball_group_planar(radius: float, nsample: int, pts: torch.Tensor, mode: str = "subset"):
    """One ball grouping of the cloud around its own points, plain (the XLA
    path of the JAX ``ball_group_planar``): ((gx, gy, gz) each (B, N, S),
    d2_sel (B, N, S), valid (B, N, S) bool). ``"subset"`` with S | N: slot s
    takes its first in-radius candidate of the permuted columns g * S + s
    (``pairwise_sqdist`` distances); a slot with no hit holds candidate G - 1.
    Otherwise (``"first_k"``, or ``"subset"`` with N % S != 0) the first S
    in-radius points by index, padded with the first hit, valid where the
    slot is below the hit count. Only valid slots are meaningful."""
    pts = pts.float()
    B, N, _ = pts.shape
    x, y, z = (t.contiguous() for t in pts.unbind(-1))
    if mode == "subset" and N % nsample == 0:
        G = N // nsample
        perm, _ = permutation(N, pts.device)
        pts_p = pts.index_select(1, perm.long())
        mask = pairwise_sqdist(pts, pts_p) < radius * radius  # columns in permuted order
        giota = torch.arange(G, dtype=torch.int32, device=pts.device)[:, None]
        g_min = torch.where(mask.view(B, N, G, nsample), giota, G).amin(dim=2)  # (B, N, S)
        valid = g_min < G
        slot = torch.arange(nsample, dtype=torch.int32, device=pts.device)
        idx_p = torch.clamp_max(g_min, G - 1) * nsample + slot
        planes = gather_planar(*(t.contiguous() for t in pts_p.unbind(-1)), idx_p)
    elif mode in ("subset", "first_k"):
        mask = pairwise_sqdist(pts, pts) < radius * radius
        idx = first_k_in_radius(mask, nsample)
        cnt = mask.sum(dim=-1, dtype=torch.int32)
        slot = torch.arange(nsample, dtype=torch.int32, device=pts.device)
        valid = slot < torch.clamp_max(cnt, nsample)[..., None]
        planes = gather_planar(x, y, z, idx)
    else:
        raise ValueError(f"unknown neighbour mode {mode!r}")
    d2_sel = (planes[0] - x[..., None]) ** 2 + (planes[1] - y[..., None]) ** 2 + (planes[2] - z[..., None]) ** 2
    return planes, d2_sel, valid


def _check_subset(nsample: int, pts: torch.Tensor):
    if pts.dim() != 3 or pts.shape[-1] != 3:
        raise ValueError(f"pts must be (B, N, 3), got {tuple(pts.shape)}")
    N = pts.shape[1]
    if nsample <= 0 or N % nsample:
        raise ValueError(f"the subset grouping needs nsample | N (N={N}, nsample={nsample})")


def subset_sqdist(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """fma(dz, dz, fma(dx, dx, dy * dy)) in float32: the TPU kernel's
    dx * dx + dy * dy + dz * dz as XLA contracts it into fused multiply-adds
    (what the JAX package's interpret mode computes), and what the kernel
    computes with ``__fmaf_rn``. Each fused operation is formed in float64
    (the float32 product is exact there) and rounded to float32; a float64
    rounding of the sum can only move that at a float32 rounding tie."""
    inner = (dx.double() * dx.double() + (dy * dy).double()).float()
    return (dz.double() * dz.double() + inner.double()).float()


def _subset_first(radius: float, nsample: int, pts: torch.Tensor):
    """(the cloud in permuted order (B, N, 3), the (B, N, G, S) squared
    distances of centre to candidate, each slot's first hit (B, N, 1, S)
    int64, G where it has none)."""
    _check_subset(nsample, pts)
    pts = pts.float()
    B, N, _ = pts.shape
    S, G = nsample, N // nsample
    perm, _ = permutation(N, pts.device)
    pts_p = pts.index_select(1, perm.long())
    cand = pts_p.view(B, 1, G, S, 3)
    dx, dy, dz = (pts[:, :, None, None, i] - cand[..., i] for i in range(3))  # (B, N, G, S)
    d2 = subset_sqdist(dx, dy, dz)
    del dx, dy, dz
    giota = torch.arange(G, dtype=torch.int32, device=pts.device)[:, None]
    first = torch.where(d2 < radius * radius, giota, G).amin(dim=2, keepdim=True).long()
    return pts_p, d2, first


def subset_scans(radius: float, nsample: int, pts: torch.Tensor) -> int:
    """The candidates the subset grouping tests on this cloud: each slot's up
    to its first hit, all G where it has none (the work of its kernel)."""
    G = pts.shape[1] // nsample
    return int(torch.clamp_max(_subset_first(radius, nsample, pts)[2] + 1, G).sum())


def ball_group_subset_plain(radius: float, nsample: int, pts: torch.Tensor):
    """Plain twin of the subset grouping kernel (the TPU kernel
    ``ball_group_subset_pallas``): slot s takes its first candidate g whose
    permuted column g * S + s lies strictly within ``radius``, the squared
    distance ``subset_sqdist`` of centre minus candidate. A
    slot with no hit holds candidate 0 and d2 0. Returns ((gx, gy, gz),
    d2_sel, valid) as ``ball_group_planar``."""
    pts_p, d2, first = _subset_first(radius, nsample, pts)
    B, N, S, G = pts.shape[0], pts.shape[1], nsample, pts.shape[1] // nsample
    valid = first[:, :, 0] < G
    first = torch.where(first < G, first, 0)
    d2_sel = torch.where(valid, torch.take_along_dim(d2, first, dim=2)[:, :, 0], 0.0)
    del d2
    idx = (first[:, :, 0] * S + torch.arange(S, device=pts.device)).view(B, N * S)
    planes = tuple(torch.gather(pts_p[..., i], 1, idx).view(B, N, S) for i in range(3))
    return planes, d2_sel, valid


def ball_group_subset_cuda(radius: float, nsample: int, pts: torch.Tensor):
    """The subset grouping on the card (``csrc/ball_group_subset.cu``): one
    block per cloud and tile of centres, the permuted cloud staged in shared
    memory 4096 points at a time, one thread per (centre, slot)."""
    _check_subset(nsample, pts)
    if pts.device.type != "cuda":
        raise ValueError("ball_group_subset_cuda needs a CUDA tensor")
    B, N, _ = pts.shape
    pts = pts.float().contiguous()
    perm, _ = permutation(N, pts.device)
    dev = pts.device
    planes = tuple(torch.empty((B, N, nsample), dtype=torch.float32, device=dev) for _ in range(3))
    d2_sel = torch.empty((B, N, nsample), dtype=torch.float32, device=dev)
    valid = torch.empty((B, N, nsample), dtype=torch.bool, device=dev)
    lib = build.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.unopose_ball_group_subset(
            ptr(pts.data_ptr()), ptr(perm.data_ptr()), *(ptr(t.data_ptr()) for t in (*planes, d2_sel, valid)),
            B, N, nsample, float(radius * radius), ptr(build.stream_of(pts)),
        )
    build.check(err, "ball_group_subset")
    LAUNCHES["ball_group_subset"] += 1
    return planes, d2_sel, valid


def ball_group_subset(radius: float, nsample: int, pts: torch.Tensor):
    """The subset grouping of ``ball_group_subset_pallas``, dispatched by device."""
    if pts.device.type == "cpu":
        return ball_group_subset_plain(radius, nsample, pts)
    return ball_group_subset_cuda(radius, nsample, pts)
