"""Coarse and fine point-matching stages with overlap heads (counterpart of
``unopose_tpu/models/matching.py``).

Inference: the fine positional encoding runs, both clouds as one batch and
with folded BatchNorm, the packed first_k path with the plain MLP
(``pe_fused=False``) or a fused PE (``pe_fused=True``: PE-v5, or the packed
PE's other layouts where the JAX package's gates and switches send the
cloud; ``FinePositionalEncoding``); where the packed path is off
(``pe_packed=False``) or cannot take the cloud, the unpacked first_k
grouping; in ``subset`` mode two subset groupings. The last two run the
masked PE (``ops/pe_fused.py:pe_fused_masked``) with ``pe_fused``, else the
plain MLP. Training (``train=True``):
each cloud separately (batch statistics are per cloud), the first_k
grouping of ``two_scale_group_first_k_fast``, and per scale the MLP with
batch-statistics BatchNorm: the kernels' pass structure of
``ops/pe_train.py:pe_mlp_bn_pool_train`` with ``pe_fused`` (K11-K14 on the
card), the plain float32 formulation without; the BatchNorm running
statistics take flax's update. With ``UNOPOSE_PE_TRAIN_FROZEN=1``, as in
the JAX package, a scale whose shapes the frozen kernels take (P % 32 ==
0) runs the frozen-BN variant instead (``pe_mlp_bn_pool_frozen``: BN with
the running statistics, which stay unchanged; K12 and K18 on the card,
their plain passes on the CPU). Both matchers then return every block's
similarity, overlap scores and saliencies for the loss. ``lax.cond`` on the
grouping's overflow flag becomes a host branch: one device-to-host sync per
grouping.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from unopose_tpu_torch.models.layers import Dense
from unopose_tpu_torch.models.transformer import GeometricTransformer, SparseToDenseTransformer
from unopose_tpu_torch.ops.ball_query import (
    CHUNKS,
    ball_group_planar,
    ball_group_subset,
    two_scale_group_exact_planar,
    two_scale_group_first_k_fast,
    two_scale_group_first_k_packed,
    two_scale_group_first_k_packed_idx,
)
from unopose_tpu_torch.ops.geometry import compute_feature_similarity
from unopose_tpu_torch.ops.lrf import batch_lrf_planar
from unopose_tpu_torch.ops.pe_fused import (
    pack_mlp,
    pe_channels_packed,
    pe_fused_gather_t,
    pe_fused_masked,
    pe_fused_packed,
    pe_fused_packed_t,
    pe_fused_v5,
    pe_mlp_pool_packed,
)
from unopose_tpu_torch.ops.pe_train import pe_mlp_bn_pool_frozen, pe_mlp_bn_pool_train, pe_mlp_bn_pool_train_plain


def block_outputs(atten, scores, n1: int, need_saliency: bool = False):
    """(overlap scores (B, n1+n2), saliencies (B, n1+n2) or None) from the raw
    head outputs on [bg, f1..., bg, f2...] and the similarity (B, n1+1,
    n2+1). The saliency (the loss's alone) contracts the row and the column
    softmax of the similarity with the other cloud's raw scores."""
    s1 = scores[:, 1 : n1 + 1]
    s2 = scores[:, n1 + 2 :]
    score = torch.sigmoid(torch.cat([s1, s2], dim=1)[..., 0].float()).clamp(0.0, 1.0)
    if not need_saliency:
        return score, None
    a = atten[:, 1:, 1:].float()
    m1 = torch.matmul(torch.softmax(a, dim=2), s2.float())
    m2 = torch.einsum("bij,bik->bjk", torch.softmax(a, dim=1), s1.float())
    return score, torch.sigmoid(torch.cat([m1, m2], dim=1)[..., 0]).clamp(0.0, 1.0)


class _CoarseBlock(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.transformer = GeometricTransformer(("self", "cross"), hidden_dim, num_heads, dtype)
        self.score_head = Dense(hidden_dim, 1, dtype)

    def forward(self, f1, geo1, f2, geo2):
        f1, f2 = self.transformer(f1, geo1, f2, geo2)
        return f1, f2, self.score_head(torch.cat([f1, f2], dim=1))


class CoarsePointMatching(nn.Module):
    def __init__(self, nblock: int = 3, input_dim: int = 256, hidden_dim: int = 256, out_dim: int = 256,
                 num_heads: int = 4, temp: float = 0.1, normalize_feat: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.temp, self.normalize_feat, self.dtype = temp, normalize_feat, dtype
        self.in_proj = Dense(input_dim, hidden_dim, dtype)
        self.out_proj = Dense(hidden_dim, out_dim, dtype)
        self.bg_token = nn.Parameter(torch.randn(1, 1, hidden_dim) * 0.02)
        self.blocks = nn.ModuleList(_CoarseBlock(hidden_dim, num_heads, dtype) for _ in range(nblock))

    def forward(self, f1, geo1, f2, geo2, all_blocks: bool = False):
        """f1 (B, n1, C), geo1 (B, n1+1, n1+1, C), likewise f2/geo2 ->
        (atten (B, n1+1, n2+1), score (B, n1+n2)) of the last block; with
        ``all_blocks`` (training) the lists (attens, scores, saliencies) of
        every block."""
        B, n1 = f1.shape[:2]
        bg = self.bg_token.to(self.dtype).expand(B, 1, -1)
        f1 = torch.cat([bg, self.in_proj(f1)], dim=1)
        f2 = torch.cat([bg, self.in_proj(f2)], dim=1)
        outs = []
        for blk in self.blocks:
            f1, f2, scores = blk(f1, geo1, f2, geo2)
            outs.append((f1, f2, scores))
        if not all_blocks:
            atten = compute_feature_similarity(
                self.out_proj(f1).float(), self.out_proj(f2).float(), self.temp, self.normalize_feat
            )
            return atten, block_outputs(atten, scores, n1)[0]
        return _all_block_outputs(self, outs, n1)


def _all_block_outputs(m, outs, n1: int):
    """(attens, scores, saliencies) of every block, for the training loss."""
    attens, scores_l, sals = [], [], []
    for f1, f2, scores in outs:
        atten = compute_feature_similarity(m.out_proj(f1).float(), m.out_proj(f2).float(), m.temp, m.normalize_feat)
        score, sal = block_outputs(atten, scores, n1, need_saliency=True)
        attens.append(atten)
        scores_l.append(score)
        sals.append(sal)
    return attens, scores_l, sals


class BNVars(nn.Module):
    """BatchNorm parameters and running statistics: folded into the preceding
    linear layer at inference; in training, applied with the batch
    statistics by ``ops/pe_train.py``, which also update the running ones."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))


def fold_bn(W, scale, bias, mean, var, eps: float = 1e-5):
    """y = scale * (x W - mean) / sqrt(var + eps) + bias as one affine map."""
    inv = scale / torch.sqrt(var + eps)
    return W * inv[None, :], bias - mean * inv


def folded_scale_planar(center, grouped, r: float, Ws, bs, lrf_w=None, pool_mask=None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One PE scale: relative xyz + LRF coordinates through the folded MLP,
    max over the slots. ``lrf_w`` weights the LRF sums by multiplicity,
    ``pool_mask`` restricts the max; ``dtype`` stores the channels and each
    layer's activations (the JAX package's ``compute_dtype``: bf16 in subset
    mode), the products run in float32. Returns (B, P, d_last) float32."""
    rel = [g - c[..., None] for g, c in zip(grouped, center)]
    lrf = batch_lrf_planar(center, grouped, r, mask=lrf_w)
    h = torch.stack([*rel, *lrf], dim=-1).to(dtype)  # (B, P, S, 6), channels last
    for W, b in zip(Ws, bs):
        h = torch.matmul(h.float(), W).add_(b).relu_().to(dtype)
    h = h.float()
    if pool_mask is not None:
        h.masked_fill_(~pool_mask[..., None], float("-inf"))
    return h.amax(dim=2)


NEIGHBOR_MODES = ("first_k", "subset")


class FinePositionalEncoding(nn.Module):
    """Two-scale local-geometry encoding. Inference (``neighbor_mode``
    "first_k"), as the JAX package routes it (see ``forward``): where the
    packed grouping can take the cloud (``packed_ok``, ``packed`` not
    False), the plain MLP on the materialised packed grouping, or with
    ``fused`` PE-v5 (``ops/pe_fused.py``: the channels and MLP/pool
    kernels), or one of the packed PE's other layouts (rows 10-13 of the
    JAX package's kernels, three of them behind its switches
    ``UNOPOSE_PE_V4``, ``UNOPOSE_PE_V3`` and ``UNOPOSE_PE_SLOT_MAJOR``, and
    row 10 where PE-v5 cannot take the cloud or ``UNOPOSE_PE_V5=0``);
    otherwise the unpacked first_k grouping (``two_scale_group_first_k_fast``)
    through the masked PE with all-ones masks (``fused``, 32 | N) or the
    plain MLP over every slot. "subset": two subset groupings
    (``ball_group_subset`` with ``fused`` where nsample1 and nsample2
    divide N, else ``ball_group_planar``) through the masked PE (``fused``)
    or the plain MLP with bf16 activations and masks. Training: see the
    module docstring.

    ``last_branch`` records which branch the last inference forward took:
    "v5", "gather_t" (row 12), "v3" (row 13), "packed_t" (row 11),
    "packed" (row 10 with ``fused``, else the plain MLP on the packed
    grouping), "unpacked", "unpacked_plain" (``fused`` on an unpacked cloud
    the masked PE does not take), "subset", or "exact" after a grouping
    overflow.
    """

    MLP_DIMS = (32, 64, 128)

    def __init__(self, out_dim: int = 256, r1: float = 0.1, r2: float = 0.2, nsample1: int = 64,
                 nsample2: int = 256, fused: bool = False, neighbor_mode: str = "first_k", packed=None):
        super().__init__()
        if neighbor_mode not in NEIGHBOR_MODES:
            raise ValueError(f"unknown neighbour mode {neighbor_mode!r}; one of {NEIGHBOR_MODES}")
        self.r1, self.r2, self.nsample1, self.nsample2, self.fused = r1, r2, nsample1, nsample2, fused
        self.neighbor_mode, self.packed = neighbor_mode, packed
        # the plain MLP's activation storage: the JAX package's default compute_dtype
        self.compute_dtype = torch.float32 if neighbor_mode == "first_k" else torch.bfloat16
        for name in ("mlp1", "mlp2"):
            cin = 6
            for i, d in enumerate(self.MLP_DIMS):
                kernel = torch.randn(cin, d) * (2.0 / cin) ** 0.5  # (in, out), He normal
                setattr(self, f"{name}_fc{i}_kernel", nn.Parameter(kernel))
                setattr(self, f"{name}_bn{i}", BNVars(d))
                cin = d
        self.mlp3 = Dense(2 * self.MLP_DIMS[-1], out_dim, torch.float32)
        self.last_branch = None
        self._weights = None  # (key, (mlp1, mlp2, packed)) of folded_weights()

    def folded(self, name: str):
        Ws, bs = [], []
        for i in range(len(self.MLP_DIMS)):
            bn = getattr(self, f"{name}_bn{i}")
            W, b = fold_bn(getattr(self, f"{name}_fc{i}_kernel"), bn.weight, bn.bias, bn.mean, bn.var)
            Ws.append(W)
            bs.append(b)
        return Ws, bs

    def folded_weights(self):
        """(mlp1, mlp2, packed): both scales' folded (Ws, bs) and, for the
        fused PE on the card, their ``pack_mlp`` (else None). Made once per
        set of weights, not per forward: the key follows the MLP tensors'
        storage and in-place versions, and ``.to()`` drops it."""
        tensors = [t for name, t in (*self.named_parameters(), *self.named_buffers()) if name.startswith("mlp1")
                   or name.startswith("mlp2")]
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._weights is None or self._weights[0] != key:
            with torch.no_grad():
                mlp1, mlp2 = self.folded("mlp1"), self.folded("mlp2")
                packed = pack_mlp(mlp1, mlp2) if self.fused and tensors[0].is_cuda else None
            self._weights = (key, (mlp1, mlp2, packed))
        return self._weights[1]

    def _apply(self, fn, *args, **kwargs):
        self._weights = None
        return super()._apply(fn, *args, **kwargs)

    def packed_ok(self, N: int) -> bool:
        k2 = self.nsample2
        return N % 64 == 0 and N <= 4096 and N >= k2 and k2 % 256 == 0

    @staticmethod
    def train_channels(center, grouped, r: float) -> torch.Tensor:
        """One scale's MLP input in training: (B, 6, P, S) float32, each
        slot's offset from its centre and its local-frame coordinates, with
        no gradient (the clouds are data)."""
        rel = [g - c[..., None] for g, c in zip(grouped, center)]
        return torch.stack([*rel, *batch_lrf_planar(center, grouped, r)], dim=1).float().detach()

    def _scale_train(self, center, grouped, r: float, name: str) -> torch.Tensor:
        """One scale in training: (B, P, 128) pooled features, and flax's
        running update of the scale's BatchNorm statistics (momentum 0.9,
        biased batch variance); under ``UNOPOSE_PE_TRAIN_FROZEN=1`` with P %
        32 == 0 (the JAX package's gate), the frozen-BN stack, which leaves
        the statistics as they are."""
        chans = self.train_channels(center, grouped, r)
        Ws = [getattr(self, f"{name}_fc{i}_kernel") for i in range(len(self.MLP_DIMS))]
        bns = [getattr(self, f"{name}_bn{i}") for i in range(len(self.MLP_DIMS))]
        args = (chans, Ws, [bn.weight for bn in bns], [bn.bias for bn in bns])
        if os.environ.get("UNOPOSE_PE_TRAIN_FROZEN") == "1" and chans.shape[2] % 32 == 0:
            return pe_mlp_bn_pool_frozen(*args, [bn.mean for bn in bns], [bn.var for bn in bns])
        if self.fused:
            pooled, (mus, vars_) = pe_mlp_bn_pool_train(*args)
        else:
            pooled, (mus, vars_) = pe_mlp_bn_pool_train_plain(*args, mm_dtype=torch.float32)
        with torch.no_grad():
            for bn, mu, var in zip(bns, mus, vars_):
                bn.mean.copy_(0.9 * bn.mean + 0.1 * mu)
                bn.var.copy_(0.9 * bn.var + 0.1 * var)
        return pooled

    def _first_k_groups(self, pts: torch.Tensor):
        """Both scales' first_k groupings: the chunked select where it can
        take the cloud, else the exact two-sort grouping (the same slots)."""
        N, k2 = pts.shape[1], self.nsample2
        args = (self.r1, self.nsample1, self.r2, k2, pts)
        if N % CHUNKS == 0 and k2 % CHUNKS == 0 and k2 <= N <= 4096 and self.nsample1 <= k2 and self.r1 < self.r2:
            return two_scale_group_first_k_fast(*args)
        return two_scale_group_exact_planar(*args)

    def forward_train(self, pts: torch.Tensor) -> torch.Tensor:
        """One cloud in training: pts (B, N, 3) -> (B, N, out_dim)."""
        if self.neighbor_mode != "first_k":
            raise NotImplementedError("not ported: the subset-mode train step")
        pts = pts.float().detach()
        center = tuple(pts.unbind(-1))
        g1, g2 = self._first_k_groups(pts)
        f1 = self._scale_train(center, g1, self.r1, "mlp1")
        f2 = self._scale_train(center, g2, self.r2, "mlp2")
        return self.mlp3(torch.cat([f1, f2], dim=-1))

    def _masked(self, center, g1, valid1, g2, valid2) -> torch.Tensor:
        """(B, P, 256) features of two masked groupings: the masked PE with
        ``fused``, else the plain MLP in ``compute_dtype``."""
        mlp1, mlp2, packed = self.folded_weights()
        if self.fused:
            return pe_fused_masked(g1, valid1, g2, valid2, center, mlp1, mlp2, self.r1, self.r2, packed)
        f1 = folded_scale_planar(center, g1, self.r1, *mlp1, lrf_w=valid1, pool_mask=valid1, dtype=self.compute_dtype)
        f2 = folded_scale_planar(center, g2, self.r2, *mlp2, lrf_w=valid2, pool_mask=valid2, dtype=self.compute_dtype)
        return torch.cat([f1, f2], dim=-1)

    def _subset_groups(self, pts: torch.Tensor):
        """Both scales' subset groupings with their validity: the grouping
        kernel with ``fused`` where each budget divides N, else the plain
        ``ball_group_planar``."""
        N = pts.shape[1]
        if self.fused and N % self.nsample1 == 0 and N % self.nsample2 == 0:
            g1, _, valid1 = ball_group_subset(self.r1, self.nsample1, pts)
            g2, _, valid2 = ball_group_subset(self.r2, self.nsample2, pts)
        else:
            g1, _, valid1 = ball_group_planar(self.r1, self.nsample1, pts, mode="subset")
            g2, _, valid2 = ball_group_planar(self.r2, self.nsample2, pts, mode="subset")
        return g1, valid1, g2, valid2

    def _unpacked(self, pts: torch.Tensor, center) -> torch.Tensor:
        """The unpacked first_k path: every slot materialised, pads included,
        through the masked PE with all-ones masks (``fused``, where 32 | N as
        in the JAX package) or the plain MLP in ``compute_dtype``."""
        g1, g2 = self._first_k_groups(pts)
        if self.fused and pts.shape[1] % 32 == 0:
            self.last_branch = "unpacked"
            ones1, ones2 = (torch.ones(g[0].shape, dtype=torch.bool, device=pts.device) for g in (g1, g2))
            return self.mlp3(self._masked(center, g1, ones1, g2, ones2))
        self.last_branch = "unpacked_plain" if self.fused else "unpacked"
        mlp1, mlp2, _ = self.folded_weights()
        f1 = folded_scale_planar(center, g1, self.r1, *mlp1, dtype=self.compute_dtype)
        f2 = folded_scale_planar(center, g2, self.r2, *mlp2, dtype=self.compute_dtype)
        return self.mlp3(torch.cat([f1, f2], dim=-1))

    def _packed_pe(self, center, g2, w1, w2, total2, tiled: bool) -> torch.Tensor:
        """(B, P, 256) features on the materialised packed grouping: the plain
        MLP, or with ``fused`` row 13 (``UNOPOSE_PE_V3=1``), row 11
        (``UNOPOSE_PE_SLOT_MAJOR=1``), both where ``tiled``, else row 10."""
        mlp1, mlp2, packed = self.folded_weights()
        weights = (*mlp1, *mlp2)
        if not self.fused:
            self.last_branch = "packed"
            f1 = folded_scale_planar(center, g2, self.r1, *mlp1, lrf_w=w1, pool_mask=w1 > 0)
            f2 = folded_scale_planar(center, g2, self.r2, *mlp2)
            return torch.cat([f1, f2], dim=-1)
        if tiled and os.environ.get("UNOPOSE_PE_V3", "0") == "1":
            self.last_branch = "v3"
            chunks, _ = pe_channels_packed(g2, w1, w2, center, self.r1, self.r2)
            return pe_mlp_pool_packed(chunks, total2, *weights, packed)
        if tiled and os.environ.get("UNOPOSE_PE_SLOT_MAJOR") == "1":
            self.last_branch = "packed_t"
            slot_major = lambda x: x.transpose(1, 2).contiguous()  # the JAX package's swapaxes, a PyTorch op here
            return pe_fused_packed_t(tuple(map(slot_major, g2)), slot_major(w1), slot_major(w2), total2, center,
                                     *weights, self.r1, self.r2, packed)
        self.last_branch = "packed"
        return pe_fused_packed(g2, w1, w2, total2, center, *weights, self.r1, self.r2, packed)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        """pts (B, N, 3) -> (B, N, out_dim). The first_k branch follows the
        JAX package's decisions (``models/matching.py:pe_packed_firstk_path``),
        reading its switches at the call: PE-v5 with ``fused`` at N % 128 ==
        0, nsample2 256 and ``UNOPOSE_PE_V5`` unset or "1"; else row 12 with
        ``fused``, ``UNOPOSE_PE_V4=1`` and N % 128 == 0 == nsample2 % 256;
        else the materialised packed grouping (``_packed_pe``); every
        overflow takes the exact fallback."""
        pts = pts.float()
        N = pts.shape[1]
        center = tuple(pts.unbind(-1))
        if self.neighbor_mode == "subset":
            self.last_branch = "subset"
            return self.mlp3(self._masked(center, *self._subset_groups(pts)))
        if self.packed is False or not self.packed_ok(N):
            return self._unpacked(pts, center)
        mlp1, mlp2, packed = self.folded_weights()
        args = (self.r1, self.nsample1, self.r2, self.nsample2, pts)
        tiled = N % 128 == 0 and self.nsample2 % 256 == 0
        index_pe = None
        if self.fused and N % 128 == 0 and self.nsample2 == 256 and os.environ.get("UNOPOSE_PE_V5", "1") == "1":
            index_pe = ("v5", pe_fused_v5)
        elif self.fused and tiled and os.environ.get("UNOPOSE_PE_V4", "0") == "1":
            index_pe = ("gather_t", pe_fused_gather_t)
        if index_pe is not None:
            planes, idx_p, w1, w2, total2, overflow = two_scale_group_first_k_packed_idx(*args)
            if not bool(overflow.item()):
                self.last_branch, fn = index_pe
                feat = fn(planes, idx_p, w1, w2, total2, center, *mlp1, *mlp2, self.r1, self.r2, packed)
                return self.mlp3(feat)
        else:
            g2, w1, w2, total2, overflow = two_scale_group_first_k_packed(*args)
            if not bool(overflow.item()):
                return self.mlp3(self._packed_pe(center, g2, w1, w2, total2, tiled))
        self.last_branch = "exact"
        g1e, g2e = two_scale_group_exact_planar(*args)
        f1 = folded_scale_planar(center, g1e, self.r1, *mlp1)
        f2 = folded_scale_planar(center, g2e, self.r2, *mlp2)
        return self.mlp3(torch.cat([f1, f2], dim=-1))


class _FineBlock(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, focusing_factor: float, dtype: torch.dtype):
        super().__init__()
        self.transformer = SparseToDenseTransformer(hidden_dim, ("self", "cross"), num_heads, focusing_factor, dtype)
        self.score_head = Dense(hidden_dim, 1, dtype)

    def forward(self, f1, geo1, fps_idx1, f2, geo2, fps_idx2):
        f1, f2 = self.transformer(f1, geo1, fps_idx1, f2, geo2, fps_idx2)
        return f1, f2, self.score_head(torch.cat([f1, f2], dim=1))


class FinePointMatching(nn.Module):
    def __init__(self, nblock: int = 3, input_dim: int = 256, hidden_dim: int = 256, out_dim: int = 256,
                 num_heads: int = 4, temp: float = 0.1, normalize_feat: bool = True,
                 focusing_factor: float = 3.0, pe_radius1: float = 0.1, pe_radius2: float = 0.2,
                 nsample1: int = 64, nsample2: int = 256, pe_fused: bool = False, pe_neighbor_mode: str = "first_k",
                 pe_packed=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.temp, self.normalize_feat, self.dtype = temp, normalize_feat, dtype
        self.pe = FinePositionalEncoding(hidden_dim, pe_radius1, pe_radius2, nsample1, nsample2, pe_fused,
                                         pe_neighbor_mode, pe_packed)
        self.in_proj = Dense(input_dim, hidden_dim, dtype)
        self.out_proj = Dense(hidden_dim, out_dim, dtype)
        self.bg_token = nn.Parameter(torch.randn(1, 1, hidden_dim) * 0.02)
        self.blocks = nn.ModuleList(
            _FineBlock(hidden_dim, num_heads, focusing_factor, dtype) for _ in range(nblock)
        )

    def forward(self, p1, f1, geo1, fps_idx1, p2, f2, geo2, fps_idx2, init_R, init_t, return_proj: bool = False,
                train: bool = False):
        """Dense clouds p1/p2 (B, n, 3), features f1/f2 (B, n, C), sparse
        embeddings geo* (B, 197, 197, C), FPS indices (B, 196), initial pose.
        Returns (atten (B, n1+1, n2+1), score (B, n1+n2)) of the last block;
        with ``return_proj`` (the fused assignment) the two projected
        features ((B, n1+1, C), (B, n2+1, C)) float32, bg token included,
        stand in place of the similarity matrix, which is never built. With
        ``train`` the lists (attens, scores, saliencies) of every block."""
        B, n1 = p1.shape[:2]
        p1_aligned = torch.matmul(p1 - init_t[:, None, :], init_R)
        if train:
            pe1, pe2 = self.pe.forward_train(p1_aligned), self.pe.forward_train(p2)
        else:
            pe = self.pe(torch.cat([p1_aligned, p2], dim=0))
            pe1, pe2 = pe[:B], pe[B:]
        bg = self.bg_token.to(self.dtype).expand(B, 1, -1)
        f1 = torch.cat([bg, self.in_proj(f1) + pe1.to(self.dtype)], dim=1)
        f2 = torch.cat([bg, self.in_proj(f2) + pe2.to(self.dtype)], dim=1)
        outs = []
        for blk in self.blocks:
            f1, f2, scores = blk(f1, geo1, fps_idx1, f2, geo2, fps_idx2)
            outs.append((f1, f2, scores))
        if train:
            return _all_block_outputs(self, outs, n1)
        proj = (self.out_proj(f1).float(), self.out_proj(f2).float())
        score = block_outputs(None, scores, n1)[0]
        if return_proj:
            return proj, score
        return compute_feature_similarity(*proj, self.temp, self.normalize_feat), score
