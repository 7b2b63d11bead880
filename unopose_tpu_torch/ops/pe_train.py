"""The fine PE's train stack with batch-statistics BatchNorm (counterpart of
``unopose_tpu/ops/pe_train.py:pe_mlp_bn_pool_train``), and its frozen-BN
variant (``pe_mlp_bn_pool_frozen``).

Per cloud and scale: the shared MLP 6 -> 32 -> 64 -> 128 on the (B, 6, P, S)
channels, each layer followed by flax's train-mode BatchNorm (biased fast
variance ``E[z^2] - E[z]^2`` clipped at 0, eps 1e-5) and ReLU, then the max
over the S slots. The channels carry no gradient (the cloud coordinates are
data and the fine initial pose is a noisy label): the gradient goes to the
weights, gammas and betas only.

- ``pe_mlp_bn_pool_train_plain`` is the formulation on torch autograd, the
  JAX package's default train path (einsum, ``BatchNorm(train)``, ReLU, max)
  with the kernel's rounding points: chans, W, the post-ReLU activations and
  (in the backward) dz rounded to ``mm_dtype`` before each float32 product.
- ``pe_mlp_bn_pool_train`` is the same function as a ``torch.autograd.Function``
  in the TPU kernel's pass structure: three statistics passes (depth 1, 2,
  3), the forward, three backward-sum passes (layer 3, 2, 1) and the weight
  gradient pass. The passes are chosen by device: CPU tensors take their
  plain versions here (``PLAIN_PASSES``), CUDA tensors the kernels of
  ``kernels/csrc/pe_train.cu`` (K11-K14, ``CUDA_PASSES``), which raise on
  failure.

The passes share one (3, 8, 128) float32 buffer of per-layer statistics,
rows ``MU`` .. ``SGZ``: the batch mean, variance and 1/sigma, the affine
a = gamma / sigma and b = beta - gamma mu / sigma, and the backward's sums
of g and g * zhat (the layer's dbeta and dgamma); the spare row ``INV_N``
holds, at layer 0 column 0, 1/n of the count the backward's centering
terms divide those sums by (0: the local count B P S). The passes'
products round their operands to bf16 (``MM_DTYPE``), as the kernels do.

On several ranks (``parallel/mesh.py``) the statistics and the centering
terms span the global batch, as GSPMD's BatchNorm does in the JAX package:
K11 then runs as a block pass (``stats_partial``: this rank's per-channel
sums, float64) and a finish (``stats_finish`` over the global count R B P
S) with an all-reduce of the sums between them, one a depth; the forward
writes the global count's 1/n into ``INV_N`` for K13 and K14. K13's sums
are linear in g once 1/sigma is global, so it keeps its one call and each
layer's ``SG`` and ``SGZ`` rows are all-reduced in place after it. The
gamma and beta gradients are this rank's own sums, so that the gradient
average makes them the global ones (the reduced sums would count every
rank's cotangent, each the gradient of its own local-mean loss). The
autograd formulation reduces its sums through ``_SumAcrossRanks``, whose
backward reduces the cotangents, as ``torch.nn.SyncBatchNorm`` does. At
world size 1 every function runs its one-call passes as before and launches
no collective.

The frozen-BN variant normalises with the running statistics, as flax's
``BatchNorm(use_running_average=True)``, in training (an opt-in deviation
from the reference recipe, ``UNOPOSE_PE_TRAIN_FROZEN=1``): the statistics
are constants, so the backward has no batch-statistics terms and is one
sweep. ``pe_mlp_bn_pool_frozen_plain`` is its formulation on autograd;
``pe_mlp_bn_pool_frozen`` fills the buffer from the running statistics,
runs the forward pass (K12, ``fwd_cuda``, unchanged) and, as its backward,
``frozen_bwd_plain`` / ``frozen_bwd_cuda`` (K18). No gradient reaches the
running statistics and nothing updates them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.geometry import no_tf32, sqrt_rn
from unopose_tpu_torch.parallel import mesh

DIMS = (6, 32, 64, 128)
MU, VAR, INV, A, B_, SG, SGZ, INV_N = range(8)  # rows of the statistics buffer
MM_DTYPE = torch.bfloat16
DW_SIZE = sum(DIMS[i] * DIMS[i + 1] for i in range(3))
FROZEN_SUMS = 2 * sum(DIMS[1:])  # K18's per-block sums of g and g zhat, every layer


def _round(x: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    return x if mm_dtype == torch.float32 else x.to(mm_dtype).float()


class _RoundOperand(torch.autograd.Function):
    """Rounds a product's operand; the gradient passes through unrounded."""

    @staticmethod
    def forward(ctx, x, mm_dtype):
        return _round(x, mm_dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAcrossRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks; its gradient the sum over the
    ranks of the cotangents (each rank's loss reaches the others' rows
    through the global statistics)."""

    @staticmethod
    def forward(ctx, x):
        return mesh.all_reduce_sum(x.clone(), "pe_train_stats")

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_sum(g.contiguous().clone(), "pe_train_stats_grad")


class _RoundCotangent(torch.autograd.Function):
    """Identity whose backward rounds the cotangent (the kernel's dz)."""

    @staticmethod
    def forward(ctx, x, mm_dtype):
        ctx.mm_dtype = mm_dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mm_dtype), None


def _check(chans, Ws, gammas=None, betas=None):
    if chans.dim() != 4 or chans.shape[1] != DIMS[0]:
        raise ValueError(f"chans must be (B, 6, P, S), got {tuple(chans.shape)}")
    if len(Ws) != 3 or any(tuple(W.shape) != (DIMS[i], DIMS[i + 1]) for i, W in enumerate(Ws)):
        raise ValueError(f"Ws must be (6, 32), (32, 64), (64, 128), got {[tuple(W.shape) for W in Ws]}")
    for vecs in (gammas, betas):
        if vecs is not None and [tuple(v.shape) for v in vecs] != [(d,) for d in DIMS[1:]]:
            raise ValueError(f"gammas and betas must be (32,), (64,), (128,), got {[tuple(v.shape) for v in vecs]}")


def pe_mlp_bn_pool_train_plain(chans, Ws, gammas, betas, eps: float = 1e-5, mm_dtype=MM_DTYPE):
    """chans (B, 6, P, S) float32 (no gradient), Ws (6, 32), (32, 64), (64,
    128), gammas and betas (32,), (64,), (128,). Returns pooled (B, P, 128)
    float32 and the per-layer batch (means, variances), on autograd. On
    several ranks the statistics are the global batch's."""
    _check(chans, Ws, gammas, betas)
    B, C, P, S = chans.shape
    n = B * P * S
    ranks = mesh.world_size()
    h = _round(chans.detach().float().permute(0, 2, 3, 1).reshape(n, C), mm_dtype)
    mus, vars_ = [], []
    with no_tf32():
        for l, (W, gam, bet) in enumerate(zip(Ws, gammas, betas)):
            z = _RoundCotangent.apply(h @ _RoundOperand.apply(W.float(), mm_dtype), mm_dtype)
            s1, s2 = z.sum(0), (z * z).sum(0)
            if ranks > 1:
                s1, s2 = _SumAcrossRanks.apply(torch.stack([s1, s2])).unbind(0)
            mu = s1 / (n * ranks)
            var = torch.clamp_min(s2 / (n * ranks) - mu * mu, 0.0)
            inv = 1.0 / sqrt_rn(var + eps)
            y = torch.clamp_min(gam * inv * z + (bet - gam * mu * inv), 0.0)
            h = _RoundOperand.apply(y, mm_dtype) if l < 2 else y
            mus.append(mu.detach())
            vars_.append(var.detach())
    return h.view(B, P, S, DIMS[-1]).amax(dim=2), (mus, vars_)


# ------------------------------------------------------------------ the passes, plain
def _rows(chans: torch.Tensor) -> torch.Tensor:
    """(B, 6, P, S) -> (B P S, 6) float32 rows in (b, p, s) order."""
    B, C, P, S = chans.shape
    return chans.float().permute(0, 2, 3, 1).reshape(B * P * S, C)


def _chain(chans, Ws, bn, depth: int):
    """z of layers 1..depth and the rounded post-ReLU y of layers 1..depth-1."""
    h = _round(_rows(chans), MM_DTYPE)
    zs, ys = [], []
    for l in range(depth):
        d = DIMS[l + 1]
        z = h @ _round(Ws[l].float(), MM_DTYPE)
        zs.append(z)
        if l + 1 < depth:
            h = _round(torch.clamp_min(bn[l, A, :d] * z + bn[l, B_, :d], 0.0), MM_DTYPE)
            ys.append(h)
    return zs, ys


def bn_from_sums(bn, layer: int, s1, s2, gamma, beta, n: int, eps: float) -> None:
    """Fill layer ``layer``'s mu, var, inv, a, b of ``bn`` from its sums of z and z^2."""
    mu = s1.float() / n
    bn_from_stats(bn, layer, mu, torch.clamp_min(s2.float() / n - mu * mu, 0.0), gamma, beta, eps)


def bn_from_stats(bn, layer: int, mu, var, gamma, beta, eps: float) -> None:
    """Fill layer ``layer``'s mu, var, inv, a, b of ``bn`` from its mean and variance."""
    d = DIMS[layer + 1]
    mu, var = mu.float(), var.float()
    inv = 1.0 / sqrt_rn(var + eps)
    gam, bet = gamma.float(), beta.float()
    for row, v in ((MU, mu), (VAR, var), (INV, inv), (A, gam * inv), (B_, bet - gam * mu * inv)):
        bn[layer, row, :d] = v


def stats_plain(chans, Ws, gb, bn, depth: int, eps: float) -> None:
    """K11's plain twin: layer ``depth``'s batch statistics and affine into
    ``bn``. ``gb`` (3, 2, 128) holds the gammas and betas."""
    with no_tf32():
        z = _chain(chans, Ws, bn, depth)[0][-1]
    d = DIMS[depth]
    bn_from_sums(bn, depth - 1, z.sum(0), (z * z).sum(0), gb[depth - 1, 0, :d], gb[depth - 1, 1, :d],
                 z.shape[0], eps)


def stats_partial_plain(chans, Ws, bn, depth: int) -> torch.Tensor:
    """K11's block pass, plain: layer ``depth``'s sums of z and z^2 over these rows, (2, 128) float64 (0 past the
    layer's width)."""
    with no_tf32():
        z = _chain(chans, Ws, bn, depth)[0][-1]
    sums = torch.zeros((2, DIMS[-1]), dtype=torch.float64, device=z.device)
    sums[:, : z.shape[1]] = torch.stack([z.sum(0), (z * z).sum(0)])
    return sums


def stats_finish_plain(sums, gb, bn, depth: int, n: int, eps: float) -> None:
    """K11's finish, plain: layer ``depth``'s statistics and affine into ``bn`` from ``sums`` over ``n`` slots."""
    d = DIMS[depth]
    bn_from_sums(bn, depth - 1, sums[0, :d].float(), sums[1, :d].float(), gb[depth - 1, 0, :d],
                 gb[depth - 1, 1, :d], n, eps)


def fwd_plain(chans, Ws, bn):
    """K12's plain twin: pooled (B, P, 128), the max over the slots of the
    last ReLU output, and cnt (B, P, 128) float32, how many slots reach it."""
    B, _, P, S = chans.shape
    with no_tf32():
        z3 = _chain(chans, Ws, bn, 3)[0][-1]
    y3 = torch.clamp_min(bn[2, A] * z3 + bn[2, B_], 0.0).view(B, P, S, DIMS[-1])
    pooled = y3.amax(dim=2)
    return pooled, (y3 == pooled[:, :, None]).sum(dim=2, dtype=torch.float32)


def _backward(chans, Ws, bn, pooled, cnt, dpool, lowest: int):
    """Recompute the chain and back-propagate from the pool down to layer
    ``lowest`` (1-indexed; 0 for every layer's dz). Returns ({layer: g},
    {layer: zhat}, {layer: rounded dz}, the rounded post-ReLU ys)."""
    B, _, P, S = chans.shape
    n = B * P * S
    inv_n = bn[0, INV_N, 0].item() or torch.tensor(1.0 / n, dtype=torch.float32).item()
    zs, ys = _chain(chans, Ws, bn, 3)
    pre = bn[2, A] * zs[2] + bn[2, B_]
    y3 = torch.clamp_min(pre, 0.0).view(B, P, S, -1)
    share = ((1.0 / cnt) * dpool)[:, :, None]  # ties split evenly
    g = torch.where(y3 == pooled[:, :, None], share, torch.zeros_like(share)).view(n, -1)
    g = torch.where(pre > 0.0, g, torch.zeros_like(g))
    gs, zhats, dzs = {}, {}, {}
    for l in (3, 2, 1):
        d = DIMS[l]
        st = bn[l - 1, :, :d]
        gs[l] = g
        zhats[l] = (zs[l - 1] - st[MU]) * st[INV]
        if l == lowest:
            break
        dz = st[A] * ((g - st[SG] * inv_n) - zhats[l] * (st[SGZ] * inv_n))
        dzs[l] = _round(dz, MM_DTYPE)
        if l > 1:
            dy = dzs[l] @ _round(Ws[l - 1].float(), MM_DTYPE).t()
            g = torch.where(ys[l - 2] > 0.0, dy, torch.zeros_like(dy))
    return gs, zhats, dzs, ys


def bwd_sums_plain(chans, Ws, bn, pooled, cnt, dpool, layer: int) -> None:
    """K13's plain twin: sum g (dbeta) and sum g zhat (dgamma) of ``layer`` (1-indexed) into ``bn``."""
    with no_tf32():
        gs, zhats, _, _ = _backward(chans, Ws, bn, pooled, cnt, dpool, layer)
    d = DIMS[layer]
    bn[layer - 1, SG, :d] = gs[layer].sum(0)
    bn[layer - 1, SGZ, :d] = (gs[layer] * zhats[layer]).sum(0)


def bwd_dw_plain(chans, Ws, bn, pooled, cnt, dpool):
    """K14's plain twin: (dW1 (6, 32), dW2 (32, 64), dW3 (64, 128)) float32."""
    with no_tf32():
        _, _, dzs, ys = _backward(chans, Ws, bn, pooled, cnt, dpool, 0)
        x = _round(_rows(chans), MM_DTYPE)
        return tuple(inp.t() @ dzs[l + 1] for l, inp in enumerate((x, *ys)))


def frozen_bwd_plain(chans, Ws, bn, pooled, cnt, dpool):
    """K18's plain twin, the frozen-BN backward in one sweep: recompute the
    chain, the pool backward (ties split evenly), then per layer g = dy
    relu', dz = a g, sum g and sum g zhat (zhat from the running mu and
    1/sigma in ``bn``) into ``bn``'s SG and SGZ rows. Returns (dW1, dW2, dW3)."""
    B, _, P, S = chans.shape
    with no_tf32():
        zs, ys = _chain(chans, Ws, bn, 3)
        pre = bn[2, A] * zs[2] + bn[2, B_]
        y3 = torch.clamp_min(pre, 0.0).view(B, P, S, -1)
        share = ((1.0 / cnt) * dpool)[:, :, None]
        g = torch.where(y3 == pooled[:, :, None], share, torch.zeros_like(share)).view(B * P * S, -1)
        g = torch.where(pre > 0.0, g, torch.zeros_like(g))
        dws = [None] * 3
        for l in (3, 2, 1):
            st = bn[l - 1, :, : DIMS[l]]
            zhat = (zs[l - 1] - st[MU]) * st[INV]
            bn[l - 1, SG, : DIMS[l]] = g.sum(0)
            bn[l - 1, SGZ, : DIMS[l]] = (g * zhat).sum(0)
            dz = _round(st[A] * g, MM_DTYPE)
            dws[l - 1] = (ys[l - 2] if l > 1 else _round(_rows(chans), MM_DTYPE)).t() @ dz
            if l > 1:
                dy = dz @ _round(Ws[l - 1].float(), MM_DTYPE).t()
                g = torch.where(ys[l - 2] > 0.0, dy, torch.zeros_like(dy))
    return tuple(dws)


# ------------------------------------------------------------------ the passes, on the card
def _cap(dev) -> int:
    """Scratch rows (one per block) of the persistent kernels: 4 blocks per SM at most."""
    return 4 * torch.cuda.get_device_properties(dev).multi_processor_count


def _cuda_args(chans, Ws, *tensors):
    dev = chans.device
    if chans.device.type != "cuda" or any(t.device != dev for t in (*Ws, *tensors)):
        raise ValueError("the pe_train kernels need all tensors on one CUDA device")
    if chans.dtype != torch.float32 or not chans.is_contiguous():
        raise ValueError("the pe_train kernels take contiguous float32 chans")
    B, _, P, S = chans.shape
    if S % 16:
        raise ValueError(f"the pe_train kernels need S divisible by 16 (S={S})")
    ws = [W.detach().float().contiguous() for W in Ws]
    return ws, (B, P, S)


def _p(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stats_cuda(chans, Ws, gb, bn, depth: int, eps: float) -> None:
    """K11 on the card: layer ``depth``'s statistics and affine into ``bn``.
    ``gb`` (3, 2, 128) holds the gammas and betas."""
    ws, (B, P, S) = _cuda_args(chans, Ws, gb, bn)
    cap = _cap(chans.device)
    partial = torch.empty(cap * 256, dtype=torch.float32, device=chans.device)
    lib = build.load()
    with torch.cuda.device(chans.device):
        err = lib.unopose_pe_train_stats(*map(_p, (chans, *ws, gb, bn, partial)), cap, B, P, S, depth, float(eps),
                                         ctypes.c_void_p(build.stream_of(chans)))
    build.check(err, "pe_train_stats")
    LAUNCHES["pe_train_stats"] += 1


def stats_partial_cuda(chans, Ws, bn, depth: int) -> torch.Tensor:
    """K11's block pass on the card: layer ``depth``'s sums of z and z^2 over these rows, (2, 128) float64."""
    ws, (B, P, S) = _cuda_args(chans, Ws, bn)
    cap = _cap(chans.device)
    partial = torch.empty(cap * 256, dtype=torch.float32, device=chans.device)
    sums = torch.zeros((2, DIMS[-1]), dtype=torch.float64, device=chans.device)
    lib = build.load()
    with torch.cuda.device(chans.device):
        err = lib.unopose_pe_train_stats_partial(*map(_p, (chans, *ws, bn, partial)), cap, B, P, S, depth, _p(sums),
                                                 ctypes.c_void_p(build.stream_of(chans)))
    build.check(err, "pe_train_stats_partial")
    LAUNCHES["pe_train_stats"] += 1
    return sums


def stats_finish_cuda(sums, gb, bn, depth: int, n: int, eps: float) -> None:
    """K11's finish on the card: layer ``depth``'s statistics and affine into ``bn`` from ``sums`` over ``n`` slots."""
    lib = build.load()
    with torch.cuda.device(bn.device):
        err = lib.unopose_pe_train_stats_finish(_p(sums), _p(gb), _p(bn), depth, float(n), float(eps),
                                                ctypes.c_void_p(build.stream_of(bn)))
    build.check(err, "pe_train_stats_finish")


def fwd_cuda(chans, Ws, bn):
    """K12 on the card: (pooled, cnt), each (B, P, 128) float32."""
    ws, (B, P, S) = _cuda_args(chans, Ws, bn)
    pooled = torch.empty((B, P, DIMS[-1]), dtype=torch.float32, device=chans.device)
    cnt = torch.empty_like(pooled)
    lib = build.load()
    with torch.cuda.device(chans.device):
        err = lib.unopose_pe_train_fwd(*map(_p, (chans, *ws, bn, pooled, cnt)), B, P, S,
                                       ctypes.c_void_p(build.stream_of(chans)))
    build.check(err, "pe_train_fwd")
    LAUNCHES["pe_train_fwd"] += 1
    return pooled, cnt


def bwd_sums_cuda(chans, Ws, bn, pooled, cnt, dpool, layer: int) -> None:
    """K13 on the card: layer ``layer``'s sum g and sum g zhat into ``bn``."""
    ws, (B, P, S) = _cuda_args(chans, Ws, bn, pooled, cnt, dpool)
    cap = _cap(chans.device)
    partial = torch.empty(cap * 256, dtype=torch.float32, device=chans.device)
    lib = build.load()
    with torch.cuda.device(chans.device):
        err = lib.unopose_pe_train_bwd_sums(*map(_p, (chans, *ws, bn, pooled, cnt, dpool.contiguous(), partial)),
                                            cap, B, P, S, layer, ctypes.c_void_p(build.stream_of(chans)))
    build.check(err, "pe_train_bwd_sums")
    LAUNCHES["pe_train_bwd_sums"] += 1


def _split_dw(dw):
    return tuple(part.view(DIMS[i], DIMS[i + 1]) for i, part in enumerate(dw.split([6 * 32, 32 * 64, 64 * 128])))


def bwd_dw_cuda(chans, Ws, bn, pooled, cnt, dpool):
    """K14 on the card: (dW1, dW2, dW3) float32."""
    ws, (B, P, S) = _cuda_args(chans, Ws, bn, pooled, cnt, dpool)
    cap = _cap(chans.device)
    partial = torch.empty(cap * DW_SIZE, dtype=torch.float32, device=chans.device)
    dw = torch.empty(DW_SIZE, dtype=torch.float32, device=chans.device)
    lib = build.load()
    with torch.cuda.device(chans.device):
        err = lib.unopose_pe_train_bwd_dw(*map(_p, (chans, *ws, bn, pooled, cnt, dpool.contiguous(), partial)),
                                          cap, _p(dw), B, P, S, ctypes.c_void_p(build.stream_of(chans)))
    build.check(err, "pe_train_bwd_dw")
    LAUNCHES["pe_train_bwd_dw"] += 1
    return _split_dw(dw)


def frozen_bwd_cuda(chans, Ws, bn, pooled, cnt, dpool):
    """K18 on the card: (dW1, dW2, dW3) float32, and every layer's sum g and
    sum g zhat into ``bn``'s SG and SGZ rows."""
    ws, (B, P, S) = _cuda_args(chans, Ws, bn, pooled, cnt, dpool)
    cap = _cap(chans.device)
    partial = torch.empty(cap * (DW_SIZE + FROZEN_SUMS), dtype=torch.float32, device=chans.device)
    dw = torch.empty(DW_SIZE, dtype=torch.float32, device=chans.device)
    lib = build.load()
    with torch.cuda.device(chans.device):
        err = lib.unopose_pe_train_frozen_bwd(*map(_p, (chans, *ws, bn, pooled, cnt, dpool.contiguous(), partial)),
                                              cap, _p(dw), B, P, S, ctypes.c_void_p(build.stream_of(chans)))
    build.check(err, "pe_train_frozen_bwd")
    LAUNCHES["pe_train_frozen_bwd"] += 1
    return _split_dw(dw)


# ------------------------------------------------------------------ the autograd function
def stats_buffer(gammas, betas, device):
    """(bn (3, 8, 128) zeros, gb (3, 2, 128) with the gammas and betas)."""
    bn = torch.zeros((3, 8, DIMS[-1]), dtype=torch.float32, device=device)
    gb = torch.zeros((3, 2, DIMS[-1]), dtype=torch.float32, device=device)
    for l in range(3):
        gb[l, 0, : DIMS[l + 1]] = gammas[l].detach()
        gb[l, 1, : DIMS[l + 1]] = betas[l].detach()
    return bn, gb


class Passes(NamedTuple):
    """The passes in order (statistics, forward, backward sums, weight
    gradients), and K11's block pass and finish for several ranks."""

    stats: Callable
    fwd: Callable
    bwd_sums: Callable
    bwd_dw: Callable
    stats_partial: Callable
    stats_finish: Callable


PLAIN_PASSES = Passes(stats_plain, fwd_plain, bwd_sums_plain, bwd_dw_plain, stats_partial_plain, stats_finish_plain)
CUDA_PASSES = Passes(stats_cuda, fwd_cuda, bwd_sums_cuda, bwd_dw_cuda, stats_partial_cuda, stats_finish_cuda)


def _passes(chans) -> Passes:
    return PLAIN_PASSES if chans.device.type == "cpu" else CUDA_PASSES


def train_forward(chans, Ws, gammas, betas, eps: float = 1e-5):
    """The three statistics passes and the forward: (pooled, cnt, bn). On
    several ranks each depth's sums are reduced across them before its
    finish, over the global count, whose 1/n goes into ``bn``'s ``INV_N``."""
    passes = _passes(chans)
    bn, gb = stats_buffer(gammas, betas, chans.device)
    ranks = mesh.world_size()
    B, _, P, S = chans.shape
    for depth in (1, 2, 3):
        if ranks == 1:
            passes.stats(chans, Ws, gb, bn, depth, eps)
        else:
            sums = mesh.all_reduce_sum(passes.stats_partial(chans, Ws, bn, depth), "pe_train_stats")
            passes.stats_finish(sums, gb, bn, depth, ranks * B * P * S, eps)
    if ranks > 1:
        bn[0, INV_N, 0] = 1.0 / (ranks * B * P * S)
    pooled, cnt = passes.fwd(chans, Ws, bn)
    return pooled, cnt, bn


def train_backward(chans, Ws, bn, pooled, cnt, dpool):
    """The three backward-sum passes and the weight gradients: (dWs, dgammas,
    dbetas). ``bn`` gets the sums of each layer: on several ranks the sums
    reduced across them (the centering terms of the layers below and of
    K14), while dgammas and dbetas are this rank's own sums."""
    passes = _passes(chans)
    ranks = mesh.world_size()
    local = bn.clone() if ranks > 1 else bn
    for layer in (3, 2, 1):
        passes.bwd_sums(chans, Ws, bn, pooled, cnt, dpool, layer)
        if ranks > 1:
            rows = bn[layer - 1, SG:SGZ + 1]
            local[layer - 1, SG:SGZ + 1] = rows
            mesh.all_reduce_sum(rows, "pe_train_bwd_sums")
    dws = passes.bwd_dw(chans, Ws, bn, pooled, cnt, dpool)
    dgammas = tuple(local[l, SGZ, : DIMS[l + 1]].clone() for l in range(3))
    dbetas = tuple(local[l, SG, : DIMS[l + 1]].clone() for l in range(3))
    return dws, dgammas, dbetas


class _PETrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chans, eps, w0, w1, w2, g0, g1, g2, b0, b1, b2):
        pooled, cnt, bn = train_forward(chans, (w0, w1, w2), (g0, g1, g2), (b0, b1, b2), eps)
        ctx.save_for_backward(chans, w0, w1, w2, bn, pooled, cnt)
        stats = [bn[l, row, : DIMS[l + 1]].clone() for row in (MU, VAR) for l in range(3)]
        ctx.mark_non_differentiable(*stats)
        return (pooled, *stats)

    @staticmethod
    def backward(ctx, dpool, *_):
        chans, w0, w1, w2, bn, pooled, cnt = ctx.saved_tensors
        dws, dgammas, dbetas = train_backward(chans, (w0, w1, w2), bn.clone(), pooled, cnt, dpool.contiguous())
        return (None, None, *dws, *dgammas, *dbetas)


def pe_mlp_bn_pool_train(chans, Ws, gammas, betas, eps: float = 1e-5):
    """The train stack in the kernels' pass structure (see module docstring):
    pooled (B, P, 128) float32 and the per-layer batch (means, variances);
    differentiable with respect to Ws, gammas and betas only."""
    _check(chans, Ws, gammas, betas)
    chans = chans.detach().float().contiguous()
    pooled, *stats = _PETrain.apply(chans, float(eps), *Ws, *gammas, *betas)
    return pooled, (stats[:3], stats[3:])


# ------------------------------------------------------------------ the frozen-BN variant
def pe_mlp_bn_pool_frozen_plain(chans, Ws, gammas, betas, means, vars_, eps: float = 1e-5, mm_dtype=MM_DTYPE):
    """The frozen-BN stack on autograd: BN with the running ``means`` and
    ``vars_`` (constants) as the affine a z + b, the kernels' rounding points
    (chans, W, the post-ReLU activations and dz rounded to ``mm_dtype``).
    Returns pooled (B, P, 128) float32, differentiable with respect to Ws,
    gammas and betas."""
    _check(chans, Ws, gammas, betas)
    B, C, P, S = chans.shape
    h = _round(chans.detach().float().permute(0, 2, 3, 1).reshape(B * P * S, C), mm_dtype)
    with no_tf32():
        for l, (W, gam, bet, mu, var) in enumerate(zip(Ws, gammas, betas, means, vars_)):
            z = _RoundCotangent.apply(h @ _RoundOperand.apply(W.float(), mm_dtype), mm_dtype)
            mu, var = mu.detach().float(), var.detach().float()
            inv = 1.0 / sqrt_rn(var + eps)
            y = torch.clamp_min(gam * inv * z + (bet - gam * mu * inv), 0.0)
            h = _RoundOperand.apply(y, mm_dtype) if l < 2 else y
    return h.view(B, P, S, DIMS[-1]).amax(dim=2)


def frozen_buffer(gammas, betas, means, vars_, eps: float, device):
    """The statistics buffer (3, 8, 128) of the frozen variant: each layer's
    mu, var, inv = 1 / sqrt(var + eps), a = gamma inv and b = beta - gamma
    mu inv from the running statistics."""
    bn = torch.zeros((3, 8, DIMS[-1]), dtype=torch.float32, device=device)
    for l in range(3):
        bn_from_stats(bn, l, means[l].detach(), vars_[l].detach(), gammas[l].detach(), betas[l].detach(), eps)
    return bn


class _PEFrozen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chans, bn, w0, w1, w2, g0, g1, g2, b0, b1, b2):
        pooled, cnt = _passes(chans).fwd(chans, (w0, w1, w2), bn)
        ctx.save_for_backward(chans, w0, w1, w2, bn, pooled, cnt)
        return pooled

    @staticmethod
    def backward(ctx, dpool):
        chans, w0, w1, w2, bn, pooled, cnt = ctx.saved_tensors
        bwd = frozen_bwd_plain if chans.device.type == "cpu" else frozen_bwd_cuda
        bn = bn.clone()
        dws = bwd(chans, (w0, w1, w2), bn, pooled, cnt, dpool.contiguous())
        dgammas = tuple(bn[l, SGZ, : DIMS[l + 1]].clone() for l in range(3))
        dbetas = tuple(bn[l, SG, : DIMS[l + 1]].clone() for l in range(3))
        return (None, None, *dws, *dgammas, *dbetas)


def pe_mlp_bn_pool_frozen(chans, Ws, gammas, betas, means, vars_, eps: float = 1e-5):
    """The frozen-BN train stack (``use_running_average=True`` in training):
    chans (B, 6, P, S) float32 (no gradient), Ws, gammas, betas and the
    running ``means``, ``vars_`` of the three layers. Returns pooled (B, P,
    128) float32, differentiable with respect to Ws, gammas and betas; the
    running statistics get no gradient and are not updated. CPU tensors take
    the plain passes, CUDA tensors K12 and K18."""
    _check(chans, Ws, gammas, betas)
    _check(chans, Ws, means, vars_)
    chans = chans.detach().float().contiguous()
    bn = frozen_buffer(gammas, betas, means, vars_, eps, chans.device)
    return _PEFrozen.apply(chans, bn, *Ws, *gammas, *betas)
