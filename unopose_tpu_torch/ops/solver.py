"""Soft-correspondence pose solvers (counterpart of ``unopose_tpu/ops/solver.py``):
the coarse hypothesis search and the fine weighted-SVD solve.

The coarse search draws its (B, 3 * n_proposal1) uniforms from an explicit
``torch.Generator``, or takes them as an argument so that a test can hand
both packages the same draws. The JAX package gathers the sampled points
with a one-hot bf16x3 matmul, a TPU device trick; a plain index gather
returns the same float32 values. Its hypothesis selection is the plain
pass of the JAX package's XLA path (the (B, P2, N1, N2) squared distances,
by hypothesis chunks above 3e8 entries) or, with ``UNOPOSE_HYPSEL_V2=1`` on
a CUDA tensor, the fused selection kernel (``ops/hyp_select.py``), where
the JAX package takes its Pallas kernel on the TPU.
"""

from __future__ import annotations

import os

import torch

from unopose_tpu_torch.ops.fps import gather_points
from unopose_tpu_torch.ops.geometry import pairwise_sqdist, sqrt_rn
from unopose_tpu_torch.ops.hyp_select import hypothesis_select_scores_v2
from unopose_tpu_torch.ops.procrustes import kabsch_rotation_planar, weighted_procrustes


def searchsorted_cdf(cum: torch.Tensor, r: torch.Tensor, seg: int = 49, super_seg: int = 28) -> torch.Tensor:
    """Per-row searchsorted('left') of r (B, Q) into nondecreasing cum (B, N),
    three-level: super-segment edges, segment edges, one value window.
    Returns int32 (B, Q) in [0, N]."""
    B, N = cum.shape
    G = -(-N // seg)
    pad = G * seg - N
    if pad:
        cum = torch.cat([cum, cum[:, -1:].expand(B, pad)], dim=1)
    win = cum.reshape(B, G, seg)
    edges = win[:, :, -1]
    G1 = -(-G // super_seg)
    epad = G1 * super_seg - G
    edges_p = torch.cat([edges, edges[:, -1:].expand(B, epad)], dim=1) if epad else edges
    ewin = edges_p.reshape(B, G1, super_seg)
    super_edges = ewin[:, :, -1]
    n1 = (super_edges[:, None, :] < r[:, :, None]).sum(dim=-1, dtype=torch.int32)
    esel = gather_points(ewin, torch.clamp_max(n1, G1 - 1))
    n2 = (esel < r[..., None]).sum(dim=-1, dtype=torch.int32)
    nfull = torch.clamp_max(n1 * super_seg + n2, G)
    wsel = gather_points(win, torch.clamp_max(nfull, G - 1))
    cnt = (wsel < r[..., None]).sum(dim=-1, dtype=torch.int32)
    return torch.clamp_max(nfull * seg + cnt, N)


def dual_softmax_assignment(atten: torch.Tensor, score: torch.Tensor, n1: int, n2: int):
    """Dual softmax gated by the overlap-score outer product.

    atten (B, n1+1, n2+1) logits with bg row/column, score (B, n1+n2).
    Returns (pred, w1, w2, label1, label2).
    """
    B = atten.shape[0]
    atten = atten.float()
    ones = torch.ones((B, 1), dtype=torch.float32, device=atten.device)
    s1 = torch.cat([ones, score[:, :n1].float()], dim=1)
    s2 = torch.cat([ones, score[:, n1:].float()], dim=1)
    pred = torch.softmax(atten, dim=2) * torch.softmax(atten, dim=1)
    pred = pred * s1[:, :, None] * s2[:, None, :]
    label1 = torch.argmax(pred[:, 1:, :], dim=2)
    label2 = torch.argmax(pred[:, :, 1:], dim=1)
    return pred, (label1 > 0).float(), (label2 > 0).float(), label1, label2


def select_scores_plain(pts1, model_pts, rs, ts, w1) -> torch.Tensor:
    """The plain hypothesis selection (the JAX package's XLA pass): (B, P2)
    scores sum(w1) / (sum(w1 d) + 1e-8), d the distance of each transformed
    point (pts1 - t) R to its nearest model point, from the (B, P2, N1, M)
    expansion-form squared distances. pts1 (B, N1, 3), model_pts (B, M, 3),
    rs (B, P2, 3, 3), ts (B, P2, 3), w1 (B, N1)."""
    tp = torch.matmul(pts1[:, None] - ts[:, :, None, :], rs)  # (B, P2, N1, 3)
    d2 = pairwise_sqdist(tp, model_pts[:, None])  # (B, P2, N1, M)
    d = sqrt_rn(torch.clamp_min(d2.amin(dim=-1), 0.0))
    return w1.sum(dim=1)[:, None] / ((d * w1[:, None]).sum(dim=2) + 1e-8)


def compute_coarse_Rt_overlap(
    atten: torch.Tensor,
    score: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    n_proposal1: int = 6000,
    n_proposal2: int = 300,
    uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    model_pts: torch.Tensor | None = None,
    selection_chunks: int = 10,
):
    """RANSAC-like coarse pose search: sample 3 * n_proposal1 correspondences
    by inverse CDF, solve one rigid transform per triplet, keep the
    n_proposal2 with the lowest residual, return the one that scores best
    against ``model_pts`` (B, M, 3) (defaults to pts2).

    atten (B, N1+1, N2+1), score (B, N1+N2), pts1 (B, N1, 3), pts2 (B, N2, 3).
    ``uniforms`` (B, 3 * n_proposal1) in [0, 1), else drawn from ``generator``.
    Above 3e8 squared distances the plain selection splits the hypotheses
    into ``selection_chunks``. Returns R (B, 3, 3), t (B, 3), pose_score (B,)
    with p1 ~= R p2 + t.
    """
    pts1 = pts1.float()
    pts2 = pts2.float()
    B, N1, _ = pts1.shape
    N2 = pts2.shape[1]
    model_pts = pts2 if model_pts is None else model_pts.float()

    pred, w1, w2, _, _ = dual_softmax_assignment(atten, score, N1, N2)
    ps = (pred[:, 1:, 1:] * w1[:, :, None] * w2[:, None, :]).reshape(B, N1 * N2) ** 1.5
    cum = torch.cumsum(ps, dim=1)
    cum = cum / (cum[:, -1:] + 1e-8)
    if uniforms is None:
        uniforms = torch.rand((B, 3 * n_proposal1), generator=generator, device=pts1.device, dtype=torch.float32)
    elif tuple(uniforms.shape) != (B, 3 * n_proposal1):
        raise ValueError(f"uniforms must be {(B, 3 * n_proposal1)}, got {tuple(uniforms.shape)}")
    idx = searchsorted_cdf(cum, uniforms.to(pts1.device, torch.float32))
    idx1 = torch.clamp_max(idx // N2, N1 - 1)
    idx2 = idx % N2

    g1 = gather_points(pts1, idx1)  # (B, 3*P1, 3)
    g2 = gather_points(pts2, idx2)
    r_m = [tuple(g1[:, m::3, k] for k in range(3)) for m in range(3)]  # ref = pts1 triplets
    s_m = [tuple(g2[:, m::3, k] for k in range(3)) for m in range(3)]  # src = pts2 triplets

    third = 1.0 / 3.0
    cr = [(r_m[0][k] + r_m[1][k] + r_m[2][k]) * third for k in range(3)]
    cs = [(s_m[0][k] + s_m[1][k] + s_m[2][k]) * third for k in range(3)]
    dr = [[p[k] - cr[k] for k in range(3)] for p in r_m]
    ds = [[p[k] - cs[k] for k in range(3)] for p in s_m]
    H = [[(ds[0][i] * dr[0][j] + ds[1][i] * dr[1][j] + ds[2][i] * dr[2][j]) * third for j in range(3)] for i in range(3)]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = kabsch_rotation_planar(tuple(H[i][j] for i in range(3) for j in range(3)))
    tx = cr[0] - (r00 * cs[0] + r01 * cs[1] + r02 * cs[2])
    ty = cr[1] - (r10 * cs[0] + r11 * cs[1] + r12 * cs[2])
    tz = cr[2] - (r20 * cs[0] + r21 * cs[1] + r22 * cs[2])

    resid = torch.zeros_like(tx)
    for m in range(3):
        ux = r_m[m][0] - tx
        uy = r_m[m][1] - ty
        uz = r_m[m][2] - tz
        ex = ux * r00 + uy * r10 + uz * r20 - s_m[m][0]
        ey = ux * r01 + uy * r11 + uz * r21 - s_m[m][1]
        ez = ux * r02 + uy * r12 + uz * r22 - s_m[m][2]
        resid = resid + sqrt_rn(ex * ex + ey * ey + ez * ez)
    resid = resid * third

    keep = torch.topk(-resid, n_proposal2, dim=1).indices  # lowest residual

    def take(p):
        return torch.gather(p, 1, keep)

    rs = torch.stack(
        [
            torch.stack([take(r00), take(r01), take(r02)], dim=-1),
            torch.stack([take(r10), take(r11), take(r12)], dim=-1),
            torch.stack([take(r20), take(r21), take(r22)], dim=-1),
        ],
        dim=-2,
    )  # (B, P2, 3, 3)
    ts = torch.stack([take(tx), take(ty), take(tz)], dim=-1)[:, :, None, :]  # (B, P2, 1, 3)

    ts3 = ts[:, :, 0, :]
    if pts1.is_cuda and os.environ.get("UNOPOSE_HYPSEL_V2", "0") == "1":
        scores = hypothesis_select_scores_v2(pts1, model_pts, rs, ts3, w1)
    elif selection_chunks > 1 and B * n_proposal2 * N1 * model_pts.shape[1] > 300_000_000:
        chunk = -(-n_proposal2 // selection_chunks)
        scores = torch.cat([select_scores_plain(pts1, model_pts, rs[:, i: i + chunk], ts3[:, i: i + chunk], w1)
                            for i in range(0, n_proposal2, chunk)], dim=1)
    else:
        scores = select_scores_plain(pts1, model_pts, rs, ts3, w1)
    best = torch.argmax(scores, dim=1)
    ar = torch.arange(B, device=best.device)
    return rs[ar, best], ts[ar, best, 0], scores[ar, best]


def compute_fine_Rt_overlap(
    atten: torch.Tensor,
    score: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    model_pts: torch.Tensor | None = None,
    dis_thres: float = 0.15,
):
    """Weighted-SVD fine pose from the mutually consistent soft assignment.
    The pose score counts the foreground points within ``dis_thres`` of
    ``model_pts`` (default ``pts2``). Returns R (B, 3, 3), t (B, 3),
    pose_score (B,) and the max WSVD row weight (B,) (the JAX solver's
    ``return_aux=True`` outputs)."""
    pts1 = pts1.float()
    pts2 = pts2.float()
    model_pts = pts2 if model_pts is None else model_pts.float()
    B, N1, _ = pts1.shape
    N2 = pts2.shape[1]

    A, w1, w2, label1, _ = dual_softmax_assignment(atten, score, N1, N2)
    A = A[:, 1:, 1:] * w1[:, :, None] * w2[:, None, :]
    An = A / (A.sum(dim=2, keepdim=True) + 1e-6)
    pred_pts = torch.matmul(An, pts2)
    weights = A.sum(dim=2)

    R, t = weighted_procrustes(pred_pts, pts1, weights, weight_thresh=0.001)

    proj = torch.matmul(pts1 - t[:, None, :], R)
    d = sqrt_rn(torch.clamp_min(pairwise_sqdist(proj, model_pts).amin(dim=2), 0.0))
    mask = (label1 > 0).float()
    inlier = (d < dis_thres).float()
    pose_score = (inlier * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-8)
    pose_score = pose_score * mask.mean(dim=1)
    return R, t, pose_score, weights.amax(dim=1)
