"""Training losses: the overlap (predator) BCE and the bidirectional
correspondence cross-entropy (counterpart of ``unopose_tpu/losses.py``:
``weighted_bce``, ``_softmax_ce_with_labels``, ``compute_overlap_loss``,
``process_loss``). Per-sample values; ``process_loss`` averages and sums them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from unopose_tpu_torch.ops.fps import gather_points
from unopose_tpu_torch.ops.geometry import pairwise_sqdist


def weighted_bce(prediction: torch.Tensor, gt: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Class-balanced binary cross entropy of (B, N) predictions in [0, 1]:
    positives weighted by the negative fraction and vice versa. (B,) means."""
    p = torch.clamp(prediction.float(), eps, 1.0 - eps)
    ce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    w_neg = gt.mean(dim=1, keepdim=True)
    w_pos = 1.0 - w_neg
    weights = torch.where(gt >= 0.5, w_pos, w_neg)
    return (weights * ce).mean(dim=1)


def softmax_ce_with_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy over the last axis at integer labels; (B, N) -> (B,) means."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels.long()[..., None], dim=-1)[..., 0].mean(dim=-1)


def compute_overlap_loss(
    atten_list: Sequence[torch.Tensor],
    score_list: Sequence[torch.Tensor],
    saliency_list: Sequence[torch.Tensor],
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    gt_r: torch.Tensor,
    gt_t: torch.Tensor,
    predator_thres: float = 0.15,
    dis_thres: float = 0.15,
    loss_str: str = "coarse",
) -> Dict[str, torch.Tensor]:
    """The ground-truth overlap (a point of either cloud with a counterpart
    within ``predator_thres`` under the ground-truth pose) against every
    block's overlap scores and saliencies (weighted BCE), and the similarity
    logits against the nearest-point labels (bg class 0, label = nearest
    index + 1 within ``dis_thres``) in both directions; plus the last
    block's accuracy, foreground count and mean foreground distance."""
    out: Dict[str, torch.Tensor] = {}
    pts1, pts2 = pts1.float(), pts2.float()
    gt_pts = torch.matmul(pts1 - gt_t[:, None, :].float(), gt_r.float())
    dis_mat = torch.sqrt(pairwise_sqdist(gt_pts, pts2))  # (B, n1, n2)

    ov1 = (dis_mat <= predator_thres).any(dim=2)
    ov2 = (dis_mat <= predator_thres).any(dim=1)
    gt_overlap = torch.cat([ov1, ov2], dim=1).float()
    for idx, score in enumerate(score_list):
        out[f"{loss_str}_score_loss{idx}"] = weighted_bce(score, gt_overlap)
    for idx, sal in enumerate(saliency_list):
        out[f"{loss_str}_saliency_loss{idx}"] = weighted_bce(sal, gt_overlap)

    dis1, lab1 = dis_mat.min(dim=2)
    label1 = torch.where(dis1 <= dis_thres, lab1 + 1, 0)  # (B, n1) in [0, n2]
    dis2, lab2 = dis_mat.min(dim=1)
    label2 = torch.where(dis2 <= dis_thres, lab2 + 1, 0)  # (B, n2) in [0, n1]
    for idx, atten in enumerate(atten_list):
        l1 = softmax_ce_with_labels(atten[:, 1:, :], label1)
        l2 = softmax_ce_with_labels(atten[:, :, 1:].transpose(1, 2), label2)
        out[f"{loss_str}_atten_loss{idx}"] = 0.5 * (l1 + l2)

    with torch.no_grad():
        pred_label = atten_list[-1][:, 1:, :].argmax(dim=2)  # (B, n1)
        out[f"{loss_str}_acc"] = (pred_label == label1).float().mean(dim=1)
        fg_mask = (pred_label > 0).float()
        out[f"{loss_str}_fg_num"] = fg_mask.sum(dim=1)
        fg_label = (fg_mask * (pred_label - 1)).long()
        pred_dis = torch.linalg.vector_norm(gather_points(pts2, fg_label) - gt_pts, dim=2)
        out[f"{loss_str}_dis"] = (pred_dis * fg_mask).sum(dim=1) / (fg_mask.sum(dim=1) + 1e-8)
    return out


def process_loss(end_points: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Batch mean of every coarse_* / fine_* key; ``loss`` is the batch mean
    of the per-sample sum of the keys containing "loss", clamped at 100."""
    out = {}
    total = 0.0
    for key in sorted(end_points):
        if "coarse_" in key or "fine_" in key:
            out[key] = end_points[key].mean()
            if "loss" in key:
                total = total + end_points[key]
    out["loss"] = torch.clamp(total, max=100.0).mean()
    return out
