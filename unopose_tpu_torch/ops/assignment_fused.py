"""Fused dual-softmax soft assignment of the fine stage (counterpart of
``unopose_tpu/ops/assignment_fused.py``), inference only.

From the projected fine features (bg token included) the fine solver needs
only, per query point, the row-normalised soft target point, the row sum of
the masked assignment (the Procrustes weight) and the foreground label.
The features are L2-normalised in float32, ``f1n / temp`` and ``f2n`` cast
to bf16, and the logits ``a = f1n f2nᵀ`` are products of those bf16
operands with float32 accumulation. Three stages, each with a plain
PyTorch twin and a kernel of ``kernels/csrc/fine_assign.cu``, replacing the
TPU kernels of ``unopose_tpu/ops/assignment_fused.py:fine_assignment_fused``:

- ``colstats`` (K8, ``_colstats_kernel``): per column the max and the sum of
  exp over the rows;
- ``labels`` (K9, ``_argmax_kernel``): per row the max and the sum of exp
  over the columns, ``pred = exp(a - rm) / rs * exp(a - cm) / max(cs,
  1e-30) * s1 * s2``, its first-occurrence argmax over the columns (label1)
  and over the rows (label2);
- ``accum`` (K10, ``_accum_kernel``): with the bg row and column stripped
  and the masks ``label1 > 0`` and ``label2 > 0`` applied, the row sums of
  ``pred`` and of ``pred * pts2``.

The plain twins materialise the (B, M1, M2) logits; the kernels rebuild
them tile by tile on the tensor cores and never store them.
``fine_assignment_fused`` dispatches on device: CPU tensors take
``fine_assignment_fused_plain``, CUDA tensors ``fine_assignment_fused_cuda``.
"""

from __future__ import annotations

import ctypes

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.geometry import no_tf32, pairwise_sqdist, sqrt_rn
from unopose_tpu_torch.ops.procrustes import weighted_procrustes

MAX_C = 256


def operands(feat1, feat2, score, temp: float):
    """(f1n, f2n, s1, s2): the normalised bf16 operands (B, M1, C), (B, M2, C)
    and the overlap scores with a leading 1 for the bg row and column,
    (B, M1) and (B, M2) float32. The divisions are by tensors: a CUDA
    division by a Python number would multiply by its reciprocal."""
    B, M1, C = feat1.shape
    M2 = feat2.shape[1]
    if feat2.shape != (B, M2, C) or score.shape != (B, M1 - 1 + M2 - 1):
        raise ValueError(f"feat1 (B, M1, C), feat2 (B, M2, C), score (B, M1 + M2 - 2) expected, got "
                         f"{tuple(feat1.shape)}, {tuple(feat2.shape)}, {tuple(score.shape)}")
    f1, f2 = feat1.float(), feat2.float()
    f1 = f1 / (torch.linalg.vector_norm(f1, dim=-1, keepdim=True) + 1e-12)
    f2 = f2 / (torch.linalg.vector_norm(f2, dim=-1, keepdim=True) + 1e-12)
    f1n = (f1 / torch.full((), temp, dtype=torch.float32, device=f1.device)).to(torch.bfloat16)
    ones = torch.ones((B, 1), dtype=torch.float32, device=f1.device)
    s1 = torch.cat([ones, score[:, : M1 - 1].float()], dim=1)
    s2 = torch.cat([ones, score[:, M1 - 1 :].float()], dim=1)
    return f1n, f2.to(torch.bfloat16), s1, s2


def _logits(f1n, f2n):
    with no_tf32():
        return torch.matmul(f1n.float(), f2n.float().transpose(1, 2))


def _pred(a, cm, cs, s1, s2, rm, rs):
    p_row = torch.exp(a - rm[:, :, None]) / rs[:, :, None]
    p_col = torch.exp(a - cm[:, None, :]) / torch.clamp_min(cs, 1e-30)[:, None, :]
    return p_row * p_col * s1[:, :, None] * s2[:, None, :]


def colstats_plain(f1n, f2n):
    """(cm, cs) (B, M2): each column's max logit and sum of exp(a - cm)."""
    a = _logits(f1n, f2n)
    cm = a.amax(dim=1)
    return cm, torch.exp(a - cm[:, None, :]).sum(dim=1)


def labels_plain(f1n, f2n, cm, cs, s1, s2):
    """(rm, rs, label1, label2): each row's max logit and sum of exp(a - rm)
    (B, M1), and the first-occurrence argmax of pred over the columns
    (label1, (B, M1) int32) and over the rows (label2, (B, M2) int32)."""
    a = _logits(f1n, f2n)
    rm = a.amax(dim=2)
    rs = torch.exp(a - rm[:, :, None]).sum(dim=2)
    pred = _pred(a, cm, cs, s1, s2, rm, rs)
    return rm, rs, pred.argmax(dim=2).to(torch.int32), pred.argmax(dim=1).to(torch.int32)


def _masks(label1, label2):
    w1 = (label1 > 0).float()
    w2 = (label2 > 0).float()
    w1[:, 0] = 0.0  # the bg row and column
    w2[:, 0] = 0.0
    return w1, w2


def _planes(pts2):
    """pts2 (B, M2 - 1, 3) -> three (B, M2) planes aligned to the columns (column 0, bg, is 0)."""
    p = torch.nn.functional.pad(pts2.float(), (0, 0, 1, 0))
    return p.unbind(-1)


def accum_plain(f1n, f2n, cm, cs, s1, s2, rm, rs, label1, label2, pts2):
    """(wsum (B, M1), num (B, M1, 3)): row sums of A' = pred with the masks
    ``label1 > 0`` (rows) and ``label2 > 0`` (columns), bg row and column at
    0, and of A' times each coordinate of pts2 (column j >= 1 is pts2[j - 1])."""
    w1, w2 = _masks(label1, label2)
    ap = _pred(_logits(f1n, f2n), cm, cs, s1, s2, rm, rs) * w1[:, :, None] * w2[:, None, :]
    num = torch.stack([(ap * p[:, None, :]).sum(dim=2) for p in _planes(pts2)], dim=-1)
    return ap.sum(dim=2), num


def _check_cuda(name, f1n, f2n, *rest):
    """Shapes (B, M1, M2, C) and the operands, contiguous and 16-byte aligned
    (the kernels stage rows in 16-byte vectors)."""
    if any(x.device.type != "cuda" or x.device != f1n.device for x in (f1n, f2n, *rest)):
        raise ValueError(f"{name} needs all tensors on one CUDA device")
    B, M1, C = f1n.shape
    M2 = f2n.shape[1]
    if f1n.dtype != torch.bfloat16 or f2n.dtype != torch.bfloat16 or f2n.shape != (B, M2, C):
        raise ValueError(f"{name} takes bf16 f1n (B, M1, C) and f2n (B, M2, C), got {f1n.dtype} "
                         f"{tuple(f1n.shape)}, {f2n.dtype} {tuple(f2n.shape)}")
    if C % 16 or not 16 <= C <= MAX_C or M1 < 1 or M2 < 2:
        raise ValueError(f"{name} takes C a multiple of 16 up to {MAX_C}, M1 >= 1, M2 >= 2 "
                         f"(C={C}, M1={M1}, M2={M2})")
    f1n, f2n = f1n.contiguous(), f2n.contiguous()
    if f1n.data_ptr() % 16 or f2n.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned operands")
    return (B, M1, M2, C), f1n, f2n


def _c(*tensors, dtype):
    """Contiguous copies in ``dtype`` (no copy where they already are)."""
    return tuple(x.to(dtype).contiguous() for x in tensors)


def _launch(name: str, *args):
    lib = build.load()
    ptr = ctypes.c_void_p
    dev = args[0].device
    with torch.cuda.device(dev):
        err = getattr(lib, f"unopose_fine_{name}")(
            *(ptr(a.data_ptr()) if torch.is_tensor(a) else a for a in args), ptr(build.stream_of(args[0]))
        )
    build.check(err, f"fine_assign_{name}")
    LAUNCHES[f"fine_assign_{name}"] += 1


def colstats_cuda(f1n, f2n):
    """K8 on the card: one block per (pair, 64-column tile)."""
    (B, M1, M2, C), f1n, f2n = _check_cuda("colstats_cuda", f1n, f2n)
    cm = torch.empty((B, M2), dtype=torch.float32, device=f1n.device)
    cs = torch.empty_like(cm)
    _launch("colstats", f1n, f2n, cm, cs, B, M1, M2, C)
    return cm, cs


def labels_cuda(f1n, f2n, cm, cs, s1, s2):
    """K9 on the card: one block per (pair, 64-row tile), four warps on its
    rows and one streaming f2's column tiles to them; label2 is decoded from
    the 64-bit keys the blocks reduce with atomicMax."""
    (B, M1, M2, C), f1n, f2n = _check_cuda("labels_cuda", f1n, f2n, cm, cs, s1, s2)
    if cm.shape != (B, M2) or cs.shape != (B, M2) or s1.shape != (B, M1) or s2.shape != (B, M2):
        raise ValueError("labels_cuda: cm, cs, s2 must be (B, M2) and s1 (B, M1)")
    cm, cs, s1, s2 = _c(cm, cs, s1, s2, dtype=torch.float32)
    rm = torch.empty((B, M1), dtype=torch.float32, device=f1n.device)
    rs = torch.empty_like(rm)
    label1 = torch.empty((B, M1), dtype=torch.int32, device=f1n.device)
    keys = torch.zeros((B, M2), dtype=torch.int64, device=f1n.device)
    _launch("labels", f1n, f2n, cm, cs, s1, s2, rm, rs, label1, keys, B, M1, M2, C)
    label2 = (M1 - 1 - (keys & 0xFFFFFFFF)).to(torch.int32)
    return rm, rs, label1, label2


def accum_cuda(f1n, f2n, cm, cs, s1, s2, rm, rs, label1, label2, pts2):
    """K10 on the card: one block per (pair, 64-row tile), four warps on its
    rows and one streaming f2's live column tiles to them, as K9's."""
    (B, M1, M2, C), f1n, f2n = _check_cuda("accum_cuda", f1n, f2n, cm, cs, s1, s2, rm, rs, label1, label2, pts2)
    if (cm.shape != (B, M2) or cs.shape != (B, M2) or s1.shape != (B, M1) or s2.shape != (B, M2)
            or rm.shape != (B, M1) or rs.shape != (B, M1) or label1.shape != (B, M1) or label2.shape != (B, M2)
            or pts2.shape != (B, M2 - 1, 3)):
        raise ValueError("accum_cuda: cm, cs, s2, label2 must be (B, M2), s1, rm, rs, label1 (B, M1) and pts2 "
                         "(B, M2 - 1, 3)")
    cm, cs, s1, s2, rm, rs, pts2 = _c(cm, cs, s1, s2, rm, rs, pts2, dtype=torch.float32)
    label1, label2 = _c(label1, label2, dtype=torch.int32)
    wsum = torch.empty((B, M1), dtype=torch.float32, device=f1n.device)
    num = torch.empty((B, M1, 3), dtype=torch.float32, device=f1n.device)
    _launch("accum", f1n, f2n, cm, cs, s1, s2, rm, rs, label1, label2, pts2, wsum, num, B, M1, M2, C)
    return wsum, num


def _assignment(stages, feat1, feat2, score, pts2, temp: float):
    colstats, labels, accum = stages
    f1n, f2n, s1, s2 = operands(feat1, feat2, score, temp)
    cm, cs = colstats(f1n, f2n)
    rm, rs, label1, label2 = labels(f1n, f2n, cm, cs, s1, s2)
    wsum, num = accum(f1n, f2n, cm, cs, s1, s2, rm, rs, label1, label2, pts2)
    weights = wsum[:, 1:]
    return num[:, 1:] / (weights[..., None] + 1e-6), weights, label1[:, 1:]


def fine_assignment_fused_plain(feat1, feat2, score, pts2, temp: float = 0.1):
    """feat1 (B, M1, C), feat2 (B, M2, C) projected fine features with the bg
    token, score (B, M1 - 1 + M2 - 1), pts2 (B, M2 - 1, 3) -> (pred_pts
    (B, M1 - 1, 3), weights (B, M1 - 1), label1 (B, M1 - 1) int32), through
    the plain twins."""
    return _assignment((colstats_plain, labels_plain, accum_plain), feat1, feat2, score, pts2, temp)


def fine_assignment_fused_cuda(feat1, feat2, score, pts2, temp: float = 0.1):
    """As ``fine_assignment_fused_plain``, through the three kernels."""
    return _assignment((colstats_cuda, labels_cuda, accum_cuda), feat1, feat2, score, pts2, temp)


def fine_assignment_fused(feat1, feat2, score, pts2, temp: float = 0.1):
    """The fused assignment, dispatched by device (module docstring)."""
    fn = fine_assignment_fused_plain if feat1.device.type == "cpu" else fine_assignment_fused_cuda
    return fn(feat1, feat2, score, pts2, temp)


def compute_fine_Rt_overlap_fused(feat1, feat2, score, pts1, pts2, temp: float = 0.1, dis_thres: float = 0.15):
    """``ops/solver.py:compute_fine_Rt_overlap`` on the projected features
    instead of the similarity matrix: weighted Procrustes of the soft targets
    (``weight_thresh=0.001``), the inlier pose score and the max row weight.
    Returns R (B, 3, 3), t (B, 3), pose_score (B,), max_w (B,)."""
    pts1, pts2 = pts1.float(), pts2.float()
    pred_pts, weights, label1 = fine_assignment_fused(feat1, feat2, score, pts2, temp)
    R, t = weighted_procrustes(pred_pts, pts1, weights, weight_thresh=0.001)
    proj = torch.matmul(pts1 - t[:, None, :], R)
    d = sqrt_rn(torch.clamp_min(pairwise_sqdist(proj, pts2).amin(dim=2), 0.0))
    mask = (label1 > 0).float()
    inlier = (d < dis_thres).float()
    pose_score = (inlier * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-8)
    return R, t, pose_score * mask.mean(dim=1), weights.amax(dim=1)
