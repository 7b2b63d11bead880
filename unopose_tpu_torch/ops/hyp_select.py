"""Fused coarse hypothesis selection (counterpart of
``unopose_tpu/ops/hyp_select.py:hypothesis_select_scores`` and
``unopose_tpu/ops/hyp_select2.py:hypothesis_select_scores_v2``).

Per cloud b and hypothesis h: the observed points brought into the model
frame, TP = (pts1 - t_h) R_h, each one's distance to its nearest model
point, d = sqrt(min over the model points of |tp - m|^2), and the score
sum(w1) / (sum(w1 d) + 1e-8). The (B, P2, N1, N2) distance tensor that the
plain selection of ``ops/solver.py`` materialises never exists.

- ``hypothesis_select_scores`` (row 18 of the TPU kernel table): TP in the
  kernel from bf16-rounded ``pts1 - t`` and bf16-rounded ``R`` with float32
  sums, as the TPU kernel computes it.
- ``hypothesis_select_scores_v2`` (row 19): TP by the caller's float32
  ``torch.matmul``, then the same selection. The coarse solver routes
  through it under ``UNOPOSE_HYPSEL_V2=1`` on a CUDA tensor.

Both compute d^2 as the direct difference ``(dx * dx + dy * dy) + dz * dz``
in float32, one rounded operation at a time (the JAX kernels' bf16x3 cross
term guards the expansion |x|^2 - 2 x.y + |y|^2 against cancellation; the
direct form has none), the min, then the square root, then the w1-weighted
sum over the rows in the kernel's order: row r goes to lane r % 32, each
lane adds its rows in order, and the 32 lanes are added by a butterfly
(xor 16, 8, 4, 2, 1). The plain twins (``*_plain``) repeat that order, so
on the same inputs they equal the kernel (``kernels/csrc/hyp_select.cu``,
K17) bit for bit. CPU tensors take the twins; CUDA tensors the kernel,
which raises on failure.
"""

from __future__ import annotations

import ctypes

import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.geometry import no_tf32, sqrt_rn

WARP = 32
HYP_CHUNK = 25  # hypotheses per step of the plain twins: bounds their (B, chunk, N1, N2) temporaries


def _check(pts1, model_pts, w1, rs, ts):
    if pts1.dim() != 3 or pts1.shape[-1] != 3 or model_pts.dim() != 3 or model_pts.shape[-1] != 3:
        raise ValueError(f"pts1 and model_pts must be (B, N, 3), got {tuple(pts1.shape)}, {tuple(model_pts.shape)}")
    B, N1, _ = pts1.shape
    if model_pts.shape[0] != B or tuple(w1.shape) != (B, N1):
        raise ValueError(f"model_pts (B, N2, 3) and w1 (B, N1) must match pts1 {tuple(pts1.shape)}")
    if rs.dim() != 4 or tuple(rs.shape[-2:]) != (3, 3) or rs.shape[0] != B or tuple(ts.shape) != (B, rs.shape[1], 3):
        raise ValueError(f"rs must be (B, P2, 3, 3) and ts (B, P2, 3), got {tuple(rs.shape)}, {tuple(ts.shape)}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def transform_bf16(pts1: torch.Tensor, rs: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Row 18's TP (B, P2, N1, 3): bf16(pts1 - t) times bf16(R), the three
    products (exact in float32) summed in order k = 0, 1, 2."""
    a = _bf16(pts1.float()[:, None] - ts.float()[:, :, None, :])  # (B, P2, N1, 3)
    r = _bf16(rs.float())  # (B, P2, 3, 3)
    return (a[..., 0:1] * r[:, :, None, 0] + a[..., 1:2] * r[:, :, None, 1]) + a[..., 2:3] * r[:, :, None, 2]


def transform_f32(pts1: torch.Tensor, rs: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Row 19's TP (B, P2, N1, 3): the caller's float32 product (pts1 - t) R."""
    with no_tf32():
        return torch.matmul(pts1.float()[:, None] - ts.float()[:, :, None, :], rs.float())


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order: lane r % 32, rows in
    order per lane, then the xor butterfly; lane 0's result."""
    n = x.shape[-1]
    pad = -n % WARP
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
    rows = x.view(*x.shape[:-1], -1, WARP)
    acc = rows[..., 0, :] + 0.0
    for k in range(1, rows.shape[-2]):
        acc = acc + rows[..., k, :]
    lane = torch.arange(WARP, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc[..., 0]


def dist_sums_plain(tp: torch.Tensor, model_pts: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """(B, P2) sums over the rows of w1 * sqrt(min_m |tp - m|^2), the
    direct difference in float32, in the kernel's order of operations."""
    tp, m, w1 = tp.float(), model_pts.float(), w1.float()
    mx, my, mz = (m[:, None, None, :, i] for i in range(3))  # (B, 1, 1, N2)
    out = []
    for h0 in range(0, tp.shape[1], HYP_CHUNK):
        c = tp[:, h0: h0 + HYP_CHUNK, :, None, :]  # (B, p, N1, 1, 3)
        dx, dy, dz = c[..., 0] - mx, c[..., 1] - my, c[..., 2] - mz
        d2 = (dx * dx + dy * dy) + dz * dz
        del dx, dy, dz
        d = sqrt_rn(d2.amin(dim=-1))  # (B, p, N1)
        del d2
        out.append(_lane_sum(d * w1[:, None, :]))
    return torch.cat(out, dim=1)


def _scores(w1: torch.Tensor, dsum: torch.Tensor) -> torch.Tensor:
    return w1.float().sum(dim=1)[:, None] / (dsum + 1e-8)


def hypothesis_select_scores_plain(pts1, model_pts, rs, ts, w1) -> torch.Tensor:
    """Row 18's plain twin: (B, P2) scores, TP from bf16 operands."""
    _check(pts1, model_pts, w1, rs, ts)
    return _scores(w1, dist_sums_plain(transform_bf16(pts1, rs, ts), model_pts, w1))


def hypothesis_select_scores_v2_plain(pts1, model_pts, rs, ts, w1) -> torch.Tensor:
    """Row 19's plain twin: (B, P2) scores, TP by the float32 product."""
    _check(pts1, model_pts, w1, rs, ts)
    return _scores(w1, dist_sums_plain(transform_f32(pts1, rs, ts), model_pts, w1))


# ------------------------------------------------------------------ on the card
def _dist_sums_cuda(mode: int, pts1, model_pts, w1, rs=None, ts=None, tp=None) -> torch.Tensor:
    """K17 (``csrc/hyp_select.cu``) in ``mode`` 0 (TP in the kernel from
    ``rs``, ``ts``) or 1 (``tp`` given): (B, P2) float32 distance sums."""
    dev = pts1.device
    given = [x for x in (pts1, model_pts, w1, rs, ts, tp) if x is not None]
    if dev.type != "cuda" or any(x.device != dev for x in given):
        raise ValueError("the hypothesis-selection kernel needs all tensors on one CUDA device")
    pts1, model_pts, w1 = (x.float().contiguous() for x in (pts1, model_pts, w1))
    B, N1, _ = pts1.shape
    N2 = model_pts.shape[1]
    if mode == 0:
        rs, ts = rs.float().contiguous(), ts.float().contiguous()
        P2 = rs.shape[1]
    else:
        tp = tp.float().contiguous()
        P2 = tp.shape[1]
    dsum = torch.empty((B, P2), dtype=torch.float32, device=dev)
    if B * P2 == 0:
        return dsum
    ptr = lambda x: ctypes.c_void_p(x.data_ptr() if x is not None else 0)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.unopose_hyp_select(ptr(pts1), ptr(rs), ptr(ts), ptr(tp), ptr(model_pts), ptr(w1), ptr(dsum),
                                     B, P2, N1, N2, mode, ctypes.c_void_p(build.stream_of(pts1)))
    build.check(err, "hyp_select")
    LAUNCHES["hyp_select" if mode == 0 else "hyp_select_v2"] += 1
    return dsum


def hypothesis_select_scores_cuda(pts1, model_pts, rs, ts, w1) -> torch.Tensor:
    """Row 18 on the card: K17 with TP computed in the kernel."""
    _check(pts1, model_pts, w1, rs, ts)
    return _scores(w1, _dist_sums_cuda(0, pts1, model_pts, w1, rs=rs, ts=ts))


def hypothesis_select_scores_v2_cuda(pts1, model_pts, rs, ts, w1) -> torch.Tensor:
    """Row 19 on the card: TP by ``torch.matmul``, then K17 reading it."""
    _check(pts1, model_pts, w1, rs, ts)
    return _scores(w1, _dist_sums_cuda(1, pts1, model_pts, w1, tp=transform_f32(pts1, rs, ts)))


def hypothesis_select_scores(pts1, model_pts, rs, ts, w1) -> torch.Tensor:
    """pts1 (B, N1, 3), model_pts (B, N2, 3), rs (B, P2, 3, 3), ts (B, P2, 3),
    w1 (B, N1) -> (B, P2) scores, TP from bf16 operands; by device."""
    if pts1.device.type == "cpu":
        return hypothesis_select_scores_plain(pts1, model_pts, rs, ts, w1)
    return hypothesis_select_scores_cuda(pts1, model_pts, rs, ts, w1)


def hypothesis_select_scores_v2(pts1, model_pts, rs, ts, w1) -> torch.Tensor:
    """As ``hypothesis_select_scores`` with TP by the float32 product; by device."""
    if pts1.device.type == "cpu":
        return hypothesis_select_scores_v2_plain(pts1, model_pts, rs, ts, w1)
    return hypothesis_select_scores_v2_cuda(pts1, model_pts, rs, ts, w1)
