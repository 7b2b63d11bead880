"""Fused geometric structure embedding: distance + k-NN angle RPE from
pre-projected tables (counterpart of ``unopose_tpu/ops/geo_fused.py``).

For a statically bounded index domain [0, x_max], ``f(x) = sinusoid(x) @ W + b``
is a fixed curve per forward; ``build_taylor_table`` samples it on a T-point
grid after the projection, and the embedding evaluates it by a 3-point
quadratic Lagrange stencil around the nearest grid point. The angles use a
branchless polynomial atan, ``atan2_pos_sin``, as the JAX package does.

``geo_rpe_fused`` dispatches on device: CPU tensors take the plain
``geo_rpe_fused_plain``; CUDA tensors the kernel ``kernels/csrc/geo_rpe.cu``
through ``geo_rpe_fused_cuda``, which replaces the TPU kernel
``unopose_tpu/ops/geo_fused.py:geo_rpe_fused``. Both write either output
of the JAX kernel: the production int8 codes (``quantize``) or the
embedding in ``out_dtype``, float32 or bf16; the CPU tests hold the plain
version's outputs against the JAX package's. Both round at the same
points: the stencil weights and the tables are cast to the contraction
dtype (bf16 unless the output is float32), each product is exact in float32,
and the three terms are summed left to right. The int8 output rounds half
to even, like ``jnp.round``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from unopose_tpu_torch.kernels import LAUNCHES
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.geometry import no_tf32, sqrt_rn

MAX_N = 512  # the largest cloud the kernel takes (its first version's shared-memory bound, kept)
MAX_K = 4
MAX_T = 128


def atan_poly01(u: torch.Tensor) -> torch.Tensor:
    """Near-minimax atan on u in [0, 1] (max error ~2.9e-7 rad)."""
    u2 = u * u
    p = -0.005021087850713095
    p = 0.025331775490924545 + u2 * p
    p = -0.06087457203230464 + u2 * p
    p = 0.10002210544512247 + u2 * p
    p = -0.14047822793196393 + u2 * p
    p = 0.1997402878865833 + u2 * p
    p = -0.33332232628435243 + u2 * p
    p = 0.9999999227777523 + u2 * p
    return u * p


def atan2_pos_sin(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Branchless atan2(s, c) for s >= 0, in [0, pi]. The caller maps the
    degenerate (0, 0) input to angle 0 beforehand."""
    ac = c.abs()
    lo = torch.minimum(s, ac)
    hi = torch.clamp_min(torch.maximum(s, ac), 1e-30)
    a = atan_poly01(lo / hi)
    a = torch.where(s > ac, np.float32(np.pi / 2).item() - a, a)
    return torch.where(c < 0, np.float32(np.pi).item() - a, a)


def build_taylor_table(W: torch.Tensor, b: torch.Tensor, x_max: float, T: int):
    """(T, D) float32 table of f(grid) = sinusoid(grid) @ W + b on a uniform
    grid over [0, x_max], and its scale 1 / h (grid position = x * scale).
    W (D_sin, D) in the concatenated [sin..., cos...] layout. The T x D_sin x D
    product is computed in full float32 (TF32 off): its values anchor the
    whole reconstruction."""
    D_sin = W.shape[0]
    dev = W.device
    om = torch.exp(torch.arange(0, D_sin, 2, dtype=torch.float32, device=dev) * float(-np.log(10000.0) / D_sin))
    h = x_max / (T - 1)
    grid = torch.arange(T, dtype=torch.float32, device=dev) * h
    arg = grid[:, None] * om[None, :]
    f0 = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    with no_tf32():
        t0 = torch.matmul(f0, W.float())
    return t0 + b.float(), float(1.0 / h)


def _mm_dtype(out_dtype: torch.dtype) -> torch.dtype:
    """Contraction dtype of the stencil: float32 for a float32 output, else bf16."""
    return torch.float32 if out_dtype == torch.float32 else torch.bfloat16


def quant_scales(tab_d: torch.Tensor, tab_a: torch.Tensor):
    """(qscale, scale) of the symmetric per-channel int8 output:
    |e[..., c]| <= 1.25 (max_t |tab_d[t, c]| + max_t |tab_a[t, c]|), 1.25
    being the largest Lagrange |weight| sum, so e * qscale stays in [-127, 127]."""
    bound = 1.25 * (tab_d.abs().amax(dim=0) + tab_a.abs().amax(dim=0))
    qscale = (127.0 / torch.clamp_min(bound, 1e-20)).float()
    return qscale, (1.0 / qscale).float()


def _stencil(pos: torch.Tensor, T: int, mm_dtype: torch.dtype):
    """Grid positions -> (q, (l_m, l_0, l_p)) of the centred quadratic stencil,
    the weights rounded to ``mm_dtype`` and returned as float32."""
    pos = torch.clamp(pos, 0.0, T - 1.0)
    q = torch.clamp(torch.floor(pos + 0.5), 1.0, T - 2.0)
    r = pos - q
    ws = (0.5 * r * (r - 1.0), 1.0 - r * r, 0.5 * r * (r + 1.0))
    return q.long(), tuple(w.to(mm_dtype).float() for w in ws)


def _taylor_eval(pos: torch.Tensor, tab: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    """pos (...) in grid units -> (..., D) float32: l_m T[q-1] + l_0 T[q] + l_p T[q+1]."""
    q, (lm, l0, lp) = _stencil(pos, tab.shape[0], mm_dtype)
    tab = tab.to(mm_dtype).float()
    return (lm[..., None] * tab[q - 1] + l0[..., None] * tab[q]) + lp[..., None] * tab[q + 1]


def _check(points, ref_vec, tab_d, tab_a):
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    B, N, _ = points.shape
    if ref_vec.dim() != 4 or ref_vec.shape[:2] != (B, N) or ref_vec.shape[3] != 3:
        raise ValueError(f"ref_vec must be (B, N, k, 3), got {tuple(ref_vec.shape)} for points {tuple(points.shape)}")
    if tab_d.shape != tab_a.shape or tab_d.dim() != 2 or tab_d.shape[0] < 3:
        raise ValueError(f"tables must share a (T >= 3, D) shape, got {tuple(tab_d.shape)}, {tuple(tab_a.shape)}")


def geo_rpe_fused_plain(points, ref_vec, tab_d, tab_a, scale_d: float, scale_a: float, sigma_d: float,
                        factor_a: float, out_dtype: torch.dtype = torch.float32, quantize: bool = False):
    """Plain PyTorch embedding: points (B, N, 3), anchor vectors ref_vec
    (B, N, k, 3), tables (T, D) -> (B, N, N, D) in ``out_dtype``, or with
    ``quantize`` (e8 (B, N, N, D) int8, scale (D,) float32)."""
    _check(points, ref_vec, tab_d, tab_a)
    points, ref_vec = points.float(), ref_vec.float()
    tab_d, tab_a = tab_d.float(), tab_a.float()
    mm = _mm_dtype(out_dtype)
    ax = points[:, None, :, 0] - points[:, :, None, 0]  # (B, N, N): p_j - p_i
    ay = points[:, None, :, 1] - points[:, :, None, 1]
    az = points[:, None, :, 2] - points[:, :, None, 2]
    d = sqrt_rn(ax * ax + ay * ay + az * az)
    e = _taylor_eval(d * float(1.0 / sigma_d * scale_d), tab_d, mm)
    acc_a = None
    for kk in range(ref_vec.shape[2]):
        vx, vy, vz = (ref_vec[:, :, kk, i][:, :, None] for i in range(3))
        cxp = vy * az - vz * ay
        cyp = vz * ax - vx * az
        czp = vx * ay - vy * ax
        sin_v = sqrt_rn(cxp * cxp + cyp * cyp + czp * czp)
        cos_v = vx * ax + vy * ay + vz * az
        cos_v = torch.where((sin_v == 0.0) & (cos_v == 0.0), torch.ones_like(cos_v), cos_v)
        a_idx = atan2_pos_sin(sin_v, cos_v) * float(factor_a)
        ek = _taylor_eval(a_idx * float(scale_a), tab_a, mm)
        acc_a = ek if acc_a is None else torch.maximum(acc_a, ek)
        del ek
    e = e + acc_a
    if not quantize:
        return e.to(out_dtype)
    qscale, scale = quant_scales(tab_d, tab_a)
    e8 = torch.clamp(torch.round(e * qscale), -127.0, 127.0).to(torch.int8)
    return e8, scale


VALUE_DTYPES = (torch.float32, torch.bfloat16)  # the value stores of the kernel


def kernel_args(points, ref_vec, tab_d, tab_a, scale_d: float, scale_a: float, sigma_d: float, factor_a: float,
                out_dtype: torch.dtype, quantize: bool = True):
    """(args, scale): the arguments before the stream, tensors in place of
    their pointers (the output allocated), of ``unopose_geo_rpe`` (the int8
    codes; ``scale`` the dequantisation scale) or, without ``quantize``, of
    ``unopose_geo_rpe_values`` (the embedding in ``out_dtype``; ``scale``
    None)."""
    B, N, _ = points.shape
    k = ref_vec.shape[2]
    T, D = tab_d.shape
    mm = _mm_dtype(out_dtype)
    points, ref_vec = points.float().contiguous(), ref_vec.float().contiguous()
    tab_d, tab_a = tab_d.float(), tab_a.float()
    # the kernel reads float32 tables already rounded to the contraction dtype
    kd, ka = (t.to(mm).float().contiguous() for t in (tab_d, tab_a))
    consts = (float(1.0 / sigma_d * scale_d), float(scale_a), float(factor_a))
    if not quantize:
        out = torch.empty((B, N, N, D), dtype=out_dtype, device=points.device)
        return (points, ref_vec, kd, ka, out, B, N, k, T, D, int(out_dtype == torch.bfloat16), *consts), None
    qscale, scale = quant_scales(tab_d, tab_a)
    out = torch.empty((B, N, N, D), dtype=torch.int8, device=points.device)
    return (points, ref_vec, kd, ka, qscale, out, B, N, k, T, D, int(mm == torch.bfloat16), *consts), scale


def geo_rpe_fused_cuda(points, ref_vec, tab_d, tab_a, scale_d: float, scale_a: float, sigma_d: float,
                       factor_a: float, out_dtype: torch.dtype = torch.float32, quantize: bool = False):
    """The embedding on the card (``csrc/geo_rpe.cu``): resident blocks,
    each with a channel tile of both tables in shared memory (bf16 tables of
    256 channels for the bf16 contraction), whose warps walk units of one row
    and 32 columns. With ``quantize`` returns (e8, scale) and ``out_dtype``
    picks the contraction dtype; without, the (B, N, N, D) embedding in
    ``out_dtype``, float32 or bf16, as the plain version gives it."""
    _check(points, ref_vec, tab_d, tab_a)
    tensors = (points, ref_vec, tab_d, tab_a)
    if any(x.device.type != "cuda" or x.device != points.device for x in tensors):
        raise ValueError("geo_rpe_fused_cuda needs all tensors on one CUDA device")
    _, N, _ = points.shape
    k = ref_vec.shape[2]
    T, D = tab_d.shape
    if N > MAX_N or not 1 <= k <= MAX_K or T > MAX_T or D % 32:
        raise ValueError(f"geo_rpe_fused_cuda supports N <= {MAX_N}, 1 <= k <= {MAX_K}, T <= {MAX_T}, "
                         f"D % 32 == 0 (N={N}, k={k}, T={T}, D={D})")
    if not quantize and out_dtype not in VALUE_DTYPES:
        raise ValueError(f"geo_rpe_fused_cuda writes int8 codes or float32 / bf16 values, not {out_dtype}")
    args, scale = kernel_args(points, ref_vec, tab_d, tab_a, scale_d, scale_a, sigma_d, factor_a, out_dtype,
                              quantize)
    lib = build.load()
    entry = lib.unopose_geo_rpe if quantize else lib.unopose_geo_rpe_values
    with torch.cuda.device(points.device):
        err = entry(*(ctypes.c_void_p(a.data_ptr()) if torch.is_tensor(a) else a for a in args),
                    ctypes.c_void_p(build.stream_of(points)))
    build.check(err, "geo_rpe")
    LAUNCHES["geo_rpe"] += 1
    out = args[5] if quantize else args[4]
    return (out, scale) if quantize else out


def geo_rpe_fused(points, ref_vec, tab_d, tab_a, scale_d: float, scale_a: float, sigma_d: float,
                  factor_a: float, out_dtype: torch.dtype = torch.float32, quantize: bool = False):
    """Fused distance + angle RPE, dispatched by device (see module docstring)."""
    fn = geo_rpe_fused_plain if points.device.type == "cpu" else geo_rpe_fused_cuda
    return fn(points, ref_vec, tab_d, tab_a, scale_d, scale_a, sigma_d, factor_a, out_dtype, quantize)
