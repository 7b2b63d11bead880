#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``unopose_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--batches 3]

Phases, each fatal on failure:

1. device check: a CUDA card must be present;
2. build the hand-written kernels (``unopose_tpu_torch/kernels/csrc``);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, with CUDA-event times, its bound and, where one
   PyTorch call computes the same function, that call's time:
   FPS and the gather equal indices / bitwise values, the first_k select
   every output equal; the int8 geometric embedding (32 x 197 x 197 x 256,
   bf16 model dtype) at most one step off on at most 0.1% of entries; the PE
   channels and MLP/pool (32 x 2048 x 256) on two kinds of cloud: the main
   path's uniform cubes, whose isotropic neighbourhoods nearly all fit one
   64-slot chunk and have ill-conditioned local frames (at most twice as
   many unequal bf16 entries as the plain version shows against itself one
   ulp up), and sphere surfaces with over 1000 points in each of the four
   tiers (99.9% of entries within one bf16 ulp, none more than 2^-5 off);
   on both the rel xyz channels bitwise equal and the MLP/pool, fed the
   plain channels, within 1e-2 of the output's max; the production path's
   fused attention (32 x 261 x 768 bf16, read in place from the qkv output;
   at least 99% of outputs bitwise equal, none more than one bf16 ulp of its
   row's largest output off; also the tiny hd 16 and the float32 variant)
   and the three sweeps of the fused assignment (16 pairs of 2049 x 2049,
   C 256), each sweep fed the plain twin's inputs, then the whole chain
   (labels equal on at least 99.9% of rows, weights and soft targets within
   1e-4 of their max on the rows whose labels agree);
4. one forced grouping overflow, through the plain and the fused PE: both
   must take the exact fallback (and with it the gather kernel), whose
   grouping equals the CPU plain version's;
5. the float32 slice, fused-matcher and production configs at a tiny width
   on the card (kernels) against the CPU (plain versions), same weights and
   draws: FPS indices and int8 embedding codes equal, the coarse attention
   within 1e-3 of its max, the coarse scores within 1e-4, the fine scores'
   median error under 5e-3 and 95th percentile under 5e-2 (the CPU slice
   tests' gates); on the production config also the fused assignment's
   labels on the CPU's projections (99% equal);
6. the three main paths at full width (ViT-B/14-reg4 at 224 px, 2048-point
   clouds, a 5000-point template, 6000/300 hypotheses, bf16, seeded random
   weights, batches of 16 pairs): ``slice_config()`` and
   ``fused_matcher_config()`` for 2 batches each, then
   ``production_config()`` for ``--batches``; finite, orthonormal poses;
   the launch counts are zeroed just before each path and read just after,
   and every kernel of the path must have launched.

Log lines are prefixed with the card's name and power limit. Before the
last line come one JSON line with the kernels' results and the raw
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 16
EARLY_BATCHES = 2  # full-width batches of the slice and fused-matcher paths; production takes --batches
# published H100 SXM peaks (dense): HBM bytes/s, float32 FFMA and bf16 tensor-core FLOP/s
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
# exponentials per second: 16 special-function results per clock per SM (CUDA programming guide,
# compute capability 9.0) x 132 SMs x the 1980 MHz boost clock
SFU_RATE = 16 * 132 * 1.98e9
# which TPU kernel each hand-written kernel replaces, and its source
KERNELS = {
    "fps": ("unopose_tpu_torch/kernels/csrc/fps.cu", "unopose_tpu/ops/fps.py:80"),
    "first_k_select": ("unopose_tpu_torch/kernels/csrc/first_k_select.cu", "unopose_tpu/ops/ball_query.py:175"),
    "gather_planar": ("unopose_tpu_torch/kernels/csrc/gather_planar.cu", "unopose_tpu/ops/gather_pallas.py:73"),
    "geo_rpe": ("unopose_tpu_torch/kernels/csrc/geo_rpe.cu", "unopose_tpu/ops/geo_fused.py:194"),
    "pe_channels": ("unopose_tpu_torch/kernels/csrc/pe_channels.cu", "unopose_tpu/ops/pe_fused.py:1000"),
    "pe_mlp_pool": ("unopose_tpu_torch/kernels/csrc/pe_mlp_pool.cu", "unopose_tpu/ops/pe_fused.py:1034"),
    "mha_fused": ("unopose_tpu_torch/kernels/csrc/vit_attn.cu", "unopose_tpu/ops/vit_attn.py:53"),
    "fine_assign_colstats": ("unopose_tpu_torch/kernels/csrc/fine_assign.cu", "unopose_tpu/ops/assignment_fused.py:48"),
    "fine_assign_labels": ("unopose_tpu_torch/kernels/csrc/fine_assign.cu", "unopose_tpu/ops/assignment_fused.py:83"),
    "fine_assign_accum": ("unopose_tpu_torch/kernels/csrc/fine_assign.cu", "unopose_tpu/ops/assignment_fused.py:122"),
}
FUSED = ("fps", "first_k_select", "geo_rpe", "pe_channels", "pe_mlp_pool")
PATH_KERNELS = {
    "slice": ("fps", "first_k_select", "gather_planar"),
    "fused_matchers": FUSED,
    "production": FUSED + ("mha_fused", "fine_assign_colstats", "fine_assign_labels", "fine_assign_accum"),
}


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Log:
    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float, peak_flops: float, exps: float = 0.0) -> dict:
    """The least time the card could take: bytes moved over the HBM rate or
    operations over the peak rate for their type (the tensor-core or float32
    operations, or the exponentials over ``SFU_RATE``), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, max(flops / peak_flops, exps / SFU_RATE) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def lrf_cloud(rng, dev, b: int, n: int):
    """Uniform clouds in a 0.2 m cube 0.6 m away, in their global LRF (the
    fine PE's and the FPS's inputs on the main path)."""
    import torch

    from unopose_tpu_torch.ops.lrf import global_lrf

    pts = rng.uniform(-0.1, 0.1, size=(b, n, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
    return global_lrf(torch.from_numpy(pts).to(dev))


def check_kernels(log, dev, seed: int) -> dict:
    """Phase 3 for FPS, the first_k select and the gather. Returns {kernel name: measurements}."""
    import torch

    from unopose_tpu_torch.ops.ball_query import (
        SELECT_KEYS, first_k_select_cuda, first_k_select_plain, permutation,
    )
    from unopose_tpu_torch.ops.fps import fps_cuda, fps_plain
    from unopose_tpu_torch.ops.gather import gather_planar_cuda, gather_planar_plain

    rng = np.random.default_rng(seed)
    results = {}

    # K1 FPS: template 16 x 5000 -> 2048, then both clouds 16 x 2048 -> 196
    worst = 0
    for b, n, k in ((BATCH, 5000, 2048), (BATCH, 2048, 196)):
        pts = lrf_cloud(rng, dev, b, n)
        got, ref = fps_cuda(pts, k), fps_plain(pts, k)
        torch.cuda.synchronize()
        mismatch = int((got.long() - ref.long()).abs().max())
        worst = max(worst, mismatch)
        ms, plain_ms = cuda_ms(lambda: fps_cuda(pts, k)), cuda_ms(lambda: fps_plain(pts, k), reps=2)
        # per point and step: 3 sub, 3 mul, 2 add, a min and an argmax compare
        fps_bound = bound(b * n * 12 + b * k * 4, 10.0 * b * (k - 1) * n, F32_FLOPS)
        log(f"fps {b}x{n}->{k}: max |index diff| {mismatch}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {fps_bound['bound_ms']:.4f} ms ({fps_bound['bound_by']})")
        if (b, n) == (BATCH, 5000):
            results["fps"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **fps_bound)
    if worst != 0:
        raise AssertionError("fps kernel indices differ from the plain version")
    results["fps"]["max_abs_err"] = float(worst)

    # K3 first_k select on both clouds of the PE: 32 x 2048, k1/k2 = 64/256
    B2, N, S = 2 * BATCH, 2048, 256
    pts = lrf_cloud(rng, dev, B2, N)
    perm, inv_perm = permutation(N, dev)
    pts_p = pts.index_select(1, perm.long())
    args = (pts, pts_p, perm, inv_perm, 0.1, 64, 0.2, S)
    got, ref = first_k_select_cuda(*args), first_k_select_plain(*args)
    torch.cuda.synchronize()
    errs = {k: int((got[k].long() - ref[k].long()).abs().max()) for k in SELECT_KEYS}
    ms, plain_ms = cuda_ms(lambda: first_k_select_cuda(*args)), cuda_ms(lambda: first_k_select_plain(*args), reps=3)
    log(f"first_k_select 32x2048 (64/256): max |diff| per output {errs}, overflow {bool(ref['overflow'])}, "
        f"mean r2 hits {ref['total2'].float().mean().item():.1f}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if any(errs.values()):
        raise AssertionError(f"first_k_select kernel differs from the plain version: {errs}")
    # reads both clouds and the permutations; writes idx_p (2 B), two masks (1 B each) and four (B, N) int32;
    # per pair: the dot product (5), d2 (3) and two radius compares
    select_bytes = B2 * N * 24 + 2 * N * 4 + B2 * N * S * 4 + 4 * B2 * N * 4
    results["first_k_select"] = dict(max_abs_err=float(max(errs.values())), ms=ms, plain_ms=plain_ms,
                                     library_ms=None, **bound(select_bytes, 10.0 * B2 * N * N, F32_FLOPS))

    # K2 gather: the PE's scale-2 slots, planes (32, 2048), idx (32, 2048, 256) int16
    planes = tuple(t.contiguous() for t in pts_p.unbind(-1))
    idx = ref["idx_p"]
    got, want = gather_planar_cuda(*planes, idx), gather_planar_plain(*planes, idx)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ms, plain_ms = cuda_ms(lambda: gather_planar_cuda(*planes, idx)), cuda_ms(lambda: gather_planar_plain(*planes, idx))
    # the library yardstick: one torch.gather over the stacked planes (inputs prepared outside the timing)
    stacked = torch.stack(planes)
    idx3 = idx.reshape(1, B2, -1).long().expand(3, -1, -1).contiguous()
    library_ms = cuda_ms(lambda: torch.gather(stacked, 2, idx3))
    log(f"gather_planar 32x2048x256 int16: bitwise {bitwise}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"torch.gather {library_ms:.3f} ms")
    if not bitwise:
        raise AssertionError("gather_planar kernel is not bitwise equal to the plain version")
    results["gather_planar"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                    **bound(idx.numel() * 2 + 3 * B2 * N * 4 + 3 * idx.numel() * 4, 0.0, F32_FLOPS))
    return results


def check_fused_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the fused matchers' kernels K4-K6 at the main path's shapes; K5 and K6
    also on sphere surfaces that fill every 64-slot tier."""
    import torch

    from unopose_tpu_torch.configs import surface_clouds
    from unopose_tpu_torch.models.embedding import GeometricStructureEmbedding, knn_anchor_vectors
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import permutation
    from unopose_tpu_torch.ops.geo_fused import build_taylor_table, geo_rpe_fused_cuda, geo_rpe_fused_plain

    rng = np.random.default_rng(seed + 3)
    torch.manual_seed(seed)
    results = {}

    # K4: both clouds' 196 FPS nodes in their LRF plus the (1, 1, 1) bg point, 256 channels, T = 128
    B2, N, D, T, k = 2 * BATCH, 197, 256, 128, 3
    nodes = lrf_cloud(rng, dev, B2, N - 1)
    points = torch.cat([torch.ones((B2, 1, 3), device=dev), nodes], dim=1)
    ge = GeometricStructureEmbedding(D, dtype=torch.bfloat16, d_index_max=float(2.1 * np.sqrt(3.0) / 0.2),
                                     fused_table=T, quant_int8=True).to(dev)
    factor_a = 180.0 / (ge.sigma_a * np.pi)
    _, ref_vec = knn_anchor_vectors(points, k)
    tab_d, scale_d = build_taylor_table(ge.proj_d.weight.t(), ge.proj_d.bias, ge.d_index_max, T)
    tab_a, scale_a = build_taylor_table(ge.proj_a.weight.t(), ge.proj_a.bias, float(np.pi * factor_a), T)
    args = (points, ref_vec, tab_d.detach(), tab_a.detach(), scale_d, scale_a, ge.sigma_d, factor_a, torch.bfloat16, True)
    with torch.no_grad():
        (e8, sc), (p8, psc) = geo_rpe_fused_cuda(*args), geo_rpe_fused_plain(*args)
        torch.cuda.synchronize()
        diff = (e8.int() - p8.int()).abs()
        share, worst = diff.gt(0).float().mean().item(), int(diff.max())
        ms, plain_ms = cuda_ms(lambda: geo_rpe_fused_cuda(*args)), cuda_ms(lambda: geo_rpe_fused_plain(*args), reps=3)
    log(f"geo_rpe 32x197x197x256 int8 (bf16 tables): {100 * share:.4f}% of entries differ, max {worst} step, "
        f"scale equal {torch.equal(sc, psc)}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if worst > 1 or share > 1e-3 or not torch.equal(sc, psc):
        raise AssertionError("geo_rpe kernel differs from the plain version beyond one step on 0.1% of entries")
    # writes the int8 embedding, reads the points, anchors and both (T, D) tables; per output entry
    # four 3-term stencils (5 operations each), the max over k, the sum and the quantisation
    geo_bytes = e8.numel() + points.numel() * 4 + ref_vec.numel() * 4 + 2 * T * D * 4 + D * 4
    results["geo_rpe"] = dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms, library_ms=None,
                              **bound(geo_bytes, 25.0 * e8.numel(), F32_FLOPS))

    # K5, K6 on the fine PE's input: both clouds, 32 x 2048, budgets 64/256
    pe = FinePositionalEncoding(256, fused=True).to(dev)
    mlp1, mlp2, packed = pe.folded_weights()
    iso = pe_kernels(dev, lrf_cloud(rng, dev, 2 * BATCH, 2048), mlp1, mlp2, packed)
    perm, _ = permutation(2048, "cpu")
    surf = pe_kernels(dev, torch.from_numpy(surface_clouds(rng, 2 * BATCH, perm.numpy())).to(dev), mlp1, mlp2, packed)
    for name, r in (("uniform cube", iso), ("sphere surfaces", surf)):
        log(f"PE on {name}: tiers (points needing 1/2/3/4 chunks of 64 slots) {r['hist']}, overflow {r['overflow']}, "
            f"mean r2 hits {r['mean_hits']:.1f}")
        log(f"pe_channels 32x2048x256 on {name}: {100 * r['equal']:.4f}% of needed bf16 entries equal, "
            f"{100 * r['within_ulp']:.4f}% within one bf16 ulp (plain vs itself one ulp up: {100 * r['spread']:.4f}% "
            f"equal), rel xyz bitwise {r['rel_bitwise']}, max |diff| {r['c_err']:.3e}, "
            f"kernel {r['c_ms']:.3f} ms, plain {r['c_plain']:.3f} ms")
        log(f"pe_mlp_pool 32x2048x256 on {name} (plain channels): max |diff| {r['m_err']:.3e} of max "
            f"{r['m_ref']:.3e}, kernel {r['m_ms']:.3f} ms, plain {r['m_plain']:.3f} ms")
        if r["overflow"] or not r["rel_bitwise"]:
            raise AssertionError(f"PE on {name}: grouping overflow or rel xyz channels not bitwise equal")
        if not r["m_err"] <= 1e-2 * r["m_ref"]:
            raise AssertionError(f"pe_mlp_pool on {name} differs from the plain version by more than 1e-2 of the max")
    # the LRF frames of the cube's isotropic neighbourhoods are ill conditioned: there the gate is the
    # plain version's own one-ulp spread (at most twice as many unequal entries)
    if 1.0 - iso["equal"] > 2.0 * (1.0 - iso["spread"]):
        raise AssertionError("pe_channels kernel differs from the plain version beyond its one-ulp spread")
    # on the surfaces every tier holds thousands of points and the frames are well conditioned: 99.9% of
    # entries within one bf16 ulp and none more than 2^-5 off (two ulps at the channels' largest magnitude, 2)
    if min(surf["hist"]) < 1000 or surf["within_ulp"] < 0.999 or surf["c_err"] > 2.0**-5:
        raise AssertionError("pe_channels kernel on the surfaces: a tier under 1000 points, or entries beyond "
                             "one bf16 ulp on more than 0.1%, or one more than 2^-5 off")
    # bounds: per needed slot, K5 reads 2 index + 2 x 2 weight bytes and writes 24 channel bytes (plus the
    # planes and centres) in ~160 float32 operations (both scales' moments, vote, x-axis sums, projections);
    # K6, per needed slot and scale: 2 x (6*32 + 32*64 + 64*128) bf16 tensor-core operations
    B2, N = 2 * BATCH, 2048
    ch_bound = lambda slots: bound(slots * (2 + 4 + 24) + 6 * B2 * N * 4 + B2 * N * 4, 160.0 * slots, F32_FLOPS)
    mlp_bound = lambda slots: bound(slots * (24 + 4) + B2 * N * (4 + 256 * 4),
                                    slots * 2 * 2 * (6 * 32 + 32 * 64 + 64 * 128), BF16_FLOPS)
    for name, err, ms, plain, bnd in (("pe_channels", "c_err", "c_ms", "c_plain", ch_bound),
                                      ("pe_mlp_pool", "m_err", "m_ms", "m_plain", mlp_bound)):
        # the main path's (cube) numbers, and beside them the surfaces'
        results[name] = dict(max_abs_err=iso[err], ms=iso[ms], plain_ms=iso[plain], library_ms=None,
                             **bnd(iso["slots"]), surface_max_abs_err=surf[err], surface_ms=surf[ms],
                             surface_plain_ms=surf[plain], surface_bound_ms=bnd(surf["slots"])["bound_ms"])
    return results


def ulp_bf16(x):
    """One bf16 step at |x| (float32 tensor)."""
    import torch

    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_production_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the production path's kernels: K7 (fused attention) and
    K8-K10 (the fused assignment's three sweeps) at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from unopose_tpu_torch.ops import assignment_fused as af
    from unopose_tpu_torch.ops.geometry import compute_feature_similarity
    from unopose_tpu_torch.ops.solver import compute_fine_Rt_overlap
    from unopose_tpu_torch.ops.vit_attn import mha_fused_cuda, mha_fused_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    results = {}

    # K7: the ViT-B attention of a 16-pair batch, 32 images x 261 tokens, 12 heads, read from the qkv output
    B2, N, H, hd = 2 * BATCH, 261, 12, 64
    D = H * hd
    with torch.no_grad():
        qkv = torch.randn(B2, N, 3 * D, device=dev, generator=gen).to(torch.bfloat16)
        q, k, v = qkv.split(D, dim=-1)
        got, want = mha_fused_cuda(q, k, v, H).float(), mha_fused_plain(q, k, v, H).float()
        torch.cuda.synchronize()
        equal = (got == want).float().mean().item()
        diff = (got - want).abs()
        ulps = (diff / ulp_bf16(torch.maximum(got.abs(), want.abs()).clamp_min(2.0**-126))).max().item()
        row_ulps = (diff / ulp_bf16(want.abs().amax(dim=-1, keepdim=True))).max().item()
        err = diff.max().item()
        ms, plain_ms = cuda_ms(lambda: mha_fused_cuda(q, k, v, H)), cuda_ms(lambda: mha_fused_plain(q, k, v, H), reps=3)
        qh, kh, vh = (x.reshape(B2, N, H, hd).transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        # the tiny config's hd 16 in bf16, and the float32 variant at the main shape
        small = torch.randn(4, 9, 96, device=dev, generator=gen).to(torch.bfloat16).split(32, dim=-1)
        s_got, s_want = mha_fused_cuda(*small, 2).float(), mha_fused_plain(*small, 2).float()
        s_ok = bool(((s_got - s_want).abs() <= ulp_bf16(s_want.abs().amax(dim=-1, keepdim=True))).all())
        q32, k32, v32 = (x.float() for x in (q, k, v))
        f_err = ((mha_fused_cuda(q32, k32, v32, H) - mha_fused_plain(q32, k32, v32, H)).abs().max()
                 / want.abs().max()).item()
    log(f"mha_fused 32x261x768 bf16 (12 heads, in place from qkv): {100 * equal:.4f}% of outputs bitwise equal, "
        f"max diff {ulps:.0f} bf16 ulps of the output ({row_ulps:.3f} of its row's largest), max |diff| {err:.3e}; "
        f"hd 16 within a row ulp {s_ok}; float32 variant rel {f_err:.2e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"SDPA {library_ms:.3f} ms")
    if equal < 0.99 or row_ulps > 1.0 or not s_ok or f_err > 1e-5:
        raise AssertionError("mha_fused kernel differs from the plain version beyond its gates")
    # reads q, k, v and writes o once; QK^T and PV on the tensor cores
    results["mha_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                equal_share=equal, max_ulps=ulps, max_row_ulps=row_ulps,
                                **bound(4 * B2 * N * D * 2, 2 * 2 * B2 * H * N * N * hd, BF16_FLOPS))
    del qkv, q, k, v, got, want, diff, qh, kh, vh, q32, k32, v32

    # K8-K10: 16 pairs of 2049 x 2049 at C 256: three quarters of the query rows match a reference row
    Bp, M, C = BATCH, 2049, 256
    with torch.no_grad():
        f2 = torch.randn(Bp, M, C, device=dev, generator=gen)
        f1 = torch.randn(Bp, M, C, device=dev, generator=gen)
        match = torch.randperm(M, device=dev, generator=gen)[: 3 * M // 4]
        f1[:, : len(match)] = f2[:, match] + 0.5 * f1[:, : len(match)]
        score = torch.rand(Bp, 2 * (M - 1), device=dev, generator=gen)
        pts1 = torch.rand(Bp, M - 1, 3, device=dev, generator=gen) * 2 - 1
        pts2 = torch.rand(Bp, M - 1, 3, device=dev, generator=gen) * 2 - 1
        f1n, f2n, s1, s2 = af.operands(f1, f2, score, 0.1)
        cm, cs = af.colstats_plain(f1n, f2n)
        rm, rs, l1, l2 = af.labels_plain(f1n, f2n, cm, cs, s1, s2)
        largs = (f1n, f2n, cm, cs, s1, s2)
        aargs = (f1n, f2n, cm, cs, s1, s2, rm, rs, l1, l2, pts2)
        g_cm, g_cs = af.colstats_cuda(f1n, f2n)
        g_rm, g_rs, g_l1, g_l2 = af.labels_cuda(*largs)
        g_w, g_n = af.accum_cuda(*aargs)
        p_w, p_n = af.accum_plain(*aargs)
        torch.cuda.synchronize()
        rel = lambda a, b: ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
        stats = dict(cm=rel(g_cm, cm), cs=rel(g_cs, cs), rm=rel(g_rm, rm), rs=rel(g_rs, rs))
        amax = lambda *pairs: max((a - b).abs().max().item() for a, b in pairs)
        errs = dict(colstats=amax((g_cm, cm), (g_cs, cs)), labels=amax((g_rm, rm), (g_rs, rs)),
                    accum=amax((g_w, p_w), (g_n, p_n)))
        l1_eq, l2_eq = (g_l1 == l1).float().mean().item(), (g_l2 == l2).float().mean().item()
        w_err = ((g_w - p_w).abs().max() / p_w.abs().max()).item()
        n_err = ((g_n - p_n).abs().max() / p_n.abs().max()).item()
        # the whole chain, kernels against plain twins
        pp, pw, pl = af.fine_assignment_fused_plain(f1, f2, score, pts2)
        gp, gw, gl = af.fine_assignment_fused_cuda(f1, f2, score, pts2)
        torch.cuda.synchronize()
        agree = gl == pl
        chain_l1 = agree.float().mean().item()
        chain_w = ((gw - pw).abs()[agree].max() / pw.abs().max()).item()
        chain_p = ((gp - pp).abs()[agree].max() / pp.abs().max()).item()
        live = (l1[:, 1:] > 0).sum(1).double() * (l2[:, 1:] > 0).sum(1).double()
        times = dict(
            colstats=(cuda_ms(lambda: af.colstats_cuda(f1n, f2n)),
                      cuda_ms(lambda: af.colstats_plain(f1n, f2n), reps=3)),
            labels=(cuda_ms(lambda: af.labels_cuda(*largs)), cuda_ms(lambda: af.labels_plain(*largs), reps=3)),
            accum=(cuda_ms(lambda: af.accum_cuda(*aargs)), cuda_ms(lambda: af.accum_plain(*aargs), reps=3)),
        )
        fused_ms = cuda_ms(lambda: af.compute_fine_Rt_overlap_fused(f1, f2, score, pts1, pts2))
        materialised_ms = cuda_ms(lambda: compute_fine_Rt_overlap(
            compute_feature_similarity(f1, f2, 0.1, True), score, pts1, pts2), reps=3)
    log(f"fine_assign 16x2049x2049 C 256, each sweep on the plain twin's inputs: rel err {stats}, label1 equal "
        f"{100 * l1_eq:.4f}%, label2 equal {100 * l2_eq:.4f}%, weights {w_err:.2e}, numerators {n_err:.2e} of max; "
        f"chain: label1 equal {100 * chain_l1:.4f}%, weights {chain_w:.2e}, soft targets {chain_p:.2e} of max on "
        f"agreeing rows; foreground rows {100 * (pl > 0).float().mean().item():.1f}%")
    log("fine_assign times (kernel, plain ms): " + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in times.items())
        + f"; fused solver {fused_ms:.3f} ms, materialised solver (similarity + dual softmax + WSVD) "
        f"{materialised_ms:.3f} ms")
    if max(stats.values()) > 1e-5 or min(l1_eq, l2_eq, chain_l1) < 0.999 or max(w_err, n_err, chain_w, chain_p) > 1e-4:
        raise AssertionError("fine_assign kernels differ from the plain versions beyond their gates")
    # operands read once (bf16), statistics and labels read or written once; each function needs the
    # logits once (K9's second sweep is its design's cost, not the function's): 2 B M^2 C bf16
    # tensor-core operations; K10 needs only the entries of live rows and columns
    opnd = 2 * Bp * M * C * 2
    rebuild = 2.0 * Bp * M * M * C
    ent = float(Bp) * M * M
    bounds = dict(
        colstats=bound(opnd + 2 * Bp * M * 4, rebuild, BF16_FLOPS, exps=ent),
        labels=bound(opnd + 4 * Bp * M * 4 + 2 * Bp * M * 4, rebuild, BF16_FLOPS, exps=3 * ent),
        accum=bound(opnd + 8 * Bp * M * 4 + Bp * M * 3 * 4 + 4 * Bp * M * 4, 2.0 * C * live.sum().item(), BF16_FLOPS,
                    exps=2 * live.sum().item()),
    )
    for name in ("colstats", "labels", "accum"):
        results[f"fine_assign_{name}"] = dict(
            max_abs_err=errs[name], ms=times[name][0], plain_ms=times[name][1], library_ms=None,
            materialised_solver_ms=materialised_ms, fused_solver_ms=fused_ms, **bounds[name])
    results["fine_assign_labels"].update(label1_equal=l1_eq, label2_equal=l2_eq)
    results["fine_assign_accum"].update(chain_label1_equal=chain_l1, chain_weights_rel=chain_w,
                                        chain_targets_rel=chain_p)
    return results


def pe_kernels(dev, pts, mlp1, mlp2, packed) -> dict:
    """K5 and K6 against their plain versions on one (32, 2048, 3) cloud,
    K6 fed the plain channels; the comparisons cover the slots each point
    needs. Returns the agreement measures, the tier histogram and the times."""
    import torch

    from unopose_tpu_torch.ops.ball_query import two_scale_group_first_k_packed_idx
    from unopose_tpu_torch.ops.pe_fused import (
        CHUNK, chunks_needed, pe_channels_cuda, pe_channels_plain, pe_mlp_pool_cuda, pe_mlp_pool_plain,
    )

    S = 256
    with torch.no_grad():
        planes, idx_p, w1, w2, total2, overflow = two_scale_group_first_k_packed_idx(0.1, 64, 0.2, S, pts)
        center = tuple(pts.unbind(-1))
        cargs = (planes, idx_p, w1, w2, total2, center, 0.1, 0.2)
        chans, pchans = pe_channels_cuda(*cargs), pe_channels_plain(*cargs)
        # the plain version's own spread: the same slots, coordinates one ulp up
        up = lambda x: torch.nextafter(x, torch.full_like(x, float("inf")))
        nchans = pe_channels_plain(tuple(map(up, planes)), idx_p, w1, w2, total2, tuple(map(up, center)), 0.1, 0.2)
        torch.cuda.synchronize()
        chunks = chunks_needed(total2, S)
        needed = torch.arange(S, device=dev)[None, None, :] < (chunks * CHUNK)[..., None]  # (B, P, S)
        a, b, n = chans[needed].float(), pchans[needed].float(), nchans[needed].float()
        diff = (a - b).abs()
        _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
        ulp = torch.ldexp(torch.ones_like(diff), e - 8)  # one bf16 step at the larger magnitude
        r = dict(
            equal=(a == b).float().mean().item(), within_ulp=(diff <= ulp).float().mean().item(),
            spread=(n == b).float().mean().item(), c_err=float(diff.max()),
            rel_bitwise=torch.equal(a[:, [0, 1, 2, 6, 7, 8]], b[:, [0, 1, 2, 6, 7, 8]]),
            hist=torch.bincount(chunks.flatten(), minlength=5)[1:].tolist(), slots=int(chunks.sum()) * CHUNK,
            overflow=bool(overflow), mean_hits=total2.float().mean().item(),
        )
        del nchans, a, b, n, diff, e, ulp
        r["c_ms"], r["c_plain"] = cuda_ms(lambda: pe_channels_cuda(*cargs)), cuda_ms(lambda: pe_channels_plain(*cargs), reps=3)
        margs = (pchans, w1, w2, total2)
        pooled, ppooled = pe_mlp_pool_cuda(*margs, packed), pe_mlp_pool_plain(*margs, mlp1, mlp2)
        torch.cuda.synchronize()
        r["m_err"], r["m_ref"] = float((pooled - ppooled).abs().max()), float(ppooled.abs().max())
        r["m_ms"] = cuda_ms(lambda: pe_mlp_pool_cuda(*margs, packed))
        r["m_plain"] = cuda_ms(lambda: pe_mlp_pool_plain(*margs, mlp1, mlp2), reps=3)
    return r


def check_overflow(log, dev, seed: int) -> None:
    """Phase 4: a dense cloud overflows the packed budget; the plain and the
    fused PE must take the exact fallback, and its grouping (gather kernel
    included) must equal the CPU plain one."""
    import torch

    from unopose_tpu_torch.kernels import LAUNCHES
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import first_k_in_radius, sqdist_expansion, two_scale_group_first_k_packed

    rng = np.random.default_rng(seed + 1)
    pts = torch.from_numpy(rng.uniform(-0.08, 0.08, size=(4, 2048, 3)).astype(np.float32))
    *_, overflow = two_scale_group_first_k_packed(0.1, 64, 0.2, 256, pts.to(dev))
    if not bool(overflow):
        raise AssertionError("the dense cloud did not overflow the packed grouping")
    for fused in (False, True):
        torch.manual_seed(seed)
        pe = FinePositionalEncoding(256, fused=fused).to(dev)
        before = LAUNCHES["gather_planar"]
        with torch.no_grad():
            feat = pe(pts.to(dev))
        torch.cuda.synchronize()
        gathers = LAUNCHES["gather_planar"] - before
        if pe.last_branch != "exact" or not torch.isfinite(feat).all() or gathers == 0:
            raise AssertionError(f"overflow fallback not taken, not finite or not gathered by the kernel "
                                 f"(fused={fused}): {pe.last_branch}, {gathers} gather launches")
        with torch.no_grad():
            feat_cpu = pe.cpu()(pts)
        err = (feat.cpu() - feat_cpu).abs().amax(-1)
        log(f"overflow ({'fused' if fused else 'plain'} PE): fallback taken ({pe.last_branch}), "
            f"{gathers} gather launches, PE vs CPU median row error {err.median().item():.2e}")
    for r, k in ((0.1, 64), (0.2, 256)):
        gpu = first_k_in_radius(sqdist_expansion(pts.to(dev), pts.to(dev)) < r * r, k).cpu()
        cpu = first_k_in_radius(sqdist_expansion(pts, pts) < r * r, k)
        if not torch.equal(gpu, cpu):
            raise AssertionError(f"exact grouping (r={r}, k={k}) differs between card and CPU")
    log("overflow: exact grouping equal to the CPU's")


def check_tiny(log, dev, seed: int, name: str) -> None:
    """Phase 5: a float32 tiny config, card (kernels) vs CPU (plain versions)."""
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.models import UNOPose

    cfg = configs.CONFIGS[name](tiny=True)
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg, torch.float32, torch.float32).eval()
    rng = np.random.default_rng(seed + 2)
    inputs = configs.synthetic_inputs(rng, 2, tiny=True)
    uniforms = torch.from_numpy(rng.uniform(size=(2, 3 * cfg.coarse_point_matching.nproposal1)).astype(np.float32))
    out_cpu = model({k: torch.from_numpy(v) for k, v in inputs.items()}, uniforms=uniforms, return_intermediates=True)
    branch_cpu = model.fine_matching.pe.last_branch
    model.to(dev)
    out_gpu = model({k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}, uniforms=uniforms.to(dev),
                    return_intermediates=True)
    idx_equal = all(torch.equal(out_gpu[k].cpu(), out_cpu[k]) for k in ("fps_idx_m", "fps_idx_o"))
    a_err = ((out_gpu["coarse_atten"].cpu() - out_cpu["coarse_atten"]).abs().max() / out_cpu["coarse_atten"].abs().max()).item()
    s_err = (out_gpu["coarse_score"].cpu() - out_cpu["coarse_score"]).abs().max().item()
    f_err = (out_gpu["fine_score"].cpu() - out_cpu["fine_score"]).abs().flatten()
    f_med, f_p95 = f_err.median().item(), f_err.quantile(0.95).item()
    geo_ok, geo_note = True, ""
    if isinstance(out_cpu["geo"], tuple):
        (e8, sc), (e8_cpu, sc_cpu) = (out_gpu["geo"][0].cpu(), out_gpu["geo"][1].cpu()), out_cpu["geo"]
        geo_diff = (e8.int() - e8_cpu.int()).abs()
        sc_rel = ((sc - sc_cpu).abs() / sc_cpu.abs()).max().item()
        geo_ok = int(geo_diff.max()) == 0 and sc_rel <= 1e-6
        geo_note = (f", int8 embedding entries differing {geo_diff.gt(0).float().mean().item():.2e} "
                    f"(max {int(geo_diff.max())}), scale rel {sc_rel:.2e}")
    labels_ok, labels_note = True, ""
    if "fine_proj" in out_cpu:
        from unopose_tpu_torch.ops.assignment_fused import fine_assignment_fused_cuda, fine_assignment_fused_plain

        args = (*out_cpu["fine_proj"], out_cpu["fine_score"], out_cpu["dense_po"])
        want = fine_assignment_fused_plain(*args)[2]
        got = fine_assignment_fused_cuda(*(x.to(dev) for x in args))[2].cpu()
        share = (got == want).float().mean().item()
        labels_ok, labels_note = share >= 0.99, f", fused assignment labels on the CPU's projections equal {share:.4f}"
    log(f"tiny fp32 {name}, card vs CPU: FPS indices equal {idx_equal}, coarse atten rel {a_err:.2e}, "
        f"coarse score {s_err:.2e}, fine score median {f_med:.2e} p95 {f_p95:.2e}, "
        f"PE branch {model.fine_matching.pe.last_branch}{geo_note}{labels_note}")
    if (not idx_equal or a_err > 1e-3 or s_err > 1e-4 or f_med >= 5e-3 or f_p95 >= 5e-2 or not geo_ok
            or not labels_ok or model.fine_matching.pe.last_branch != branch_cpu):
        raise AssertionError(f"the tiny {name} config on the card disagrees with the CPU plain path")


def run_path(log, dev, seed: int, batches: int, name: str) -> dict:
    """Phase 6: one main path at full width. Returns timing and its launch counts."""
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.models import UNOPose

    cfg = configs.CONFIGS[name]()
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg, torch.bfloat16, torch.bfloat16).to(dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    batch_inputs = [
        {k: torch.from_numpy(v).to(dev) for k, v in configs.synthetic_inputs(rng, BATCH).items()} for _ in range(batches)
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    times = []
    for i, inputs in enumerate(batch_inputs):
        t0 = time.perf_counter()
        out = model(inputs, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        R, t, score = out["pred_R"].double(), out["pred_t"], out["pred_pose_score"]
        eye = torch.eye(3, dtype=torch.float64, device=dev).expand_as(R)
        orth = (R @ R.transpose(1, 2) - eye).abs().max().item()
        det = (torch.linalg.det(R) - 1).abs().max().item()
        finite = bool(torch.isfinite(R).all() and torch.isfinite(t).all() and torch.isfinite(score).all())
        log(f"{name} batch {i}: {times[-1]:.1f} ms, PE branch {model.fine_matching.pe.last_branch}, "
            f"|RR^T - I| {orth:.2e}, |det - 1| {det:.2e}, finite {finite}, "
            f"pose score mean {score.mean().item():.3f}")
        if not finite or orth > 1e-3 or det > 1e-3 or tuple(R.shape) != (BATCH, 3, 3) or tuple(t.shape) != (BATCH, 3):
            raise AssertionError(f"{name} batch {i}: poses are not finite orthonormal (B, 3, 3) / (B, 3)")
    launches = dict(LAUNCHES)
    missing = [k for k in PATH_KERNELS[name] if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {name} path: {missing}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    log(f"{name}: ms per 16-pair batch {['%.1f' % x for x in times]} (first includes warm-up), "
        f"steady {steady:.1f} ms = {BATCH * 1e3 / steady:.1f} pairs/s, peak memory {peak:.2f} GiB, "
        f"launches {launches}")
    del model, batch_inputs
    torch.cuda.empty_cache()
    return dict(launches=launches, steady_ms=steady)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batches", type=int, default=3, help="full-width batches of the production path")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from unopose_tpu_torch.kernels import build

    card = card_info()
    log = Log(card)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s ({build.library_path().name})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    results = check_kernels(log, dev, args.seed)
    results.update(check_fused_kernels(log, dev, args.seed))
    results.update(check_production_kernels(log, dev, args.seed))
    check_overflow(log, dev, args.seed)
    for name in PATH_KERNELS:
        check_tiny(log, dev, args.seed, name)
    runs = {
        "slice": run_path(log, dev, args.seed, EARLY_BATCHES, "slice"),
        "fused_matchers": run_path(log, dev, args.seed, EARLY_BATCHES, "fused_matchers"),
        "production": run_path(log, dev, args.seed, args.batches, "production"),
    }

    kernels = []
    for name, (src, rep) in KERNELS.items():
        by_path = {p: run["launches"].get(name, 0) for p, run in runs.items() if name in PATH_KERNELS[p]}
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep, launches=sum(by_path.values()),
                            launches_by_path=by_path, **results[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
