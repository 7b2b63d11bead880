#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``unopose_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--batches 3]

Phases, each fatal on failure:

1. device check: a CUDA card must be present;
2. build the hand-written kernels (``unopose_tpu_torch/kernels/csrc``);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (FPS and the gather: equal indices / bitwise
   values; the first_k select: every output equal), with CUDA-event times;
4. one forced grouping overflow: the PE must take the exact fallback, whose
   grouping equals the CPU plain version's;
5. the float32 slice at a tiny width on the card (kernels) against the CPU
   (plain versions), same weights and draws;
6. the slice at full width (ViT-B/14-reg4 at 224 px, 2048-point clouds, a
   5000-point template, 6000/300 hypotheses, bf16), seeded random weights,
   ``--batches`` batches of 16 pairs; finite, orthonormal poses; every
   kernel launched during this phase.

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


def check_kernels(log, dev, seed: int) -> dict:
    """Phase 3. Returns {kernel name: {max_abs_err, ms, plain_ms}}."""
    import torch

    from unopose_tpu_torch.ops.ball_query import (
        SELECT_KEYS, first_k_select_cuda, first_k_select_plain, permutation,
    )
    from unopose_tpu_torch.ops.fps import fps_cuda, fps_plain
    from unopose_tpu_torch.ops.gather import gather_planar_cuda, gather_planar_plain
    from unopose_tpu_torch.ops.lrf import global_lrf

    rng = np.random.default_rng(seed)
    results = {}

    def cloud(b, n):
        pts = rng.uniform(-0.1, 0.1, size=(b, n, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
        return global_lrf(torch.from_numpy(pts).to(dev))

    # K1 FPS: template 16 x 5000 -> 2048, then both clouds 16 x 2048 -> 196
    worst = 0
    for b, n, k in ((BATCH, 5000, 2048), (BATCH, 2048, 196)):
        pts = cloud(b, n)
        got, ref = fps_cuda(pts, k), fps_plain(pts, k)
        torch.cuda.synchronize()
        mismatch = int((got.long() - ref.long()).abs().max())
        worst = max(worst, mismatch)
        ms, plain_ms = cuda_ms(lambda: fps_cuda(pts, k)), cuda_ms(lambda: fps_plain(pts, k), reps=2)
        log(f"fps {b}x{n}->{k}: max |index diff| {mismatch}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if (b, n) == (BATCH, 5000):
            results["fps"] = dict(ms=ms, plain_ms=plain_ms)
    if worst != 0:
        raise AssertionError("fps kernel indices differ from the plain version")
    results["fps"]["max_abs_err"] = float(worst)

    # K3 first_k select on both clouds of the PE: 32 x 2048, k1/k2 = 64/256
    pts = cloud(2 * BATCH, 2048)
    perm, inv_perm = permutation(2048, dev)
    pts_p = pts.index_select(1, perm.long())
    args = (pts, pts_p, perm, inv_perm, 0.1, 64, 0.2, 256)
    got, ref = first_k_select_cuda(*args), first_k_select_plain(*args)
    torch.cuda.synchronize()
    errs = {k: int((got[k].long() - ref[k].long()).abs().max()) for k in SELECT_KEYS}
    ms, plain_ms = cuda_ms(lambda: first_k_select_cuda(*args)), cuda_ms(lambda: first_k_select_plain(*args), reps=3)
    log(f"first_k_select 32x2048 (64/256): max |diff| per output {errs}, overflow {bool(ref['overflow'])}, "
        f"mean r2 hits {ref['total2'].float().mean().item():.1f}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if any(errs.values()):
        raise AssertionError(f"first_k_select kernel differs from the plain version: {errs}")
    results["first_k_select"] = dict(max_abs_err=float(max(errs.values())), ms=ms, plain_ms=plain_ms)

    # K2 gather: the PE's scale-2 slots, planes (32, 2048), idx (32, 2048, 256) int16
    planes = tuple(t.contiguous() for t in pts_p.unbind(-1))
    idx = ref["idx_p"]
    got, want = gather_planar_cuda(*planes, idx), gather_planar_plain(*planes, idx)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ms, plain_ms = cuda_ms(lambda: gather_planar_cuda(*planes, idx)), cuda_ms(lambda: gather_planar_plain(*planes, idx))
    log(f"gather_planar 32x2048x256 int16: bitwise {bitwise}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if not bitwise:
        raise AssertionError("gather_planar kernel is not bitwise equal to the plain version")
    results["gather_planar"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def check_overflow(log, dev, seed: int) -> None:
    """Phase 4: a dense cloud overflows the packed budget; the PE must take
    the exact fallback, and its grouping must equal the CPU plain one."""
    import torch

    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import first_k_in_radius, sqdist_expansion, two_scale_group_first_k_packed

    rng = np.random.default_rng(seed + 1)
    pts = torch.from_numpy(rng.uniform(-0.08, 0.08, size=(4, 2048, 3)).astype(np.float32))
    *_, overflow = two_scale_group_first_k_packed(0.1, 64, 0.2, 256, pts.to(dev))
    if not bool(overflow):
        raise AssertionError("the dense cloud did not overflow the packed grouping")
    torch.manual_seed(seed)
    pe = FinePositionalEncoding(256).to(dev)
    feat = pe(pts.to(dev))
    torch.cuda.synchronize()
    if pe.last_branch != "exact" or not torch.isfinite(feat).all():
        raise AssertionError(f"overflow fallback not taken or not finite: {pe.last_branch}")
    for r, k in ((0.1, 64), (0.2, 256)):
        gpu = first_k_in_radius(sqdist_expansion(pts.to(dev), pts.to(dev)) < r * r, k).cpu()
        cpu = first_k_in_radius(sqdist_expansion(pts, pts) < r * r, k)
        if not torch.equal(gpu, cpu):
            raise AssertionError(f"exact grouping (r={r}, k={k}) differs between card and CPU")
    feat_cpu = pe.cpu()(pts)
    err = (feat.cpu() - feat_cpu).abs().amax(-1)
    log(f"overflow: fallback taken ({pe.last_branch}), exact grouping equal to the CPU's, "
        f"PE vs CPU median row error {err.median().item():.2e}")


def check_tiny_slice(log, dev, seed: int) -> None:
    """Phase 5: float32 tiny slice, card (kernels) vs CPU (plain versions)."""
    import torch

    from unopose_tpu_torch.configs import slice_config, synthetic_inputs
    from unopose_tpu_torch.models import UNOPose

    cfg = slice_config(tiny=True)
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg, torch.float32, torch.float32).eval()
    rng = np.random.default_rng(seed + 2)
    inputs = synthetic_inputs(rng, 2, tiny=True)
    uniforms = torch.from_numpy(rng.uniform(size=(2, 3 * cfg.coarse_point_matching.nproposal1)).astype(np.float32))
    out_cpu = model({k: torch.from_numpy(v) for k, v in inputs.items()}, uniforms=uniforms, return_intermediates=True)
    model.to(dev)
    out_gpu = model({k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}, uniforms=uniforms.to(dev),
                    return_intermediates=True)
    idx_equal = all(torch.equal(out_gpu[k].cpu(), out_cpu[k]) for k in ("fps_idx_m", "fps_idx_o"))
    a_err = ((out_gpu["coarse_atten"].cpu() - out_cpu["coarse_atten"]).abs().max() / out_cpu["coarse_atten"].abs().max()).item()
    s_err = (out_gpu["coarse_score"].cpu() - out_cpu["coarse_score"]).abs().max().item()
    log(f"tiny fp32 slice, card vs CPU: FPS indices equal {idx_equal}, coarse atten rel {a_err:.2e}, "
        f"coarse score {s_err:.2e}")
    if not idx_equal or a_err > 1e-3 or s_err > 1e-4:
        raise AssertionError("the tiny slice on the card disagrees with the CPU plain path")


def run_slice(log, dev, seed: int, batches: int) -> dict:
    """Phase 6: the full-width slice. Returns timing and counts."""
    import torch

    from unopose_tpu_torch.configs import slice_config, synthetic_inputs
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.models import UNOPose

    cfg = slice_config()
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg, torch.bfloat16, torch.bfloat16).to(dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    batch_inputs = [
        {k: torch.from_numpy(v).to(dev) for k, v in synthetic_inputs(rng, BATCH).items()} for _ in range(batches)
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
        log(f"batch {i}: {times[-1]:.1f} ms, PE branch {model.fine_matching.pe.last_branch}, "
            f"|RR^T - I| {orth:.2e}, |det - 1| {det:.2e}, finite {finite}, "
            f"pose score mean {score.mean().item():.3f}")
        if not finite or orth > 1e-3 or det > 1e-3 or tuple(R.shape) != (BATCH, 3, 3) or tuple(t.shape) != (BATCH, 3):
            raise AssertionError(f"batch {i}: poses are not finite orthonormal (B, 3, 3) / (B, 3)")
    launches = dict(LAUNCHES)
    missing = [k for k in ("fps", "gather_planar", "first_k_select") if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    log(f"slice: ms per 16-pair batch {['%.1f' % x for x in times]} (first includes warm-up), "
        f"steady {steady:.1f} ms = {BATCH * 1e3 / steady:.1f} pairs/s, peak memory {peak:.2f} GiB, "
        f"launches {launches}")
    return dict(launches=launches, steady_ms=steady)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batches", type=int, default=3)
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
    check_overflow(log, dev, args.seed)
    check_tiny_slice(log, dev, args.seed)
    run = run_slice(log, dev, args.seed, args.batches)

    sources = {
        "fps": ("unopose_tpu_torch/kernels/csrc/fps.cu", "unopose_tpu/ops/fps.py:80"),
        "gather_planar": ("unopose_tpu_torch/kernels/csrc/gather_planar.cu", "unopose_tpu/ops/gather_pallas.py:73"),
        "first_k_select": ("unopose_tpu_torch/kernels/csrc/first_k_select.cu", "unopose_tpu/ops/ball_query.py:175"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=run["launches"][name], **results[name])
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
