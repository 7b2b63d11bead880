"""Flagship benchmark of the port: query-reference pairs a second for the full UNOPose inference on one CUDA
card (counterpart of the JAX package's ``bench.py``).

    python -m unopose_tpu_torch.bench

Times the production model (``configs.production_config()``, the JAX package's ``get_cfg()``: both ViT-B/14
forwards with W8A8 GEMMs and the fused attention, feature lifting, FPS, LRF, the int8 geometric embedding,
coarse matching and the 6000-hypothesis search, the fused fine PE, fine matching and the fused assignment
with its WSVD) in bf16 with seeded random weights (the repo holds no checkpoint), on ``UNOPOSE_BENCH_BATCH``
(default 16) pairs of ``configs.synthetic_inputs(np.random.default_rng(0), ...)``, which draws what the JAX
bench's ``_full_inputs`` draws.

After ``WARMUP`` calls, 3 timed calls each run ``ITERS`` batches back to back, each batch's pose inputs
(``CHAIN_KEYS``) plus the previous batch's ``pred_t[0, 0] * 0``, so the batches form one chain, and each call's
coarse-search uniforms drawn batch by batch from a device generator seeded for that call (the JAX bench folds
the batch index into its key). A call's time is the host clock around it, ending in
``torch.cuda.synchronize()``; the best of the 3 is reported. To stderr: the card's name and power limit, the
init and first-run seconds, the steady ms per batch with ``pred_R`` finite, and the kernel count and time of
one more batch under ``torch.profiler``. The last stdout line is the JSON of the JAX bench:
``metric``, ``value`` (pairs/s), ``unit`` and ``vs_baseline`` against the same A100 reference.

It runs on the card; with no card it raises, unless ``run(device="cpu")`` asks for the CPU (the plain
versions, for the tests at ``tiny`` sizes).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

A100_REFERENCE_PAIRS_PER_SEC = 120.0  # the JAX bench's TF32 best case (BASELINE.md)
BATCH = int(os.environ.get("UNOPOSE_BENCH_BATCH", "16"))
WARMUP = 2
ITERS = 10
TRIALS = 3
CHAIN_KEYS = ("pts", "rgb", "tem1_rgb", "tem1_pts")


def card_info(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(device: str = "cuda", tiny: bool = False, batch: int = BATCH, iters: int = ITERS, warmup: int = WARMUP,
        trials: int = TRIALS) -> dict:
    """Build, warm up and time the model (module docstring). Returns ``line`` (the JSON line's keys),
    ``ms_per_batch``, the last timed batch's ``pred_R``, ``pred_t`` and ``pred_pose_score``, ``init_s``,
    ``first_s``, ``card`` and, on the card, ``profiled`` (``tools/profile_slice.py:kernel_summary`` of one
    more batch)."""
    from unopose_tpu_torch import configs
    from unopose_tpu_torch.models import UNOPose

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card (run(device='cpu') for the plain versions)")
    dev = torch.device(device)
    card = card_info(dev)
    _log(f"device: {card}")
    cfg = configs.production_config(tiny)
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = UNOPose.from_config(cfg, torch.bfloat16, torch.bfloat16).to(dev).eval()
    inputs = {k: torch.from_numpy(v).to(dev)
              for k, v in configs.synthetic_inputs(np.random.default_rng(0), batch, tiny=tiny).items()}
    _sync(dev)
    init_s = time.perf_counter() - t0
    _log(f"init: {init_s:.1f}s")

    t0 = time.perf_counter()
    out = model(inputs, generator=torch.Generator(device=dev).manual_seed(2))
    _sync(dev)
    first_s = time.perf_counter() - t0
    _log(f"first run: {first_s:.1f}s")

    def chain(n: int, call_seed: int):
        gen = torch.Generator(device=dev).manual_seed(call_seed)
        carry = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(n):
            ins = dict(inputs)
            for k in CHAIN_KEYS:
                ins[k] = inputs[k] + carry.to(inputs[k].dtype)
            out = model(ins, generator=gen)
            carry = out["pred_t"][0, 0] * 0.0
        return out

    for _ in range(warmup):
        chain(iters, 3)
    _sync(dev)
    dt = float("inf")
    for trial in range(trials):
        t0 = time.perf_counter()
        out = chain(iters, 4 + trial)
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)
    pairs_per_sec = batch * iters / dt
    _log(f"steady: {dt / iters * 1e3:.3f} ms / {batch}-pair batch "
         f"(pred_R finite: {bool(torch.isfinite(out['pred_R']).all())})")
    result = dict(
        line=dict(metric="query_ref_pairs_per_sec_per_chip", value=round(pairs_per_sec, 2), unit="pairs/s",
                  vs_baseline=round(pairs_per_sec / A100_REFERENCE_PAIRS_PER_SEC, 3)),
        ms_per_batch=dt / iters * 1e3, init_s=init_s, first_s=first_s, card=card,
        **{k: out[k] for k in ("pred_R", "pred_t", "pred_pose_score")},
    )
    if dev.type == "cuda":
        from unopose_tpu_torch.tools.profile_slice import kernel_summary

        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            chain(1, 4 + trials)
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
        summary = kernel_summary(prof, wall, set())
        result["profiled"] = {k: summary[k] for k in ("wall_ms", "kernels", "kernel_ms", "busy_ms", "idle_share")}
        _log(f"profiled batch: wall {wall:.3f} ms, {summary['kernels']} kernels, kernel time "
             f"{summary['kernel_ms']:.3f} ms, idle share {100 * summary['idle_share']:.1f}%")
    return result


def main() -> int:
    print(json.dumps(run()["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
