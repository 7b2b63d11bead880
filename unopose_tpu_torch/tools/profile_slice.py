"""Where the time goes in a full-width configuration on one CUDA card.

    python -m unopose_tpu_torch.tools.profile_slice [--config slice|fused_matchers] [--batches 8]
        [--warmup 2] [--seed 0] [--out FILE]

Runs a configuration as ``chip_smoke.py`` does (``configs.slice_config()``,
the default, or ``configs.fused_matcher_config()``; bf16, seeded random
weights, synthetic batches of 16 pairs) and reports:

- per stage of ``UNOPose.forward``, the median device time over the steady
  batches (CUDA events recorded around the stage) and its share of the
  median batch wall time (host clock, ending in a synchronize);
- one more batch under ``torch.profiler``: the number of kernels, their
  summed time, the union of their intervals (busy time) against the host
  wall of that batch (idle share), the top kernels by device time, and the
  time of the hand-written kernels;
- the card's name, power limit, SM clock and power draw after the run.

Stages nest: 1a and 1b lie inside 1, 7a inside 7, and 7b and 7c inside 7a.
Stage 4 is the exact embedding or the fused int8 one (kernel geo_rpe); 7b is
the grouping (with the slot gather on the slice path, without it on the
fused path); 7c, on the fused path only, is PE-v5 (kernels pe_channels and
pe_mlp_pool). With ``--out`` the report is also written there as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 16
OURS = ("fps_kernel", "first_k_select_kernel", "gather_planar_kernel", "geo_rpe_kernel", "pe_channels_kernel",
        "pe_mlp_pool_kernel")


def _timed(name: str, fn, marks: list):
    def inner(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        marks.append((name, start, end))
        return out

    return inner


def instrument(model, marks: list) -> None:
    """Record CUDA events around each stage of ``model.forward`` into ``marks``."""
    import unopose_tpu_torch.models.feature_extraction as fe
    import unopose_tpu_torch.models.matching as mm
    import unopose_tpu_torch.models.unopose as un

    for name, mod in (
        ("1 encoder: ViT x2, upscaler, pixel gather, template FPS", model.encoder),
        ("1a ViT x2 + upscaler", model.encoder.rgb_net),
        ("4 geometric embedding", model.geo_embed),
        ("5 coarse matcher", model.coarse_matching),
        ("7 fine matching: PE, blocks, similarity", model.fine_matching),
        ("7a fine PE", model.fine_matching.pe),
    ):
        mod.forward = _timed(name, mod.forward, marks)
    model._lrf = _timed("2 global LRF, both clouds", model._lrf, marks)
    for module, attr, name in (
        (fe, "sample_pts_feats", "1b template FPS 5000->2048 + gathers"),
        (un, "sample_pts_feats_wlrf", "3 FPS 2048->196 + gathers, both clouds"),
        (un, "compute_coarse_Rt_overlap", "6 coarse solver"),
        (mm, "two_scale_group_first_k_packed", "7b first_k select + slot gather + weights"),
        (mm, "two_scale_group_first_k_packed_idx", "7b first_k select + weights (index grouping)"),
        (mm, "pe_fused_v5", "7c PE-v5: channels + MLP/pool kernels"),
        (un, "compute_fine_Rt_overlap", "8 fine solver"),
    ):
        setattr(module, attr, _timed(name, getattr(module, attr), marks))


def kernel_summary(prof, wall_ms: float) -> dict:
    """Kernel count, summed and busy (interval union) time, idle share and
    the top kernels of one profiled batch, from its chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = sorted(
        (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events if e.get("cat") == "kernel" and "dur" in e
    )
    busy_us, cur_start, cur_end = 0.0, None, None
    for s, e, _ in kernels:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    by_name: dict = {}
    for s, e, name in kernels:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += (e - s) / 1e3
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    return dict(
        wall_ms=wall_ms,
        kernels=len(kernels),
        kernel_ms=sum(e - s for s, e, _ in kernels) / 1e3,
        busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / 1e3 / wall_ms,
        top=[dict(name=n[:120], ms=ms, count=c) for n, (ms, c) in top],
        hand_written_ms={k: sum(ms for n, (ms, _) in by_name.items() if k in n) for k in OURS},
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("slice", "fused_matchers"), default="slice")
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    from unopose_tpu_torch.configs import fused_matcher_config, slice_config, synthetic_inputs
    from unopose_tpu_torch.models import UNOPose

    dev = torch.device("cuda", 0)
    torch.manual_seed(args.seed)
    cfg = slice_config() if args.config == "slice" else fused_matcher_config()
    model = UNOPose.from_config(cfg, torch.bfloat16, torch.bfloat16).to(dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    batches = [
        {k: torch.from_numpy(v).to(dev) for k, v in synthetic_inputs(rng, BATCH).items()} for _ in range(args.batches)
    ]
    marks: list = []
    instrument(model, marks)

    walls, stages = [], {}
    for i, inputs in enumerate(batches):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(inputs, generator=gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i >= args.warmup:
            per_batch: dict = {}
            for name, start, end in marks:
                per_batch[name] = per_batch.get(name, 0.0) + start.elapsed_time(end)
            for name, ms in per_batch.items():
                stages.setdefault(name, []).append(ms)
    steady = float(np.median(walls[args.warmup:]))

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model(batches[-1], generator=gen)
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    summary = kernel_summary(prof, profiled_wall)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    report = dict(
        config=args.config, card=card, batch=BATCH, walls_ms=walls, steady_ms=steady, pairs_per_s=BATCH * 1e3 / steady,
        stages_ms={name: float(np.median(v)) for name, v in sorted(stages.items())}, profiled=summary,
    )
    print(f"config {args.config}; card (name, power limit, SM clock, power draw): {card}")
    print(f"batch walls ms {[round(w, 3) for w in walls]}; steady median {steady:.3f} ms, "
          f"{report['pairs_per_s']:.1f} pairs/s")
    for name, ms in report["stages_ms"].items():
        print(f"  {name:<58s} {ms:9.3f} ms {100 * ms / steady:6.1f}%")
    print(f"profiled batch: wall {summary['wall_ms']:.3f} ms, {summary['kernels']} kernels, "
          f"kernel time {summary['kernel_ms']:.3f} ms, busy {summary['busy_ms']:.3f} ms, "
          f"idle share {100 * summary['idle_share']:.1f}%")
    for k in summary["top"]:
        print(f"  {k['ms']:9.3f} ms x{k['count']:5d}  {k['name']}")
    print(f"hand-written kernels (ms): {summary['hand_written_ms']}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
