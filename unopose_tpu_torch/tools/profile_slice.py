"""Where the time goes in a full-width configuration on one CUDA card.

    python -m unopose_tpu_torch.tools.profile_slice [--config slice|fused_matchers|production|subset|firstk_unpacked
        |production_hypsel|production_pe_packed|production_pe_v3|production_pe_v4|production_pe_slot_major
        |production_s768]
        [--batches 8] [--warmup 2] [--seed 0] [--out FILE]

Runs a configuration of ``configs.CONFIGS`` as ``chip_smoke.py`` does
(``slice_config()``, the default, ``fused_matcher_config()``,
``production_config()``, ``subset_config()`` or ``firstk_unpacked_config()``;
``production_hypsel`` is the production config under ``UNOPOSE_HYPSEL_V2=1``,
the coarse selection through its kernel; ``production_pe_packed``,
``_v3``, ``_v4`` and ``_slot_major`` are the production config under
``UNOPOSE_PE_V5=0`` alone or with ``UNOPOSE_PE_V3=1``, ``UNOPOSE_PE_V4=1``
or ``UNOPOSE_PE_SLOT_MAJOR=1``, the fine PE through the packed PE's other
layouts, kernels pe_packed, pe_mlp_pool_packed, pe_gather_fused and
pe_packed_t; ``production_s768`` is the production config at a scale-2
budget of 768 slots (``configs.production_s768_config()``), the fine PE
through pe_packed; bf16, seeded random weights, synthetic batches of 16 pairs)
and reports:

- per stage of ``UNOPose.forward``, the median time between CUDA events
  recorded around the stage over the steady batches (device time plus the
  launch gaps inside the stage, which follow the host) and its share of the
  median batch wall time (host clock, ending in a synchronize);
- one more batch under ``torch.profiler``: the number of kernels, their
  summed time, the union of their intervals (busy time) against the host
  wall of that batch (idle share), per stage the summed time of the
  kernels launched inside it (a ``record_function`` range around each
  stage, attributed by the host time of its launch), the top kernels by
  device time, and the time of the hand-written kernels; the peak device
  memory of the run;
- the card's name, power limit, SM clock and power draw after the run.

Stages nest: 1a and 1b lie inside 1, 1c and 1d inside 1a, 7a inside 7, and
7b and 7c inside 7a. 1c is the fused attention (production only, kernel
mha_fused); 1d the 48 block GEMMs with, on the production path, their
per-token int8 quantisation. 1c and 1d run 12 and 48 times a batch, so
they have kernel times only: CUDA events around each call would add to
the stages they sit in. Stage 4 is the exact embedding or the fused
int8 one (kernel geo_rpe); 7b is the grouping (with the slot gather on the
slice path, without it on the fused paths; the unpacked first_k grouping,
with the gather; or the subset grouping, kernel ball_group_subset, twice);
7c, on the fused paths only, is PE-v5 (kernels pe_channels and
pe_mlp_pool), the masked PE (kernel pe_masked), or on the switched PE
profiles the packed PE's other layout (row 13 in two ranges: its
channels in PyTorch, then its MLP/pool kernel). Stage 6 holds, on
production_hypsel, the selection kernel (hyp_select). Stage 8 is the materialised
solver, or on the production path the fused assignment (kernels
fine_assign_colstats, _labels, _accum) and its Procrustes. With ``--out``
the report is also written there as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from unopose_tpu_torch import configs

BATCH = 16
# the PE train kernels K11-K14 and K18 (K12 and K14 on warpgroup products) and the second passes of their launches
PE_TRAIN = ("pe_train_kernel", "fwd_wg_kernel", "dw_wg_kernel", "stats_finish", "sums_finish", "dw_finish",
            "frozen_finish")
OURS = ("fps_kernel", "first_k_select_kernel", "gather_planar_kernel", "geo_rpe_kernel", "pe_channels_kernel",
        "pe_mlp_pool_kernel", "mha_bf16_kernel", "colstats_kernel", "labels_kernel", "accum_kernel",
        "ball_group_subset_kernel", "pe_masked_kernel", "hyp_select_kernel", "pe_packed_kernel",
        "pe_mlp_pool_packed_kernel", "pe_gather_fused_kernel", "pe_packed_t_kernel") + PE_TRAIN
# the profiles: each config, and the production config with an environment switch (the fine PE's
# switches are each set or unset explicitly, so a caller's environment does not leak into a profile)
# (``chip_smoke.py`` runs its main paths from this table)
PE_OFF = dict.fromkeys(("UNOPOSE_PE_V5", "UNOPOSE_PE_V3", "UNOPOSE_PE_V4", "UNOPOSE_PE_SLOT_MAJOR"))
V5_OFF = {**PE_OFF, "UNOPOSE_PE_V5": "0"}
PROFILES = {**{name: (config, PE_OFF) for name, config in configs.CONFIGS.items()},
            "production_hypsel": (configs.production_config, {**PE_OFF, "UNOPOSE_HYPSEL_V2": "1"}),
            "production_pe_packed": (configs.production_config, V5_OFF),
            "production_pe_v3": (configs.production_config, {**V5_OFF, "UNOPOSE_PE_V3": "1"}),
            "production_pe_v4": (configs.production_config, {**V5_OFF, "UNOPOSE_PE_V4": "1"}),
            "production_pe_slot_major": (configs.production_config, {**V5_OFF, "UNOPOSE_PE_SLOT_MAJOR": "1"}),
            "production_s768": (configs.production_s768_config, PE_OFF)}


def set_env(env: dict) -> dict:
    """Sets environment variables (unsets those given as None); returns
    their earlier values in the same form."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return saved


@contextlib.contextmanager
def env_switch(env: dict):
    """``set_env`` inside a ``with`` block, the earlier values restored after."""
    saved = set_env(env)
    try:
        yield
    finally:
        set_env(saved)


def _timed(name: str, fn, marks: list, events: bool = True):
    """``fn`` inside a ``record_function`` range while the profiler runs;
    otherwise, with ``events``, between two CUDA events appended to
    ``marks``, and without, untouched (the sub-stages called dozens of times
    a batch, whose events would add to the times they sit in)."""

    def inner(*args, **kwargs):
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        if not events:
            return fn(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        marks.append((name, start, end))
        return out

    return inner


def instrument(model, marks: list) -> list:
    """Wrap the stages of ``model.forward`` (module docstring); returns
    their names."""
    import unopose_tpu_torch.models.feature_extraction as fe
    import unopose_tpu_torch.models.matching as mm
    import unopose_tpu_torch.models.unopose as un
    import unopose_tpu_torch.models.vit as vit

    names = []
    for name, mod in (
        ("1 encoder: ViT x2, upscaler, pixel gather, template FPS", model.encoder),
        ("1a ViT x2 + upscaler", model.encoder.rgb_net),
        ("4 geometric embedding", model.geo_embed),
        ("5 coarse matcher", model.coarse_matching),
        ("7 fine matching: PE, blocks, similarity or projections", model.fine_matching),
        ("7a fine PE", model.fine_matching.pe),
    ):
        mod.forward = _timed(name, mod.forward, marks)
        names.append(name)
    model._lrf = _timed("2 global LRF, both clouds", model._lrf, marks)
    names.append("2 global LRF, both clouds")
    gemms = "1d of which block GEMMs (48 DenseQ: bf16, or W8A8 and its quantisation)"
    for mod in model.encoder.modules():
        if isinstance(mod, vit.DenseQ):
            mod.forward = _timed(gemms, mod.forward, marks, events=False)
    vit.mha_fused = _timed("1c of which fused attention (K7)", vit.mha_fused, marks, events=False)
    names += [gemms, "1c of which fused attention (K7)"]
    for module, attr, name in (
        (fe, "sample_pts_feats", "1b template FPS 5000->2048 + gathers"),
        (un, "sample_pts_feats_wlrf", "3 FPS 2048->196 + gathers, both clouds"),
        (un, "compute_coarse_Rt_overlap", "6 coarse solver"),
        (mm, "two_scale_group_first_k_packed", "7b first_k select + slot gather + weights"),
        (mm, "two_scale_group_first_k_packed_idx", "7b first_k select + weights (index grouping)"),
        (mm, "pe_fused_v5", "7c PE-v5: channels + MLP/pool kernels"),
        (mm, "two_scale_group_first_k_fast", "7b first_k select + slot gather (unpacked)"),
        (mm, "ball_group_subset", "7b subset grouping (K15, both scales)"),
        (mm, "pe_fused_masked", "7c masked PE (K16)"),
        (mm, "pe_fused_packed", "7c row 10: packed PE (K19)"),
        (mm, "pe_channels_packed", "7c row 13: channels (PyTorch)"),
        (mm, "pe_mlp_pool_packed", "7c row 13: MLP/pool (K20)"),
        (mm, "pe_fused_gather_t", "7c row 12: gather-fused PE (K21)"),
        (mm, "pe_fused_packed_t", "7c row 11: slot-major PE (K22)"),
        (un, "compute_fine_Rt_overlap", "8 fine solver"),
        (un, "compute_fine_Rt_overlap_fused", "8 fine solver (fused assignment K8-K10)"),
    ):
        setattr(module, attr, _timed(name, getattr(module, attr), marks))
        names.append(name)
    return names


def stage_kernel_ms(events: list, names) -> dict:
    """Summed time of the kernels whose launch (the runtime or driver call
    sharing the kernel's correlation id) lies inside each stage's host range,
    from the chrome trace; kernels launched outside every stage are summed
    under ``"outside the stages"``."""
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in names]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    out = dict.fromkeys(sorted(names) + ["outside the stages"], 0.0)
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        hits = [n for s, t, n in ranges if ts is not None and s <= ts <= t]
        for n in hits or ["outside the stages"]:
            out[n] += e["dur"] / 1e3
    return out


def kernel_summary(prof, wall_ms: float, stage_names) -> dict:
    """Kernel count, summed and busy (interval union) time, idle share, the
    kernel time of each stage and the top kernels of one profiled batch,
    from its chrome trace."""
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
        stage_kernel_ms=stage_kernel_ms(events, stage_names),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=tuple(PROFILES), default="slice")
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    from unopose_tpu_torch.models import UNOPose

    dev = torch.device("cuda", 0)
    torch.manual_seed(args.seed)
    config, env = PROFILES[args.config]
    set_env(env)
    cfg = config()
    model = UNOPose.from_config(cfg, torch.bfloat16, torch.bfloat16).to(dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    batches = [
        {k: torch.from_numpy(v).to(dev) for k, v in configs.synthetic_inputs(rng, BATCH).items()}
        for _ in range(args.batches)
    ]
    marks: list = []
    names = instrument(model, marks)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
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
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model(batches[-1], generator=gen)
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    summary = kernel_summary(prof, profiled_wall, set(names))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    report = dict(
        config=args.config, card=card, batch=BATCH, walls_ms=walls, steady_ms=steady, pairs_per_s=BATCH * 1e3 / steady,
        stages_ms={name: float(np.median(v)) for name, v in sorted(stages.items())}, peak_gib=peak_gib,
        profiled=summary,
    )
    print(f"config {args.config}; card (name, power limit, SM clock, power draw): {card}")
    print(f"batch walls ms {[round(w, 3) for w in walls]}; steady median {steady:.3f} ms, "
          f"{report['pairs_per_s']:.1f} pairs/s, peak memory {peak_gib:.3f} GiB")
    print(f"  {'stage':<58s} {'events ms':>12s} {'share':>7s} {'kernels ms (profiled batch)':>28s}")
    for name in sorted(names):
        dev_ms = summary["stage_kernel_ms"][name]
        if name in report["stages_ms"]:
            ms = report["stages_ms"][name]
            print(f"  {name:<58s} {ms:9.3f} ms {100 * ms / steady:6.1f}% {dev_ms:25.3f} ms")
        elif dev_ms:  # a sub-stage timed in the profiled batch only
            print(f"  {name:<58s} {'-':>12s} {'':>7s} {dev_ms:25.3f} ms")
    print(f"  {'kernels launched outside the stages':<76s} {summary['stage_kernel_ms']['outside the stages']:25.3f} ms")
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
