#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``unopose_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--batches 3] [--train-steps 3] [--train-only]
                          [--eval-only] [--launcher-only] [--ddp-only] [--ddp-ranks 2]
                          [--precision-only] [--variants-only]

``--train-only`` builds the kernels and runs only the two train paths of
phase 6 (``train`` and ``train_frozen``, ``--train-steps`` steps each),
printing as its last line their steady step time, the profiled step's
kernel time and its PE train kernels' time (for timing two trees in turns:
copy this script into the other tree's checkout and run it there).
``--eval-only`` builds them and runs only phase 6's ``eval`` path, with its
gates, ``EVAL_MEASURED_RUNS`` times in one process on a tree of
``EVAL_MEASURED_IMAGES`` query images, printing as its last line each
run's images/s and chunk ms, whole and over its steady window
(``eval_steady``). ``--launcher-only`` builds them and runs only phase 6's
``train_launcher`` path with its gates, printing its runs' figures as its
last line. ``--ddp-only`` builds them and runs only phase 6's ``ddp`` path
with its gates, printing its figures as its last line; ``--ddp-ranks N``
runs that path on N ranks (2 by default; NCCL a card with N cards).
``--precision-only`` builds them and runs only phase 6's ``precision`` and
``pose_recovery`` paths with their gates, printing their figures as its
last line. ``--variants-only`` builds them and runs only phase 3's K7 and
K8-K10 checks, phase 5's tiny subset train step and phase 6's train
configurations and backbones (``variant_runs``), printing their figures
as its last line.

Phases, each fatal on failure:

1. device check: a CUDA card must be present;
2. build the hand-written kernels (``unopose_tpu_torch/kernels/csrc``) and
   the host library of the eval path's reader and evaluator
   (``unopose_tpu_torch/native/hostops.cpp``, ``data/native.py:build``);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, with CUDA-event times, its bound and, where one
   PyTorch call computes the same function, that call's time:
   FPS and the gather equal indices / bitwise values (FPS also timed beside
   its dependent-step floor, ``FPS_FLOOR_SRC``), the first_k select
   every output equal (timed alone too, and beside the floor of its own
   arithmetic, ten float32 operations a candidate pair at 128 lanes a clock
   on the card's SMs at their maximum clock, in the log); the int8 geometric embedding (32 x 197 x 197 x 256,
   bf16 model dtype) at most one step off on at most 0.1% of entries, timed
   beside its bound and, in the log only, the floors of its own arithmetic
   and shared reads (128 lanes, or bytes, a clock on each SM of the card at
   its maximum clock, ``card_lane_rate``); its float32 and bf16 value stores
   (``quant_int8`` off) at D 256 and 32, the float32 store within 1e-5 of
   each channel's bound 1.25 (max|T_d| + max|T_a|), the bf16 store equal but
   for one bf16 ulp on at most 0.1% of entries, each timed beside its bound
   (``geo_value_store``); the PE
   channels and MLP/pool (32 x 2048 x 256) on two kinds of cloud: the main
   path's uniform cubes, whose isotropic neighbourhoods nearly all fit one
   64-slot chunk and have ill-conditioned local frames (at most twice as
   many unequal bf16 entries as the plain version shows against itself one
   ulp up), and sphere surfaces with over 1000 points in each of the four
   tiers (99.9% of entries within one bf16 ulp, none more than 2^-5 off);
   on both the rel xyz channels bitwise equal and the MLP/pool, fed the
   plain channels, within 1e-2 of the output's max, both timed through
   their wrappers and alone (``alone_ms``: the C entry point 20 times back
   to back); the production path's
   fused attention (32 x 261 x 768 bf16, read in place from the qkv output;
   at least 99% of outputs bitwise equal, none more than one bf16 ulp of its
   row's largest output off; also the tiny hd 16, the float32 variant, N 257
   and 289 and q scaled by 40, at the same gates; and at the backbones
   without registers, 32 images of 197 and 257 tokens at 12 and 16 heads,
   each timed beside its bound and SDPA)
   and the three sweeps of the fused assignment (16 pairs of 2049 x 2049,
   C 256), each sweep fed the plain twin's inputs, then the whole chain
   (labels equal on at least 99.9% of rows, weights and soft targets within
   1e-4 of their max on the rows whose labels agree), the labels sweep
   run twice on the same inputs bitwise equal (its column keys are reduced
   by atomics across blocks), and the column statistics and accumulation
   sweeps also timed alone;
   the train path's PE
   kernels K11-K14 (B 8, P 2048, S 256 and 64), each fed its plain pass's
   statistics (and each backward its own side's forward maximum): batch
   means and variances within 1e-4 relative, the pooled output, the sums
   and the dW within 1e-2 of each tensor's max with the median under 1e-3,
   the tie counts equal, each backward-sums pass run twice bitwise equal;
   then the whole autograd function against the plain twin on autograd
   (2e-2, median 2e-3), K11 (each depth), K12 and K14 also timed alone,
   and, in the log, ptxas's registers and spills and the warps an SM of
   K11's, K12's and K14's warpgroup kernels and of the K13 and K18
   instantiations of ``pe_train_kernel`` (``pe_train_occupancy``); the subset grouping (32 x 2048, S
   64 and 256) bitwise equal to its plain version on every output, miss
   slots included; the masked PE (S 64 + 256) on those groupings of the
   uniform cubes and on the unpacked first_k grouping with all-ones masks
   (at most twice as many unequal outputs as the plain version shows against
   itself one ulp up) and of sphere surfaces (99.9% of outputs within one
   bf16 ulp, none more than two ulps of the largest output off); the subset
   grouping of ``subset_config()`` at N 8192 bitwise equal to its plain
   version; the coarse selection kernel in both modes (16 x 300 hypotheses,
   N 196) bitwise equal to its plain twins, within 1e-4 of the plain
   selection it replaces; the frozen-BN train stack (K12 on the running
   statistics, the one-sweep backward K18) against its plain passes at the
   K11-K14 gates, K18 deterministic, and the whole function against its
   twin on autograd; the packed PE's other layouts K19-K22 (32 x 2048, S2
   256) on the cubes (at most twice the twin's own one-ulp count of unequal
   outputs; K20, fed the twin's channels with a float32 last layer, within
   1e-2 of its max, K6's gate) and the surfaces (99.9% within one bf16 ulp,
   none more than two ulps of the largest output off), all four at S2 512
   on cubes shrunk by ``DENSE_SCALE`` (K19's full blocks, K21's and K22's
   512-slot tier; the cubes' gates), all four at S2 768 on cubes shrunk by
   ``DENSE_768_SCALE`` with r1 ``R1_768`` (past one 512-slot window: K19's
   full blocks, K21's and K22's 768-slot tier, K20's 192-slot chunks; the
   cubes' gates), K19 timed alone on each of those four and also run at S2
   512 on the main cubes and at N 1984, K21 bitwise equal to K5 followed by K6, and K3 at N 1984
   and 2000 equal to its plain version on every output; and the TPU
   profiling kernels of ``benchmarks/`` (K23-K27) on their scripts' inputs
   at the scripts' shapes, as ``check_profile_kernels`` says: the three
   compaction kernels every output equal (the gather also timed alone and
   beside one ``torch.gather``), row 24 without frames by
   ``profile_r9.bf16_agreement``'s rule (99.9% bitwise, at most one output
   in 10^4 past one bf16 ulp of its own value, all within one ulp of their
   row's largest output), with frames and row 20 at the
   cubes' gate (row 20's sets that use no frame at the frameless gate);
4. one forced grouping overflow, through the plain PE, PE-v5 and row 10
   (``UNOPOSE_PE_V5=0``): each must take the exact fallback (and with it
   the gather kernel), whose grouping equals the CPU plain version's;
5. the float32 slice, fused-matcher, production, subset and unpacked
   first_k configs at a tiny width on the card (kernels) against the CPU
   (plain versions), same weights and draws: FPS indices and int8 embedding
   codes equal, the coarse attention within 1e-3 of its max, the coarse
   scores within 1e-4, the fine scores' median error under 5e-3 and 95th
   percentile under 5e-2 (the CPU slice tests' gates); on the fused
   assignment's configs also its labels on the CPU's projections (99%
   equal); the subset config as ``check_tiny`` says; the train path's grouping
   on the main path's clouds (B 8, N 2048) equal to the CPU's slot for slot;
   the tiny production config under ``UNOPOSE_HYPSEL_V2=1`` as
   ``check_tiny_hypsel`` says; the production fine PE with no switch at N
   576 and 1984 (row 10, K19) and 272 (the plain float32 MLP), card
   against CPU, as ``check_pe_routes`` says; and one tiny float32 train step
   (``train_config(tiny=True)`` on surface clouds), card against CPU, with
   the gates of ``check_tiny_train``, again under
   ``UNOPOSE_PE_TRAIN_FROZEN=1``, and in the subset mode
   (``subset_config(tiny=True)``, K15);
6. the main paths at full width (ViT-B/14-reg4 at 224 px, 2048-point
   clouds, a 5000-point template, 6000/300 hypotheses, bf16, seeded random
   weights, batches of 16 pairs): ``slice_config()`` and
   ``fused_matcher_config()`` for 2 batches each, then
   ``production_config()`` for ``--batches`` without and then with
   ``UNOPOSE_HYPSEL_V2=1`` (``production_hypsel``), ``subset_config()`` for
   2 and ``firstk_unpacked_config()`` for 1, and the production config for 1
   under each fine-PE switch (the profiles of ``tools/profile_slice.py``;
   ``production_pe_packed``: ``UNOPOSE_PE_V5=0``,
   K19; ``production_pe_v3``: and ``UNOPOSE_PE_V3=1``, K20;
   ``production_pe_v4``: and ``UNOPOSE_PE_V4=1``, K21;
   ``production_pe_slot_major``: and ``UNOPOSE_PE_SLOT_MAJOR=1``, K22), and
   ``production_s768`` (nsample2 768, K19) for 1;
   finite, orthonormal poses and the peak memory; the ``precision`` path
   (``run_precision``: the faithful, bf16-embedding production and
   production configs on one full-width fake reference checkpoint with
   ``parity_gather=True``, 16 ``tools/scenes.py`` scenes, the same
   coarse-solver uniforms; each production config against faithful at the
   JAX production gate's limits, ``PRECISION_LIMITS``, every delta and the
   pose differences logged); the ``pose_recovery`` path (the port's
   pose-recovery example at B 4, N 2048: both stages within 1 degree and
   0.02, the all-zero probe finite); then ``train_config()`` (B 8, bf16) for
   ``--train-steps`` training steps: finite loss terms, a finite positive
   gradient norm, the frozen ViT bitwise unchanged, every trainable module
   and all six BatchNorm layers of the fine PE moved, and one profiled
   step's device time; and again under ``UNOPOSE_PE_TRAIN_FROZEN=1``
   (``train_frozen``), where the six layers' gammas and betas must move and
   their running statistics stay bitwise unchanged; the train
   configurations past that recipe (``TRAIN_VARIANTS``, the same gates and
   their peak memory): ``train_subset`` (the subset mode, K15, the plain
   masked MLP recomputed in the backward), ``train_full`` (the ViT trained,
   the clip at ``TRAIN_FULL_MAX_NORM``, the EMA: the clip binding and the
   applied norm at it, the EMA against the host's recomputation, a
   checkpoint restored bitwise, as ``check_train_full`` says) and one step
   each of ``train_pe_bf16``, ``train_pe_no_lrf`` and ``train_pe_no_xyz``;
   the production forward on each ViT backbone without registers
   (``BACKBONES``: K7 at 257 and 197 tokens, 12 and 16 heads), two
   batches, the pose gates; the timing entry points:
   the bench (``unopose_tpu_torch.bench.run()``, the production config at
   16 pairs, its JSON line logged, its last batch's poses gated) and each
   profiling script's ``main()`` (``SCRIPTS``) at ``SCRIPT_ITERS`` chained
   calls a timing, its JSON of results logged; the evaluation entry point
   (``eval``: ``main_unopose.main([..., "--eval-only"])`` on the production
   model in bf16, 224 px, 2048 / 5000 points, chunks of 16, the template
   cache on, over ``write_bop_tree``'s synthetic BOP tree: 3 query images of
   20 detections on 2 references), gated on one seven-column CSV row per
   detection, valid poses, a finite AR in the scores JSON and each
   reference encoded once, its images/s, ms per chunk, reader wait and
   cache hits logged; and on its first chunk the cached forward against
   the uncached one at the same draws (radius bitwise, poses within
   ``EVAL_CACHE_TOL``); the train entry point (``train_launcher``:
   ``main_unopose.main`` trains ``main_config()`` at 8 a step with the ViT
   grafted from a seeded fake timm checkpoint, on synthetic batches with a
   checkpoint and an evaluation every 2 iterations, resumes from its
   checkpoint, reads a synthetic MegaPose tree through the threaded loader,
   and evaluates ``--eval-only`` from the checkpoint, as
   ``run_train_launcher`` says; then one step at the JAX launcher's global
   batch of 32 as a finding); the data-parallel entry point (``ddp``:
   K11's split entry points on the card bitwise the one-call one at one
   rank's count, and the spare row's count read by K13 and K14;
   ``main_unopose.main`` on 2 ranks, NCCL a card each with two cards or
   more, else 2 gloo ranks sharing card 0, ``main_config()`` at 8 a rank
   for 3 synthetic iterations with a checkpoint at the last, against one
   process on the global batch of 16 within 3 times that run's own one-ulp
   spread and, for the first step's averaged gradients, within a quarter
   of each tensor's largest, which two deliberate faults must fail; the
   ranks bitwise equal to each other; ``--eval-only``
   from the checkpoint on 2 ranks against one process's shards; one NCCL
   rank at world size 1; as ``run_ddp`` says). The launch counts are
   zeroed just before each path and read just after, every kernel of the
   path must have launched, and no path may launch the PE kernels of the
   other PE paths nor, with its switch off, a switched path's kernels.

Log lines are prefixed with the card's name and power limit. Before the
last line come one JSON line with the kernels' results and the raw
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
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
    "pe_train_stats": ("unopose_tpu_torch/kernels/csrc/pe_train.cu", "unopose_tpu/ops/pe_train.py:96"),
    "pe_train_fwd": ("unopose_tpu_torch/kernels/csrc/pe_train.cu", "unopose_tpu/ops/pe_train.py:112"),
    "pe_train_bwd_sums": ("unopose_tpu_torch/kernels/csrc/pe_train.cu", "unopose_tpu/ops/pe_train.py:190"),
    "pe_train_bwd_dw": ("unopose_tpu_torch/kernels/csrc/pe_train.cu", "unopose_tpu/ops/pe_train.py:210"),
    "ball_group_subset": ("unopose_tpu_torch/kernels/csrc/ball_group_subset.cu", "unopose_tpu/ops/ball_query.py:964"),
    "pe_masked": ("unopose_tpu_torch/kernels/csrc/pe_masked.cu", "unopose_tpu/ops/pe_fused.py:163"),
    "hyp_select": ("unopose_tpu_torch/kernels/csrc/hyp_select.cu", "unopose_tpu/ops/hyp_select.py:86"),
    "hyp_select_v2": ("unopose_tpu_torch/kernels/csrc/hyp_select.cu", "unopose_tpu/ops/hyp_select2.py:72"),
    "pe_train_frozen_bwd": ("unopose_tpu_torch/kernels/csrc/pe_train.cu", "unopose_tpu/ops/pe_train.py:450"),
    "pe_packed": ("unopose_tpu_torch/kernels/csrc/pe_packed.cu", "unopose_tpu/ops/pe_fused.py:332"),
    "pe_mlp_pool_packed": ("unopose_tpu_torch/kernels/csrc/pe_mlp_pool_packed.cu", "unopose_tpu/ops/pe_fused.py:1157"),
    "pe_gather_fused": ("unopose_tpu_torch/kernels/csrc/pe_gather_fused.cu", "unopose_tpu/ops/pe_fused.py:751"),
    "pe_packed_t": ("unopose_tpu_torch/kernels/csrc/pe_packed_t.cu", "unopose_tpu/ops/pe_fused.py:547"),
    "profile_r9": ("unopose_tpu_torch/kernels/csrc/profile_r9.cu", "benchmarks/profile_r9.py:100"),
    "pe_ablate": ("unopose_tpu_torch/kernels/csrc/pe_ablate.cu", "benchmarks/profile_pe_ablate.py:68"),
    "compact_rounds": ("unopose_tpu_torch/kernels/csrc/compact_micro.cu", "benchmarks/profile_compact_micro.py:34"),
    "compact_gather": ("unopose_tpu_torch/kernels/csrc/compact_micro.cu", "benchmarks/profile_compact_micro.py:54"),
    "compact_wherechain": ("unopose_tpu_torch/kernels/csrc/compact_micro.cu",
                           "benchmarks/profile_compact_micro.py:134"),
}
FUSED = ("fps", "first_k_select", "geo_rpe", "pe_channels", "pe_mlp_pool")
PRODUCTION = ("fps", "geo_rpe", "mha_fused", "fine_assign_colstats", "fine_assign_labels", "fine_assign_accum")
PATH_KERNELS = {
    "slice": ("fps", "first_k_select", "gather_planar"),
    "fused_matchers": FUSED,
    "production": FUSED + PRODUCTION[2:],
    "subset": PRODUCTION + ("ball_group_subset", "pe_masked"),
    "firstk_unpacked": PRODUCTION + ("first_k_select", "gather_planar", "pe_masked"),
    "train": ("fps", "first_k_select", "gather_planar", "pe_train_stats", "pe_train_fwd", "pe_train_bwd_sums",
              "pe_train_bwd_dw"),
    "production_hypsel": FUSED + PRODUCTION[2:] + ("hyp_select_v2",),
    "train_frozen": ("fps", "first_k_select", "gather_planar", "pe_train_fwd", "pe_train_frozen_bwd"),
}
# the production path with the fine PE switched to one of the packed PE's other layouts (rows 10-13)
PE_BASE = ("fps", "first_k_select", "geo_rpe") + PRODUCTION[2:]
PE_PATHS = {
    "production_pe_packed": ("pe_packed", "gather_planar"),
    "production_pe_v3": ("pe_mlp_pool_packed", "gather_planar"),
    "production_pe_v4": ("pe_gather_fused",),
    "production_pe_slot_major": ("pe_packed_t", "gather_planar"),
}
PATH_KERNELS.update({name: PE_BASE + kernels for name, kernels in PE_PATHS.items()})
# the production config with a scale-2 budget of 768 slots: the JAX package's gates send it to row 10 (K19)
PATH_KERNELS["production_s768"] = PATH_KERNELS["production_pe_packed"]
PE_VARIANTS = tuple(kernels[0] for kernels in PE_PATHS.values())
# kernels a path must not launch: the PE kernels of the other first_k and subset paths, and the kernels of
# the switched paths (UNOPOSE_HYPSEL_V2, UNOPOSE_PE_TRAIN_FROZEN, the PE switches) where their switch is off
SWITCHED = ("hyp_select", "hyp_select_v2", "pe_train_frozen_bwd") + PE_VARIANTS
PATH_NOT_LAUNCHED = {
    "slice": SWITCHED, "fused_matchers": SWITCHED, "production": SWITCHED, "train": SWITCHED,
    "subset": ("first_k_select", "gather_planar", "pe_channels", "pe_mlp_pool") + SWITCHED,
    "firstk_unpacked": ("ball_group_subset", "pe_channels", "pe_mlp_pool") + SWITCHED,
    "production_hypsel": ("hyp_select", "pe_train_frozen_bwd") + PE_VARIANTS,
    "train_frozen": ("pe_train_stats", "pe_train_bwd_sums", "pe_train_bwd_dw", "hyp_select", "hyp_select_v2")
    + PE_VARIANTS,
}
PATH_NOT_LAUNCHED.update({
    name: ("pe_channels", "pe_mlp_pool", "pe_masked", "ball_group_subset", "hyp_select", "hyp_select_v2",
           "pe_train_frozen_bwd") + tuple(k for k in PE_VARIANTS if k != kernels[0])
    for name, kernels in PE_PATHS.items()})
PATH_NOT_LAUNCHED["production_s768"] = PATH_NOT_LAUNCHED["production_pe_packed"]
# the timing entry points: the bench on the production path, and the three profiling scripts of benchmarks/ with
# their kernels (rows 20-24), each script's main() at fewer iterations
PATH_KERNELS["bench"], PATH_NOT_LAUNCHED["bench"] = PATH_KERNELS["production"], PATH_NOT_LAUNCHED["production"]
# the evaluation entry point (main_unopose --eval-only) runs the production model, its templates through the cache
PATH_KERNELS["eval"], PATH_NOT_LAUNCHED["eval"] = PATH_KERNELS["production"], PATH_NOT_LAUNCHED["production"]
# the train entry point (main_unopose's train branch): the train step's kernels and, through its periodic
# evaluation, the production path's
PATH_KERNELS["train_launcher"] = tuple(dict.fromkeys(PATH_KERNELS["train"] + PATH_KERNELS["production"]))
PATH_NOT_LAUNCHED["train_launcher"] = SWITCHED
# the data-parallel train entry point and its sharded evaluation (run_ddp): the same kernels on every rank
PATH_KERNELS["ddp"], PATH_NOT_LAUNCHED["ddp"] = PATH_KERNELS["train_launcher"], SWITCHED
# the precision gate (run_precision): the faithful config (no fused kernel but the grouping's) and both production
# configs, whose geometric embedding is K4's bf16 store or its int8 one; the scenes' dense tripods overflow the
# packed grouping's budgets at full width, so both production configs' fine PE take the exact fallback (K3, K2 and
# the plain MLP), as the JAX package's would; and the pose-recovery example (FPS, K1)
PATH_KERNELS["precision"] = ("fps", "first_k_select", "gather_planar", "geo_rpe") + PRODUCTION[2:]
PATH_NOT_LAUNCHED["precision"] = ("ball_group_subset", "pe_masked") + SWITCHED
PATH_KERNELS["pose_recovery"], PATH_NOT_LAUNCHED["pose_recovery"] = ("fps",), SWITCHED
# the train configurations past the six-channel float32 recipe (run_train): the subset-mode step (K15's groupings,
# the plain masked MLP), every parameter trained with the clip and the EMA (the train path's kernels; the ViT's
# exact path, K7 has no backward), and the PE in bf16, without LRF or without xyz (the first_k grouping, the plain
# MLP)
PE_TRAIN_KERNELS = ("pe_train_stats", "pe_train_fwd", "pe_train_bwd_sums", "pe_train_bwd_dw")
INFER_PE = ("pe_channels", "pe_mlp_pool", "pe_masked", "mha_fused")
TRAIN_PE_VARIANTS = {"train_pe_bf16": dict(pe_dtype="bf16"), "train_pe_no_lrf": dict(use_lrf=False),
                     "train_pe_no_xyz": dict(use_xyz=False)}
TRAIN_VARIANTS = ("train_subset", "train_full") + tuple(TRAIN_PE_VARIANTS)
PATH_KERNELS["train_subset"] = ("fps", "ball_group_subset")
PATH_NOT_LAUNCHED["train_subset"] = ("first_k_select", "gather_planar") + PE_TRAIN_KERNELS + INFER_PE + SWITCHED
PATH_KERNELS["train_full"], PATH_NOT_LAUNCHED["train_full"] = PATH_KERNELS["train"], SWITCHED + INFER_PE
for _name in TRAIN_PE_VARIANTS:
    PATH_KERNELS[_name] = ("fps", "first_k_select", "gather_planar")
    PATH_NOT_LAUNCHED[_name] = ("ball_group_subset",) + PE_TRAIN_KERNELS + INFER_PE + SWITCHED
TRAIN_FULL_MAX_NORM = 1.0  # below every step's gradient norm at full width, so that the clip binds
# the production inference forward with the ViT backbones without registers (K7 at 257 and 197 tokens, 12 and 16
# heads)
BACKBONES = ("vit_base_patch14_dinov2", "vit_base", "vit_large_patch14_dinov2", "vit_large")
for _name in BACKBONES:
    PATH_KERNELS[f"backbone_{_name}"] = PATH_KERNELS["production"]
    PATH_NOT_LAUNCHED[f"backbone_{_name}"] = PATH_NOT_LAUNCHED["production"]
SCRIPTS = {
    "profile_r9": ("profile_r9", "pe_packed"),
    "profile_pe_ablate": ("pe_ablate",),
    "profile_compact_micro": ("compact_rounds", "compact_gather", "compact_wherechain"),
}
PATH_KERNELS.update(SCRIPTS)
SCRIPT_ITERS = 2
INFER_PATHS = ("slice", "fused_matchers", "production", "subset", "firstk_unpacked")
# the environment of the train path's switch (the inference paths take theirs from profile_slice.PROFILES)
FROZEN = {"UNOPOSE_PE_TRAIN_FROZEN": "1"}


def card_lane_rate() -> tuple:
    """(float32 lanes a second, SMs, MHz): 128 lanes a clock on each SM of card 0 at its maximum SM clock
    (``nvidia-smi``)."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 128 * sms * mhz * 1e6, sms, mhz


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


# The dependent-step floor of K1 (fps.cu): its step loop with the distance work taken out, at its thread
# count (256 up to 6144 points, else 1024). Each thread's key is a hash of the last winner's coordinate (so no
# step can start early), then fps.cu's warp reduction, the per-warp slots of the step's parity, its one
# __syncthreads, every warp's reduction of the slots, the winner's lookup in shared memory and its store.
# Built and timed here only, not part of the port.
FPS_FLOOR_SRC = r"""
#include <cuda_runtime.h>
#include <limits.h>

__global__ void __launch_bounds__(1024, 1)
fps_floor_kernel(const float* __restrict__ pts, int n, int npoint, int* __restrict__ out) {
  extern __shared__ float xs[];
  __shared__ unsigned s_bits[2][32];
  __shared__ int s_idx[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const float* p = pts + (size_t)blockIdx.x * n * 3;
  for (int i = tid; i < n; i += blockDim.x) xs[i] = p[3 * i];
  __syncthreads();
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float x1 = xs[last];
    unsigned bits = (__float_as_uint(x1) ^ ((unsigned)tid * 2654435761u)) >> 1;
    unsigned top = __reduce_max_sync(0xffffffffu, bits);
    int idx = __reduce_min_sync(0xffffffffu, bits == top ? tid : INT_MAX);
    const int par = j & 1;
    if (lane == 0) {
      s_bits[par][warp] = top;
      s_idx[par][warp] = idx;
    }
    __syncthreads();
    bits = lane < warps ? s_bits[par][lane] : 0u;
    top = __reduce_max_sync(0xffffffffu, bits);
    idx = __reduce_min_sync(0xffffffffu, bits == top && lane < warps ? s_idx[par][lane] : INT_MAX);
    last = min(idx, n - 1);
    if (tid == 0) out[(size_t)blockIdx.x * npoint + j] = last;
  }
}

extern "C" int fps_floor(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fps_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(n * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  fps_floor_kernel<<<batch, n <= 6144 ? 256 : 1024, n * sizeof(float), stream>>>(pts, n, npoint, out);
  return (int)cudaGetLastError();
}
"""


def fps_floor_ms(pts, npoint: int) -> float:
    """CUDA-event time of ``FPS_FLOOR_SRC`` on K1's launch shape: npoint - 1
    of K1's steps with no distance work, built with K1's flags."""
    import ctypes
    import hashlib

    import torch

    from unopose_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256((FPS_FLOOR_SRC + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    lib_path = build.BUILD_DIR / f"fps_floor_{tag}.so"
    if not lib_path.exists():
        src = lib_path.with_suffix(".cu")
        src.write_text(FPS_FLOOR_SRC)
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.fps_floor.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    B, N, _ = pts.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=pts.device)

    def run():
        err = lib.fps_floor(pts.data_ptr(), out.data_ptr(), B, N, npoint, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fps_floor failed to launch: cudaError_t {err}")

    return cuda_ms(run)


def alone_ms(entry: str, *args, reps: int = 20) -> float:
    """CUDA-event time of one launch of a kernel's C entry point, ``reps``
    launches back to back on prepared arguments (tensors passed as device
    pointers): the kernel without its wrapper's checks, casts and
    allocations. These launches bypass the wrapper and its count."""
    import ctypes

    import torch

    from unopose_tpu_torch.kernels import build

    fn = getattr(build.load(), entry)
    argv = [ctypes.c_void_p(a.data_ptr()) if torch.is_tensor(a) else a for a in args]

    def run():
        err = fn(*argv, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"{entry} failed to launch: cudaError_t {err}")

    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    # K1 FPS: template 16 x 5000 -> 2048, then both clouds 16 x 2048 -> 196; beside each, its
    # dependent-step floor (FPS_FLOOR_SRC: the same steps with no distance work)
    worst = 0
    for b, n, k in ((BATCH, 5000, 2048), (BATCH, 2048, 196)):
        pts = lrf_cloud(rng, dev, b, n)
        got, ref = fps_cuda(pts, k), fps_plain(pts, k)
        torch.cuda.synchronize()
        mismatch = int((got.long() - ref.long()).abs().max())
        worst = max(worst, mismatch)
        ms, plain_ms = cuda_ms(lambda: fps_cuda(pts, k)), cuda_ms(lambda: fps_plain(pts, k), reps=2)
        floor_ms = fps_floor_ms(pts, k)
        # per point and step: 3 sub, 3 mul, 2 add, a min and an argmax compare
        fps_bound = bound(b * n * 12 + b * k * 4, 10.0 * b * (k - 1) * n, F32_FLOPS)
        log(f"fps {b}x{n}->{k}: max |index diff| {mismatch}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {fps_bound['bound_ms']:.4f} ms ({fps_bound['bound_by']}), dependent-step floor "
            f"{floor_ms:.3f} ms ({k - 1} steps at {1e3 * floor_ms / (k - 1):.3f} us)")
        if (b, n) == (BATCH, 5000):
            results["fps"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, floor_ms=floor_ms, **fps_bound)
        else:
            results["fps"].update(n2048_ms=ms, n2048_plain_ms=plain_ms, n2048_floor_ms=floor_ms,
                                  n2048_bound_ms=fps_bound["bound_ms"])
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
    # the kernel alone (its C entry point back to back on prepared outputs), beside the floor of its own
    # arithmetic: the same ten float32 operations a pair at 128 lanes a clock on every SM
    outs = [torch.empty_like(got[k]) for k in SELECT_KEYS[:-1]] + [torch.zeros(1, dtype=torch.int32, device=dev)]
    select_alone = alone_ms("unopose_first_k_select", pts, pts_p, perm, inv_perm, B2, N, 64, S, 0.1 * 0.1, 0.2 * 0.2,
                            *outs)
    rate, sms, mhz = card_lane_rate()
    floor_ms = 10.0 * B2 * N * N / rate * 1e3
    log(f"first_k_select alone, back to back {select_alone:.3f} ms; bound {results['first_k_select']['bound_ms']:.4f} "
        f"ms ({results['first_k_select']['bound_by']}); arithmetic floor, 10 float32 operations a pair x {B2}x{N}x{N} "
        f"pairs at 128 lanes a clock on {sms} SMs at {mhz:.0f} MHz: {floor_ms:.4f} ms")
    results["first_k_select"].update(alone_ms=select_alone)

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
    # writes the int8 embedding, reads the points, anchors and both (T, D) tables; per output entry
    # four 3-term stencils (5 operations each), the max over k, the sum and the quantisation
    geo_bytes = e8.numel() + points.numel() * 4 + ref_vec.numel() * 4 + 2 * T * D * 4 + D * 4
    geo_bound = bound(geo_bytes, 25.0 * e8.numel(), F32_FLOPS)
    # the floors of the kernel's own arithmetic: ~27 separately rounded float32 operations per entry issued
    # at 128 lanes a clock an SM, and 3 (1 + k) bf16 table values read from shared memory per entry at 128
    # bytes a clock an SM
    per_s, _, _ = card_lane_rate()  # lanes, or shared-memory bytes, a second: 128 a clock on each SM
    floor_ms = 27.0 * e8.numel() / per_s * 1e3
    smem_floor_ms = 3 * (1 + k) * 2.0 * e8.numel() / per_s * 1e3
    log(f"geo_rpe 32x197x197x256 int8 (bf16 tables): {100 * share:.4f}% of entries differ, max {worst} step, "
        f"scale equal {torch.equal(sc, psc)}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{geo_bound['bound_ms']:.4f} ms ({geo_bound['bound_by']}), arithmetic floor {floor_ms:.4f} ms, "
        f"shared-read floor {smem_floor_ms:.4f} ms")
    if worst > 1 or share > 1e-3 or not torch.equal(sc, psc):
        raise AssertionError("geo_rpe kernel differs from the plain version beyond one step on 0.1% of entries")
    results["geo_rpe"] = dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms, library_ms=None, **geo_bound)
    # the value stores (quant_int8 off): float32 (float32 contraction) and bf16, at D 256 and at D 32
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    W32 = [torch.randn(32, 32, device=dev, generator=gen) / 32**0.5 for _ in range(2)]
    b32 = [torch.randn(32, device=dev, generator=gen) * 0.1 for _ in range(2)]
    narrow = (build_taylor_table(W32[0], b32[0], ge.d_index_max, T)[0],
              build_taylor_table(W32[1], b32[1], float(np.pi * factor_a), T)[0])
    consts = (scale_d, scale_a, ge.sigma_d, factor_a)
    for width, tabs in ((D, (tab_d.detach(), tab_a.detach())), (32, narrow)):
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            r = geo_value_store(points, ref_vec, *tabs, consts, dtype)
            key = f"{name}_store" + ("" if width == D else f"_d{width}")
            results["geo_rpe"][key] = r
            log(f"geo_rpe 32x197x197x{width} {name} store: {100 * r['unequal_share']:.4f}% of entries unequal, max "
                f"|diff| {r['max_abs_err']:.3e} ({r['gate']}), kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            if not r["ok"]:
                raise AssertionError(f"geo_rpe {name} store at D {width} differs from the plain version: {r['gate']}")

    # K5, K6 on the fine PE's input: both clouds, 32 x 2048, budgets 64/256
    pe = FinePositionalEncoding(256, fused=True).to(dev)
    mlp1, mlp2, packed = pe.folded_weights()
    iso = pe_kernels(dev, lrf_cloud(rng, dev, 2 * BATCH, 2048), mlp1, mlp2, packed)
    perm, _ = permutation(2048, "cpu")
    surf = pe_kernels(dev, torch.from_numpy(surface_clouds(rng, 2 * BATCH, perm.numpy())).to(dev), mlp1, mlp2, packed)
    for name, r in (("uniform cube", iso), ("sphere surfaces", surf)):
        log(f"PE on {name}: tiers (points needing 1/2/3/4 chunks of 64 slots) {r['hist']}, overflow {r['overflow']}, "
            f"mean r2 hits {r['mean_hits']:.1f}, kept slot-scales {r['kept'] / (2 * r['slots']):.3f} of the needed")
        log(f"pe_channels 32x2048x256 on {name}: {100 * r['equal']:.4f}% of needed bf16 entries equal, "
            f"{100 * r['within_ulp']:.4f}% within one bf16 ulp (plain vs itself one ulp up: {100 * r['spread']:.4f}% "
            f"equal), rel xyz bitwise {r['rel_bitwise']}, max |diff| {r['c_err']:.3e}, "
            f"kernel {r['c_ms']:.3f} ms (alone, back to back: {r['c_alone']:.3f} ms), plain {r['c_plain']:.3f} ms")
        log(f"pe_mlp_pool 32x2048x256 on {name} (plain channels): max |diff| {r['m_err']:.3e} of max "
            f"{r['m_ref']:.3e}, kernel {r['m_ms']:.3f} ms (alone, back to back: {r['m_alone']:.3f} ms), "
            f"plain {r['m_plain']:.3f} ms")
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
    # K6 reads both scales' weights of the needed slots (which tell the kept ones), then per kept slot
    # (weight > 0) and scale its 12 channel bytes and 2 x (6*32 + 32*64 + 64*128) bf16 tensor-core
    # operations: a masked slot's channels and products decide nothing
    B2, N = 2 * BATCH, 2048
    ch_bound = lambda r: bound(r["slots"] * (2 + 4 + 24) + 6 * B2 * N * 4 + B2 * N * 4, 160.0 * r["slots"], F32_FLOPS)
    mlp_bound = lambda r: bound(r["slots"] * 4 + r["kept"] * 12 + B2 * N * (4 + 256 * 4),
                                r["kept"] * 2 * (6 * 32 + 32 * 64 + 64 * 128), BF16_FLOPS)
    for name, err, ms, plain, bnd in (("pe_channels", "c_err", "c_ms", "c_plain", ch_bound),
                                      ("pe_mlp_pool", "m_err", "m_ms", "m_plain", mlp_bound)):
        # the main path's (cube) numbers, and beside them the surfaces'
        results[name] = dict(max_abs_err=iso[err], ms=iso[ms], plain_ms=iso[plain], library_ms=None,
                             **bnd(iso), surface_max_abs_err=surf[err], surface_ms=surf[ms],
                             surface_plain_ms=surf[plain], surface_bound_ms=bnd(surf)["bound_ms"])
    for name, key in (("pe_channels", "c_alone"), ("pe_mlp_pool", "m_alone")):
        results[name].update(alone_ms=iso[key], surface_alone_ms=surf[key])
    return results


def geo_value_store(points, ref_vec, tab_d, tab_a, consts, dtype) -> dict:
    """K4's value store in ``dtype`` against the plain version on the same
    inputs: float32 within 1e-5 of each channel's bound 1.25 (max|T_d| +
    max|T_a|); bf16 equal but for one bf16 ulp on at most 0.1% of entries
    (the share the int8 check admits). Times and the bound (the output
    written once, the points, anchors and tables read once, 25 float32
    operations an entry)."""
    import torch

    from unopose_tpu_torch.ops.geo_fused import geo_rpe_fused_cuda, geo_rpe_fused_plain

    args = (points, ref_vec, tab_d, tab_a, *consts, dtype, False)
    with torch.no_grad():
        e, p = geo_rpe_fused_cuda(*args), geo_rpe_fused_plain(*args)
        torch.cuda.synchronize()
        if e.dtype != dtype or e.shape != p.shape:
            raise AssertionError(f"geo_rpe value store: {e.dtype} {tuple(e.shape)}, plain {p.dtype} {tuple(p.shape)}")
        diff = (e.float() - p.float()).abs()
        share = diff.gt(0).float().mean().item()
        if dtype == torch.float32:
            chan = 1.25 * (tab_d.abs().amax(0) + tab_a.abs().amax(0))
            rel = (diff / chan).amax().item()
            ok, gate = rel <= 1e-5, f"max |diff| / channel bound {rel:.3e}, limit 1e-5"
        else:
            past = diff.gt(ulp_bf16(p.float())).sum().item()
            ok, gate = past == 0 and share <= 1e-3, f"{past} entries past one bf16 ulp, unequal share limit 0.1%"
        worst = diff.max().item()
        del diff
        ms, plain_ms = cuda_ms(lambda: geo_rpe_fused_cuda(*args)), cuda_ms(lambda: geo_rpe_fused_plain(*args), reps=3)
    T, D = tab_d.shape
    nbytes = e.numel() * e.element_size() + points.numel() * 4 + ref_vec.numel() * 4 + 2 * T * D * 4
    return dict(ok=ok, gate=gate, unequal_share=share, max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(nbytes, 25.0 * e.numel(), F32_FLOPS))


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
        # at the main gates: ragged N at the main width (257 ends in a one-row tile of the register path, 289
        # is past the register budget, the three-pass path), and q scaled by 40 at N 261 (scores far below their
        # row's max: the division's exact path for tiny quotients)
        ragged = {}
        for nr, q_scale in ((257, 1.0), (289, 1.0), (261, 40.0)):
            rq = torch.randn(8, nr, 3 * D, device=dev, generator=gen)
            rq[..., :D] *= q_scale
            rq = rq.to(torch.bfloat16).split(D, dim=-1)
            r_got, r_want = mha_fused_cuda(*rq, H).float(), mha_fused_plain(*rq, H).float()
            ragged[f"{nr}" + ("" if q_scale == 1.0 else f", q x{q_scale:g}")] = (
                (r_got == r_want).float().mean().item(),
                ((r_got - r_want).abs() / ulp_bf16(r_want.abs().amax(dim=-1, keepdim=True))).max().item())
        # the backbones without registers (BACKBONES): 197 tokens at patch 16, 257 at patch 14, a 16-pair batch
        # at ViT-B's width (12 heads) and ViT-L's (16 heads); each timed beside its bound and SDPA
        backbones = {}
        for nb, heads in ((197, 12), (257, 12), (197, 16), (257, 16)):
            Db = heads * hd
            bq = torch.randn(B2, nb, 3 * Db, device=dev, generator=gen).to(torch.bfloat16).split(Db, dim=-1)
            b_got, b_want = mha_fused_cuda(*bq, heads).float(), mha_fused_plain(*bq, heads).float()
            bh = [x.reshape(B2, nb, heads, hd).transpose(1, 2).contiguous() for x in bq]
            backbones[f"{B2}x{nb}x{Db}"] = dict(
                equal_share=(b_got == b_want).float().mean().item(),
                max_row_ulps=((b_got - b_want).abs() / ulp_bf16(b_want.abs().amax(dim=-1, keepdim=True))).max().item(),
                max_abs_err=(b_got - b_want).abs().max().item(), ms=cuda_ms(lambda: mha_fused_cuda(*bq, heads)),
                plain_ms=cuda_ms(lambda: mha_fused_plain(*bq, heads), reps=3),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*bh)),
                **bound(4 * B2 * nb * Db * 2, 2 * 2 * B2 * heads * nb * nb * hd, BF16_FLOPS))
    log(f"mha_fused 32x261x768 bf16 (12 heads, in place from qkv): {100 * equal:.4f}% of outputs bitwise equal, "
        f"max diff {ulps:.0f} bf16 ulps of the output ({row_ulps:.3f} of its row's largest), max |diff| {err:.3e}; "
        f"hd 16 within a row ulp {s_ok}; float32 variant rel {f_err:.2e}; ragged 8xNx768 (bitwise share, row ulps) "
        f"{ragged}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA {library_ms:.3f} ms")
    log("mha_fused at the backbones' shapes (bitwise share, row ulps, kernel / plain / SDPA / bound ms): " + ", ".join(
        f"{k} {r['equal_share']:.4f} {r['max_row_ulps']:.3f} {r['ms']:.4f} / {r['plain_ms']:.4f} / "
        f"{r['library_ms']:.4f} / {r['bound_ms']:.4f}" for k, r in backbones.items()))
    if (equal < 0.99 or row_ulps > 1.0 or not s_ok or f_err > 1e-5
            or any(eq < 0.99 or ru > 1.0 for eq, ru in ragged.values())
            or any(r["equal_share"] < 0.99 or r["max_row_ulps"] > 1.0 for r in backbones.values())):
        raise AssertionError("mha_fused kernel differs from the plain version beyond its gates")
    # reads q, k, v and writes o once; QK^T and PV on the tensor cores
    results["mha_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                equal_share=equal, max_ulps=ulps, max_row_ulps=row_ulps,
                                ragged=ragged, backbones=backbones,
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
        # the column keys are reduced by atomics across blocks: a second run must give the same bits
        labels_twice = all(torch.equal(a, b) for a, b in zip((g_rm, g_rs, g_l1, g_l2), af.labels_cuda(*largs)))
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
        accum_alone = alone_ms("unopose_fine_accum", *aargs, torch.empty_like(p_w), torch.empty_like(p_n), Bp, M, M, C)
        colstats_alone = alone_ms("unopose_fine_colstats", f1n, f2n, torch.empty_like(cm), torch.empty_like(cs),
                                  Bp, M, M, C)
        fused_ms = cuda_ms(lambda: af.compute_fine_Rt_overlap_fused(f1, f2, score, pts1, pts2))
        materialised_ms = cuda_ms(lambda: compute_fine_Rt_overlap(
            compute_feature_similarity(f1, f2, 0.1, True), score, pts1, pts2), reps=3)
    log(f"fine_assign 16x2049x2049 C 256, each sweep on the plain twin's inputs: rel err {stats}, label1 equal "
        f"{100 * l1_eq:.4f}%, label2 equal {100 * l2_eq:.4f}%, weights {w_err:.2e}, numerators {n_err:.2e} of max; "
        f"chain: label1 equal {100 * chain_l1:.4f}%, weights {chain_w:.2e}, soft targets {chain_p:.2e} of max on "
        f"agreeing rows; foreground rows {100 * (pl > 0).float().mean().item():.1f}%")
    log(f"fine_assign labels run twice bitwise equal {labels_twice}")
    log("fine_assign times (kernel, plain ms): " + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in times.items())
        + f"; alone, back to back: colstats {colstats_alone:.3f} ms, accum {accum_alone:.3f} ms; fused solver "
        f"{fused_ms:.3f} ms, materialised solver "
        f"(similarity + dual softmax + WSVD) {materialised_ms:.3f} ms")
    if max(stats.values()) > 1e-5 or min(l1_eq, l2_eq, chain_l1) < 0.999 or max(w_err, n_err, chain_w, chain_p) > 1e-4:
        raise AssertionError("fine_assign kernels differ from the plain versions beyond their gates")
    if not labels_twice:
        raise AssertionError("fine_assign labels differ between two runs on the same inputs")
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
    log("fine_assign kernel / bound ms (by): " + ", ".join(
        f"{k} {times[k][0]:.3f} / {b['bound_ms']:.4f} ({b['bound_by']})" for k, b in bounds.items()))
    for name in ("colstats", "labels", "accum"):
        results[f"fine_assign_{name}"] = dict(
            max_abs_err=errs[name], ms=times[name][0], plain_ms=times[name][1], library_ms=None,
            materialised_solver_ms=materialised_ms, fused_solver_ms=fused_ms, **bounds[name])
    results["fine_assign_colstats"].update(alone_ms=colstats_alone)
    results["fine_assign_labels"].update(label1_equal=l1_eq, label2_equal=l2_eq, run_twice_bitwise=labels_twice)
    results["fine_assign_accum"].update(chain_label1_equal=chain_l1, chain_weights_rel=chain_w,
                                        chain_targets_rel=chain_p, alone_ms=accum_alone)
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
            kept=int(((w1.float() > 0) & needed).sum() + ((w2.float() > 0) & needed).sum()),
            overflow=bool(overflow), mean_hits=total2.float().mean().item(),
        )
        del nchans, a, b, n, diff, e, ulp
        r["c_ms"], r["c_plain"] = cuda_ms(lambda: pe_channels_cuda(*cargs)), cuda_ms(lambda: pe_channels_plain(*cargs), reps=3)
        B, N = planes[0].shape
        r["c_alone"] = alone_ms("unopose_pe_channels", *(p.float().contiguous() for p in planes), idx_p.contiguous(),
                                *(w.to(torch.bfloat16).contiguous() for w in (w1, w2)),
                                total2.to(torch.int32).contiguous(), *(c.float().contiguous() for c in center),
                                torch.empty_like(chans), B, N, N, S, 0.1, 0.2, 1.0 / 0.1, 1.0 / 0.2)
        margs = (pchans, w1, w2, total2)
        pooled, ppooled = pe_mlp_pool_cuda(*margs, packed), pe_mlp_pool_plain(*margs, mlp1, mlp2)
        torch.cuda.synchronize()
        r["m_err"], r["m_ref"] = float((pooled - ppooled).abs().max()), float(ppooled.abs().max())
        r["m_ms"] = cuda_ms(lambda: pe_mlp_pool_cuda(*margs, packed))
        r["m_plain"] = cuda_ms(lambda: pe_mlp_pool_plain(*margs, mlp1, mlp2), reps=3)
        w1b, w2b = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
        B, P, S2, _ = pchans.shape
        r["m_alone"] = alone_ms("unopose_pe_mlp_pool", pchans.contiguous(), w1b, w2b, total2.to(torch.int32).contiguous(),
                                *packed, torch.empty_like(pooled), B * P, S2)
    return r


def pe_train_occupancy(log, instances) -> dict:
    """ptxas's registers and spills (from this process's build, ``build.build_log``) and the warps an SM holds (the
    runtime's occupancy query, ``unopose_pe_train_resident_warps``) of the train kernels' kernel functions (K12's
    and K14's warpgroup kernels, pe_train_kernel's instantiations for the others), each (label, kernel
    "K11"-"K18", depth), logged; {label: record}."""
    import ctypes

    from unopose_tpu_torch.kernels import build
    from unopose_tpu_torch.tools.kernel_variants import ptxas_fn, ptxas_record

    out = {}
    for label, kernel, depth in instances:
        warps = ctypes.c_int(0)
        if err := build.load().unopose_pe_train_resident_warps(int(kernel[1:]), depth, ctypes.byref(warps)):
            raise AssertionError(f"pe_train occupancy query of {label} failed: cudaError_t {err}")
        out[label] = dict(ptxas_record(build.build_log, ptxas_fn(kernel, f"depth {depth}")),
                          resident_warps_per_sm=warps.value)
        log(f"pe_train_kernel {label}: {out[label]} (ptxas, this process's build; warps an SM, occupancy query)")
    return out


def check_train_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the train path's PE kernels K11-K14 against their plain
    versions at the train step's shapes (B = 8, P = 2048, S = 256 and 64),
    each kernel fed the plain pipeline's statistics, then the whole autograd
    function against the plain twin on autograd."""
    import torch

    from unopose_tpu_torch.configs import pe_train_chans, pe_train_weights
    from unopose_tpu_torch.ops import pe_train as pt

    rng = np.random.default_rng(seed + 7)
    Bt, P = 8, 2048
    Ws, gammas, betas = pe_train_weights(dev, seed)
    results, worst = {}, {}
    occupancy = pe_train_occupancy(log, [*((f"K11 depth {d}", "K11", d) for d in (1, 2, 3)), ("K12", "K12", 3),
                                         *((f"K13 layer {L}", "K13", L) for L in (3, 2, 1)), ("K14", "K14", 0)])

    def rel(got, want):
        d = (got - want).abs()
        scale = want.abs().max().clamp_min(1e-30)
        return (d.max() / scale).item(), (d.median() / scale).item()

    for S in (256, 64):
        chans = pe_train_chans(rng, dev, Bt, P, S)
        n = Bt * P * S
        bn, gb = pt.stats_buffer(gammas, betas, dev)
        stats, absolute = {}, dict(stats=0.0, sums=0.0)  # max |kernel - plain| of each kernel's outputs
        for depth in (1, 2, 3):
            pt.stats_plain(chans, Ws, gb, bn, depth, 1e-5)
            got = bn.clone()
            pt.stats_cuda(chans, Ws, gb, got, depth, 1e-5)
            d = pt.DIMS[depth]
            mu, var = bn[depth - 1, pt.MU, :d], bn[depth - 1, pt.VAR, :d]
            k_mu, k_var = got[depth - 1, pt.MU, :d], got[depth - 1, pt.VAR, :d]
            stats[depth] = (((k_mu - mu).abs().max() / mu.abs().max()).item(), ((k_var - var).abs() / var).max().item())
            absolute["stats"] = max(absolute["stats"], (k_mu - mu).abs().max().item(), (k_var - var).abs().max().item())
        pooled, cnt = pt.fwd_plain(chans, Ws, bn)
        k_pooled, k_cnt = pt.fwd_cuda(chans, Ws, bn)
        fwd_err = rel(k_pooled, pooled)
        absolute["fwd"] = (k_pooled - pooled).abs().max().item()
        cnt_equal = (k_cnt == cnt).float().mean().item()
        dpool = torch.from_numpy(rng.standard_normal((Bt, P, 128)).astype(np.float32)).to(dev)
        # the backward kernels find each point's max slots by comparing their recomputed y3 with the
        # forward's max, so each side is fed its own forward's max and tie count
        sums, same = {}, {}
        for layer in (3, 2, 1):
            got, again = bn.clone(), bn.clone()
            pt.bwd_sums_plain(chans, Ws, bn, pooled, cnt, dpool, layer)
            pt.bwd_sums_cuda(chans, Ws, got, k_pooled, k_cnt, dpool, layer)
            pt.bwd_sums_cuda(chans, Ws, again, k_pooled, k_cnt, dpool, layer)  # a second run, bitwise the first
            same[layer] = bool(torch.equal(got, again))
            d = pt.DIMS[layer]
            sums[layer] = (rel(got[layer - 1, pt.SG, :d], bn[layer - 1, pt.SG, :d]),
                           rel(got[layer - 1, pt.SGZ, :d], bn[layer - 1, pt.SGZ, :d]))
            absolute["sums"] = max(absolute["sums"], (got[layer - 1, pt.SG:, :d] - bn[layer - 1, pt.SG:, :d]).abs().max().item())
        dws = pt.bwd_dw_plain(chans, Ws, bn, pooled, cnt, dpool)
        k_dws = pt.bwd_dw_cuda(chans, Ws, bn, k_pooled, k_cnt, dpool)
        dw_err = [rel(a, b) for a, b in zip(k_dws, dws)]
        absolute["dw"] = max((a - b).abs().max().item() for a, b in zip(k_dws, dws))
        torch.cuda.synchronize()
        times = dict(
            stats=[(cuda_ms(lambda: pt.stats_cuda(chans, Ws, gb, bn.clone(), d, 1e-5)),
                    cuda_ms(lambda: pt.stats_plain(chans, Ws, gb, bn.clone(), d, 1e-5), reps=2))
                   for d in (1, 2, 3)],
            fwd=(cuda_ms(lambda: pt.fwd_cuda(chans, Ws, bn)), cuda_ms(lambda: pt.fwd_plain(chans, Ws, bn), reps=2)),
            sums=[(cuda_ms(lambda: pt.bwd_sums_cuda(chans, Ws, bn.clone(), k_pooled, k_cnt, dpool, L)),
                   cuda_ms(lambda: pt.bwd_sums_plain(chans, Ws, bn.clone(), pooled, cnt, dpool, L), reps=2))
                  for L in (3, 2, 1)],
            dw=(cuda_ms(lambda: pt.bwd_dw_cuda(chans, Ws, bn, k_pooled, k_cnt, dpool)),
                cuda_ms(lambda: pt.bwd_dw_plain(chans, Ws, bn, pooled, cnt, dpool), reps=2)),
        )
        # K11 (each depth), K12 and K14 alone: their C entry points back to back on prepared arguments
        ws, cap = [W.float().contiguous() for W in Ws], pt._cap(dev)
        alone = dict(
            stats=[alone_ms("unopose_pe_train_stats", chans, *ws, gb, bn.clone(), torch.empty(cap * 256, device=dev),
                            cap, Bt, P, S, d, 1e-5) for d in (1, 2, 3)],
            fwd=alone_ms("unopose_pe_train_fwd", chans, *ws, bn, torch.empty_like(k_pooled), torch.empty_like(k_cnt),
                         Bt, P, S),
            dw=alone_ms("unopose_pe_train_bwd_dw", chans, *ws, bn, k_pooled, k_cnt, dpool,
                        torch.empty(cap * pt.DW_SIZE, device=dev), cap, torch.empty(pt.DW_SIZE, device=dev), Bt, P, S))
        log(f"pe_train S={S} ({Bt}x{P}x{S}): stats (mean rel of max, var rel) by depth {stats}; "
            f"pooled (max, median of max) {fwd_err}, tie counts equal {100 * cnt_equal:.4f}%; "
            f"sums (g, g zhat) by layer {sums}, two runs equal by layer {same}; dW {dw_err}")
        log(f"pe_train S={S} times (kernel, plain ms): stats {times['stats']}, fwd {times['fwd']}, "
            f"sums {times['sums']}, dw {times['dw']}; alone: stats by depth {[round(a, 4) for a in alone['stats']]}, "
            f"fwd {alone['fwd']:.4f}, dw {alone['dw']:.4f}")
        errs = [e for v in stats.values() for e in v]
        if max(errs) > 1e-4:
            raise AssertionError(f"pe_train_stats S={S}: batch mean or variance beyond 1e-4 relative: {stats}")
        tensor_errs = [fwd_err, *(e for v in sums.values() for e in v), *dw_err]
        if any(mx > 1e-2 or med > 1e-3 for mx, med in tensor_errs):
            raise AssertionError(f"pe_train S={S}: a kernel's output beyond 1e-2 of its max or median beyond 1e-3")
        if not all(same.values()):
            raise AssertionError(f"pe_train_bwd_sums S={S}: two runs differ: {same}")

        # the bounds of this run's shapes: float32 chans read once; MACs per slot of each pass
        chain = sum(a * b for a, b in zip(pt.DIMS[:-1], pt.DIMS[1:]))  # 10432
        macs = {1: 6 * 32, 2: 6 * 32 + 32 * 64, 3: chain}
        cbytes, pbytes = chans.numel() * 4, Bt * P * 128 * 4
        bounds = dict(
            stats=[bound(cbytes + 2 * 128 * 4, 2.0 * n * macs[d], BF16_FLOPS) for d in (1, 2, 3)],
            fwd=bound(cbytes + 2 * pbytes, 2.0 * n * chain, BF16_FLOPS),
            sums=[bound(cbytes + 3 * pbytes + 2 * 128 * 4, 2.0 * n * (chain + {3: 0, 2: 128 * 64, 1: 128 * 64 + 64 * 32}[L]),
                        BF16_FLOPS) for L in (3, 2, 1)],
            dw=bound(cbytes + 3 * pbytes + pt.DW_SIZE * 4, 2.0 * n * (2 * chain + 128 * 64 + 64 * 32), BF16_FLOPS),
        )
        worst[S] = dict(times=times, alone=alone, bounds=bounds, absolute=absolute, cnt_equal=cnt_equal,
                        rel=dict(stats=max(e for v in stats.values() for e in v), fwd=fwd_err[0],
                                 sums=max(e[0] for v in sums.values() for e in v), dw=max(e[0] for e in dw_err)))
        del chans, bn, pooled, cnt, dpool, k_pooled, k_cnt
        torch.cuda.empty_cache()

    # the whole function: kernels (autograd function) against the plain twin on autograd, scale 2's shape
    chans = pe_train_chans(rng, dev, Bt, P, 256)
    R = torch.from_numpy(rng.standard_normal((Bt, P, 128)).astype(np.float32)).to(dev)
    grads = []
    for fn in (pt.pe_mlp_bn_pool_train, pt.pe_mlp_bn_pool_train_plain):
        params = [t.clone().requires_grad_() for t in (*Ws, *gammas, *betas)]
        out, (mus, vars_) = fn(chans, params[:3], params[3:6], params[6:])
        (out * R).sum().backward()
        grads.append((out.detach(), [*mus, *vars_], [p.grad for p in params]))
        del out
        torch.cuda.empty_cache()
    (ko, ks, kg), (po, ps, pg) = grads
    whole = dict(pooled=rel(ko, po), stats=max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(ks, ps)),
                 grads=[rel(a, b) for a, b in zip(kg, pg)])
    log(f"pe_train whole function vs the plain twin on autograd (S=256): {whole}")
    # each kernel above matches its plain pass within 1e-3 of the max; here the autograd twin's own
    # forward (cuBLAS sums) picks the max slots and rounds its BN backward's dz after other float32
    # operations, and a gradient sums 4.19 M slots' bf16 flips: 2e-2 of the max, median 2e-3
    if whole["stats"] > 1e-4 or any(mx > 2e-2 or med > 2e-3 for mx, med in [whole["pooled"], *whole["grads"]]):
        raise AssertionError("pe_mlp_bn_pool_train on the card differs from the plain twin beyond its gates")

    # the main path's numbers are scale 2's (S = 256), scale 1's (S = 64) beside them
    main, small = worst[256], worst[64]
    # K11 and K13 run three times a call: their line holds the deepest pass (depth 3, layer 1)
    for name, key in (("pe_train_stats", "stats"), ("pe_train_fwd", "fwd"), ("pe_train_bwd_sums", "sums"),
                      ("pe_train_bwd_dw", "dw")):
        pick = (lambda x: x[2]) if key in ("stats", "sums") else (lambda x: x)
        t, b = pick(main["times"][key]), pick(main["bounds"][key])
        t64, b64 = pick(small["times"][key]), pick(small["bounds"][key])
        results[name] = dict(max_abs_err=main["absolute"][key], max_rel_err=main["rel"][key], ms=t[0], plain_ms=t[1],
                             library_ms=None, **b, s64_ms=t64[0], s64_plain_ms=t64[1], s64_bound_ms=b64["bound_ms"])
    # every depth / layer of the passes that run three times
    results["pe_train_stats"]["by_depth_ms"] = [m[0] for m in main["times"]["stats"]]
    results["pe_train_stats"]["by_depth_bound_ms"] = [b["bound_ms"] for b in main["bounds"]["stats"]]
    results["pe_train_stats"].update(alone_ms=main["alone"]["stats"][2], s64_alone_ms=small["alone"]["stats"][2],
                                     by_depth_alone_ms=main["alone"]["stats"],
                                     s64_by_depth_alone_ms=small["alone"]["stats"],
                                     s64_by_depth_ms=[m[0] for m in small["times"]["stats"]],
                                     by_depth_occupancy=[occupancy[f"K11 depth {d}"] for d in (1, 2, 3)])
    results["pe_train_bwd_sums"]["by_layer_ms"] = [m[0] for m in main["times"]["sums"]]
    results["pe_train_bwd_sums"]["by_layer_occupancy"] = [occupancy[f"K13 layer {L}"] for L in (3, 2, 1)]
    results["pe_train_bwd_sums"]["by_layer_bound_ms"] = [b["bound_ms"] for b in main["bounds"]["sums"]]
    results["pe_train_fwd"]["tie_counts_equal"] = main["cnt_equal"]
    for name, key, kernel in (("pe_train_fwd", "fwd", "K12"), ("pe_train_bwd_dw", "dw", "K14")):
        results[name].update(alone_ms=main["alone"][key], s64_alone_ms=small["alone"][key],
                             occupancy=occupancy[kernel])
    return results


def masked_pe_case(groups, center, mlp1, mlp2, packed) -> dict:
    """K16 against its plain twin on one pair of groupings (scale 1's planes
    and mask, scale 2's), both at the PE's radii 0.1 / 0.2: the agreement
    measures, the plain twin's own spread one ulp up, the valid slots and
    the times."""
    import torch

    from unopose_tpu_torch.ops.pe_fused import pe_fused_masked_cuda, pe_fused_masked_plain

    g1, m1, g2, m2 = groups
    up = lambda xs: tuple(torch.nextafter(x, torch.full_like(x, float("inf"))) for x in xs)
    with torch.no_grad():
        got = pe_fused_masked_cuda(g1, m1, g2, m2, center, 0.1, 0.2, packed)
        want = pe_fused_masked_plain(g1, m1, g2, m2, center, mlp1, mlp2, 0.1, 0.2)
        nudged = pe_fused_masked_plain(up(g1), m1, up(g2), m2, up(center), mlp1, mlp2, 0.1, 0.2)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        ref = want.abs().max().item()
        r = dict(
            equal=(got == want).float().mean().item(), spread=(nudged == want).float().mean().item(),
            within_ulp=(diff <= ulp_bf16(torch.maximum(got.abs(), want.abs()))).float().mean().item(),
            err=diff.max().item(), ref=ref, two_ulps=2 * ulp_bf16(torch.tensor(ref)).item(),
            valid=(int(m1.sum()), int(m2.sum())), slots=(m1.numel(), m2.numel()),
        )
        del got, want, nudged, diff
        r["ms"] = cuda_ms(lambda: pe_fused_masked_cuda(g1, m1, g2, m2, center, 0.1, 0.2, packed))
        r["plain_ms"] = cuda_ms(lambda: pe_fused_masked_plain(g1, m1, g2, m2, center, mlp1, mlp2, 0.1, 0.2), reps=3)
    return r


def check_subset_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the subset and unpacked first_k PE's kernels at the main
    path's shapes (both clouds, 32 x 2048): K15 (the subset grouping) against
    its plain twin bitwise on every output at S 64 and 256; K16 (the masked
    PE) on those groupings of the uniform cubes (at most twice as many
    unequal entries as the plain twin shows against itself one ulp up), of
    sphere surfaces (99.9% of entries within one bf16 ulp, none more than two
    bf16 ulps of the output's largest magnitude off) and on the unpacked
    first_k grouping with all-ones masks (the cubes' gate)."""
    import torch

    from unopose_tpu_torch.configs import surface_clouds
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import (
        ball_group_subset_cuda, ball_group_subset_plain, permutation, subset_scans, two_scale_group_first_k_fast,
    )

    rng = np.random.default_rng(seed + 13)
    B2, N = 2 * BATCH, 2048
    cube = lrf_cloud(rng, dev, B2, N)
    perm, _ = permutation(N, "cpu")
    surf = torch.from_numpy(surface_clouds(rng, B2, perm.numpy())).to(dev)
    results, groups = {}, {}

    # K15 at both scales of the cubes; the surfaces' groupings feed K16 below
    k15 = {}
    for r, S in ((0.1, 64), (0.2, 256)):
        got, want = ball_group_subset_cuda(r, S, cube), ball_group_subset_plain(r, S, cube)
        torch.cuda.synchronize()
        flat = lambda o: (*o[0], o[1])
        bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(flat(got), flat(want)))
        bitwise &= torch.equal(got[2], want[2])
        err = max((a - b).abs().max().item() for a, b in zip(flat(got), flat(want)))
        scans = subset_scans(r, S, cube)
        ms = cuda_ms(lambda: ball_group_subset_cuda(r, S, cube))
        plain_ms = cuda_ms(lambda: ball_group_subset_plain(r, S, cube), reps=3)
        # writes 4 float32 planes and a byte per (centre, slot), reads the clouds and the permutation;
        # per candidate scanned: 3 differences, a product, 2 fused multiply-adds (4) and a compare
        bnd = bound(B2 * N * S * 17 + B2 * N * 12 + N * 4, 9.0 * scans, F32_FLOPS)
        k15[S] = dict(bitwise=bitwise, err=err, ms=ms, plain_ms=plain_ms, valid=want[2].float().mean().item(),
                      scans=scans, **bnd)
        log(f"ball_group_subset 32x2048 S={S} r={r} (uniform cubes): every output bitwise equal {bitwise}, "
            f"valid slots {100 * k15[S]['valid']:.2f}%, candidates scanned {scans}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if not bitwise:
            raise AssertionError(f"ball_group_subset S={S} differs from the plain version")
        groups.setdefault("uniform cube", ([], cube))[0].extend([want[0], want[2]])
        g, _, v = ball_group_subset_cuda(r, S, surf)
        groups.setdefault("sphere surfaces", ([], surf))[0].extend([g, v])
        del got, want
    g1, g2 = two_scale_group_first_k_fast(0.1, 64, 0.2, 256, cube)
    ones = lambda g: torch.ones(g[0].shape, dtype=torch.bool, device=dev)
    groups["unpacked first_k, all-ones masks"] = ([g1, ones(g1), g2, ones(g2)], cube)
    main = k15[256]
    results["ball_group_subset"] = dict(max_abs_err=main["err"], ms=main["ms"], plain_ms=main["plain_ms"],
                                        library_ms=None, bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                                        s64_ms=k15[64]["ms"], s64_plain_ms=k15[64]["plain_ms"],
                                        s64_bound_ms=k15[64]["bound_ms"])

    # K16 with the PE's seeded weights
    torch.manual_seed(seed)
    pe = FinePositionalEncoding(256, fused=True, neighbor_mode="subset").to(dev)
    mlp1, mlp2, packed = pe.folded_weights()
    k16 = {}
    for name, (grp, cloud) in groups.items():
        r = masked_pe_case(grp, tuple(cloud.unbind(-1)), mlp1, mlp2, packed)
        valid = sum(r["valid"])
        # reads each slot's planes and mask, the centres and the weights, writes 256 float32 a point;
        # per valid slot and scale 2 x 10432 bf16 tensor-core operations (masked slots need none)
        r.update(bound(sum(r["slots"]) * 13 + B2 * N * (12 + 1024) + 2 * 12544 * 2,
                       2.0 * 10432 * valid, BF16_FLOPS))
        k16[name] = r
        log(f"pe_masked 32x2048 (S 64 + 256) on {name}: {100 * r['equal']:.4f}% of outputs bitwise equal "
            f"(plain vs itself one ulp up: {100 * r['spread']:.4f}%), {100 * r['within_ulp']:.4f}% within one bf16 "
            f"ulp, max |diff| {r['err']:.3e} of max {r['ref']:.3e} (two ulps there {r['two_ulps']:.3e}), valid slots "
            f"{r['valid']} of {r['slots']}, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    del groups
    torch.cuda.empty_cache()
    for name in ("uniform cube", "unpacked first_k, all-ones masks"):
        if 1.0 - k16[name]["equal"] > 2.0 * (1.0 - k16[name]["spread"]):
            raise AssertionError(f"pe_masked on {name} differs from the plain version beyond its one-ulp spread")
    surf16 = k16["sphere surfaces"]
    if surf16["within_ulp"] < 0.999 or surf16["err"] > surf16["two_ulps"]:
        raise AssertionError("pe_masked on the surfaces: entries beyond one bf16 ulp on more than 0.1%, or one "
                             "more than two ulps of the output's largest magnitude off")
    main, unpacked = k16["uniform cube"], k16["unpacked first_k, all-ones masks"]
    results["pe_masked"] = dict(
        max_abs_err=main["err"], ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], equal_share=main["equal"],
        surface_max_abs_err=surf16["err"], surface_within_ulp=surf16["within_ulp"], surface_ms=surf16["ms"],
        surface_bound_ms=surf16["bound_ms"], unpacked_ms=unpacked["ms"], unpacked_plain_ms=unpacked["plain_ms"],
        unpacked_bound_ms=unpacked["bound_ms"], unpacked_max_abs_err=unpacked["err"])
    return results


# bf16 tensor-core operations of one slot through one scale's MLP 6 -> 32 -> 64 -> 128
SLOT_FLOPS = 2.0 * (6 * 32 + 32 * 64 + 64 * 128)


def twin_case(kernel, plain, nudged) -> dict:
    """One kernel against its plain twin on the card: unequal outputs, the
    twin's own count against itself on inputs one ulp up (``nudged``), the
    share within one bf16 ulp, the largest difference against two bf16 ulps
    of the largest output, and both times."""
    import torch

    with torch.no_grad():
        got, want, moved = kernel(), plain(), nudged()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        ref = want.abs().max().item()
        r = dict(unequal=int((got != want).sum()), spread=int((moved != want).sum()), entries=got.numel(),
                 within_ulp=(diff <= ulp_bf16(torch.maximum(got.abs(), want.abs()))).float().mean().item(),
                 err=diff.max().item(), ref=ref, two_ulps=2 * ulp_bf16(torch.tensor(ref)).item(),
                 finite=bool(torch.isfinite(got).all()))
        del got, want, moved, diff
        r["ms"], r["plain_ms"] = cuda_ms(kernel), cuda_ms(plain, reps=2)
    return r


def packed_pe_inputs(pts, k2: int = 256, r1: float = 0.1) -> dict:
    """Every input of the packed PE's four layouts on one cloud batch, and
    the same one ulp up: the materialised grouping (K19, K20's channels,
    K22 transposed) and the index grouping (K21), at radii r1 and 0.2."""
    import torch

    from unopose_tpu_torch.ops.ball_query import two_scale_group_first_k_packed, two_scale_group_first_k_packed_idx

    up = lambda xs: tuple(torch.nextafter(x, torch.full_like(x, float("inf"))) for x in xs)
    with torch.no_grad():
        g2, w1, w2, total2, overflow = two_scale_group_first_k_packed(r1, 64, 0.2, k2, pts)
        planes, idx_p, _, _, _, _ = two_scale_group_first_k_packed_idx(r1, 64, 0.2, k2, pts)
    center = tuple(pts.unbind(-1))
    return dict(r1=r1, g2=g2, w1=w1, w2=w2, total2=total2, center=center, planes=planes, idx_p=idx_p,
                g2_up=up(g2), center_up=up(center), planes_up=up(planes), overflow=bool(overflow))


PACKED_PE = ("pe_packed", "pe_mlp_pool_packed", "pe_gather_fused", "pe_packed_t")
# the main path's cubes shrunk by this factor: at S2 512 a third to two thirds of their 64-point blocks hold a
# point with over 256 hits, and no point has over 64 hits at r1 (the grouping's own budget)
DENSE_SCALE = 0.55
# at S2 768 (past one 512-slot window of K19, K21 and K22): the cubes shrunk by 0.48 put a point with over 384
# hits in a third of the 64-point blocks (K19's full path) and every 128-point block on the 768-slot tier; at
# that density r1 0.1 holds over 64 hits somewhere (the grouping overflows), r1 0.08 at most about 45
DENSE_768_SCALE, R1_768 = 0.48, 0.08


def cube_gate(name: str, r: dict) -> bool:
    """The gate of K19-K22 on uniform cubes: at most twice as many unequal
    outputs as the plain twin shows against itself one ulp up. K20 is K6's
    counterpart (the MLP and pool fed the twin's channels, no LRF) and takes
    K6's gate, within 1e-2 of the output's max: its last layer stays
    float32, so most entries differ in the last float bits by the sum order
    alone and the count of unequal entries says nothing there."""
    if name == "pe_mlp_pool_packed":
        return r["err"] <= 1e-2 * r["ref"]
    return r["unequal"] <= 2 * r["spread"]


def packed_pe_cases(d: dict, mlp1, mlp2, packed) -> dict:
    """K19-K22 against their twins on one grouping (``packed_pe_inputs``),
    each with its bound. The bounds count what this grouping needs: K19
    reads S2/2 slots on a fast 64-point block and S2 on a full one and runs
    the MLP on the kept slots (scale 2 on every slot of a full block, whose
    pool is unmasked); K20 reads and runs each point's tier of chunks (its
    pool is unmasked); K21 reads each point's 64-slot chunks up to its hits,
    as K5 does, and K21 and K22 run the MLP on the kept slots (w > 0, the
    pools' masks); K22 reads every slot (its frames sum over all S2). At S2
    256 K21 is also held bitwise to K5 followed by K6."""
    import torch

    from unopose_tpu_torch.ops import pe_fused as pf

    g2, w1, w2, t2, c, r1 = d["g2"], d["w1"], d["w2"], d["total2"], d["center"], d["r1"]
    B2, N, S2 = w1.shape
    if d["overflow"]:
        raise AssertionError(f"the packed grouping overflowed at S2 {S2}")
    per_point = B2 * N * (4 + 12 + 1024)  # total2, the centres, the pooled row
    kept = (w1 > 0).sum().item() + (w2 > 0).sum().item()
    out = {}

    def k19(g2=g2, c=c):
        return pf.pe_fused_packed_plain(g2, w1, w2, t2, c, mlp1, mlp2, r1, 0.2)

    out["pe_packed"] = twin_case(lambda: pf.pe_fused_packed_cuda(g2, w1, w2, t2, c, r1, 0.2, packed),
                                 k19, lambda: k19(d["g2_up"], d["center_up"]))
    out["pe_packed"]["alone_ms"] = alone_ms(
        "unopose_pe_packed", *(x.float().contiguous() for x in g2), *(w.to(torch.bfloat16).contiguous() for w in (w1, w2)),
        t2.to(torch.int32).contiguous(), *(x.float().contiguous() for x in c), *packed,
        torch.empty((B2, N, 256), device=w1.device), B2, N, S2, float(r1), 0.2, float(1.0 / r1), 1.0 / 0.2)
    half = S2 // 2
    fast = (pf.block_max(t2, 64) <= half).view(B2, N // 64, 64)[..., 0].flatten()
    keep1, keep2 = (w1 > 0).view(-1, 64, S2).float(), (w2 > 0).view(-1, 64, S2).float()
    rows = torch.where(fast, keep1[..., :half].sum((1, 2)) + keep2[..., :half].sum((1, 2)),
                       keep1.sum((1, 2)) + 64 * S2).sum().item()
    slots = 64 * torch.where(fast, half, S2).sum().item()
    out["pe_packed"].update(fast=fast.float().mean().item(),
                            **bound(slots * (3 * 4 + 2 * 2) + per_point, SLOT_FLOPS * rows, BF16_FLOPS))

    chunks, w = pf.pe_channels_packed(g2, w1, w2, c, r1, 0.2)
    chunks_up, _ = pf.pe_channels_packed(d["g2_up"], w1, w2, d["center_up"], r1, 0.2)
    tiers = pf.chunk_tiers(t2, w)
    out["pe_mlp_pool_packed"] = twin_case(
        lambda: pf.pe_mlp_pool_packed_cuda(chunks, t2, packed),
        lambda: pf.pe_mlp_pool_packed_plain(chunks, t2, mlp1, mlp2),
        lambda: pf.pe_mlp_pool_packed_plain(chunks_up, t2, mlp1, mlp2))
    rows = w * tiers.sum().item()
    out["pe_mlp_pool_packed"].update(tiers=torch.bincount(tiers.flatten(), minlength=5)[1:].tolist(), **bound(
        rows * 12 * 2 + B2 * N * (4 + 1024), 2 * SLOT_FLOPS * rows, BF16_FLOPS))
    del chunks, chunks_up

    planes, idx_p = d["planes"], d["idx_p"]

    def k21(planes=planes, c=c):
        return pf.pe_fused_gather_t_plain(planes, idx_p, w1, w2, t2, c, mlp1, mlp2, r1, 0.2)

    run21 = lambda: pf.pe_fused_gather_t_cuda(planes, idx_p, w1, w2, t2, c, r1, 0.2, packed)
    out["pe_gather_fused"] = twin_case(run21, k21, lambda: k21(d["planes_up"], d["center_up"]))
    needed = pf.CHUNK * pf.chunks_needed(t2, S2).sum().item()
    out["pe_gather_fused"].update(**max(
        (bound(needed * (2 + 4) + B2 * N * 12 + per_point, SLOT_FLOPS * kept, BF16_FLOPS),
         bound(0.0, 160.0 * needed, F32_FLOPS)), key=lambda b: b["bound_ms"]))
    if S2 == 256:  # the PE-v5 kernels take S2 256 only
        v5 = lambda: pf.pe_mlp_pool_cuda(pf.pe_channels_cuda(planes, idx_p, w1, w2, t2, c, r1, 0.2), w1, w2, t2,
                                         packed)
        with torch.no_grad():
            bitwise = torch.equal(run21().view(torch.int32), v5().view(torch.int32))
        out["pe_gather_fused"].update(bitwise_v5=bitwise, v5_ms=cuda_ms(v5))

    slot_major = lambda x: x.transpose(1, 2).contiguous()
    gt, w1t, w2t = tuple(map(slot_major, g2)), slot_major(w1), slot_major(w2)
    gt_up = tuple(map(slot_major, d["g2_up"]))

    def k22(gt=gt, c=c):
        return pf.pe_fused_packed_t_plain(gt, w1t, w2t, t2, c, mlp1, mlp2, r1, 0.2)

    out["pe_packed_t"] = twin_case(lambda: pf.pe_fused_packed_t_cuda(gt, w1t, w2t, t2, c, r1, 0.2, packed),
                                   k22, lambda: k22(gt_up, d["center_up"]))
    out["pe_packed_t"].update(**bound(B2 * N * S2 * (3 * 4 + 2 * 2) + per_point, SLOT_FLOPS * kept, BF16_FLOPS))
    return out


def check_packed_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the packed PE's other layouts, K19-K22, at the main path's
    shapes (both clouds, 32 x 2048, S2 256) on the uniform cubes (at most
    twice as many unequal outputs as the plain twin shows against itself one
    ulp up; K20, fed the twin's channels, within 1e-2 of the output's max,
    K6's gate) and on sphere surfaces (99.9% of outputs within one bf16
    ulp, none more than two ulps of the largest output off); all four at S2
    512 on denser cubes, where K19's full blocks and K21's and K22's
    512-slot tier run, and K19 at S2 512 on the main cubes and at N 1984 (the
    cubes' gate); K21 bitwise equal to K5 followed by K6 on the same inputs;
    and K3 at N 1984 and 2000, every output equal to its plain version."""
    import torch

    from unopose_tpu_torch.configs import surface_clouds
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops import pe_fused as pf
    from unopose_tpu_torch.ops.ball_query import SELECT_KEYS, first_k_select_cuda, first_k_select_plain, permutation

    rng = np.random.default_rng(seed + 31)
    B2, N = 2 * BATCH, 2048
    results = {}

    # K3 at cloud sizes whose chunks of N / 4 points end inside a 32-point word
    k3 = {}
    for n in (1984, 2000):
        pts = lrf_cloud(rng, dev, B2, n)
        perm, inv_perm = permutation(n, dev)
        args = (pts, pts.index_select(1, perm.long()), perm, inv_perm, 0.1, 64, 0.2, 256)
        got, ref = first_k_select_cuda(*args), first_k_select_plain(*args)
        torch.cuda.synchronize()
        errs = {k: int((got[k].long() - ref[k].long()).abs().max()) for k in SELECT_KEYS}
        k3[n] = dict(equal=not any(errs.values()), ms=cuda_ms(lambda: first_k_select_cuda(*args)))
        log(f"first_k_select 32x{n} (64/256): max |diff| per output {errs}, overflow {bool(ref['overflow'])}, "
            f"kernel {k3[n]['ms']:.3f} ms")
        if any(errs.values()):
            raise AssertionError(f"first_k_select at N {n} differs from the plain version: {errs}")

    torch.manual_seed(seed)
    pe = FinePositionalEncoding(256, fused=True).to(dev)
    mlp1, mlp2, packed = pe.folded_weights()
    perm, _ = permutation(N, "cpu")
    clouds = {"uniform cube": lrf_cloud(rng, dev, B2, N),
              "sphere surfaces": torch.from_numpy(surface_clouds(rng, B2, perm.numpy())).to(dev)}
    cases = {name: {} for name in PACKED_PE}
    for cname, cloud in clouds.items():
        for name, r in packed_pe_cases(packed_pe_inputs(cloud), mlp1, mlp2, packed).items():
            cases[name][cname] = r
        torch.cuda.empty_cache()
    # all four at S2 512 on denser cubes (a 64-point block takes K19's full path when a point has over 256 hits,
    # and K21's and K22's 128-point blocks the 512-slot tier); K19 also at S2 512 on the main cubes (every block
    # fast) and at N 1984 (N % 128 == 64, where the production fine PE takes row 10)
    dense = packed_pe_inputs(clouds["uniform cube"] * DENSE_SCALE, 512)
    s512 = packed_pe_cases(dense, mlp1, mlp2, packed)
    fast512 = (pf.block_max(dense["total2"], 64) <= 256).float().mean().item()
    tiers512 = pf.slot_tiers(dense["total2"], 512)
    s512_full = dict(fast=fast512, tier512=(tiers512 == 512).float().mean().item())
    del dense
    # all four at S2 768, past one window: K19's full blocks, K21's and K22's 768-slot tier, K20's 192-slot chunks
    dense = packed_pe_inputs(clouds["uniform cube"] * DENSE_768_SCALE, 768, R1_768)
    s768 = packed_pe_cases(dense, mlp1, mlp2, packed)
    s768_full = dict(fast=(pf.block_max(dense["total2"], 64) <= 384).float().mean().item(),
                     tier768=(pf.slot_tiers(dense["total2"], 768) == 768).float().mean().item())
    del dense
    extra = {}
    for label, cloud, k2 in (("S2 512", clouds["uniform cube"], 512), ("N 1984", lrf_cloud(rng, dev, B2, 1984), 256)):
        d = packed_pe_inputs(cloud, k2)
        g2, w1, w2, t2, c = d["g2"], d["w1"], d["w2"], d["total2"], d["center"]
        k19 = lambda g2=g2, c=c: pf.pe_fused_packed_plain(g2, w1, w2, t2, c, mlp1, mlp2, 0.1, 0.2)
        extra[label] = twin_case(lambda: pf.pe_fused_packed_cuda(g2, w1, w2, t2, c, 0.1, 0.2, packed), k19,
                                 lambda: k19(d["g2_up"], d["center_up"]))
        extra[label]["overflow"] = d["overflow"]
        del d

    def line(name, where, r):
        note = ""
        if name == "pe_packed":
            note = f", fast blocks {100 * r['fast']:.1f}%, alone {r['alone_ms']:.3f} ms"
        elif name == "pe_mlp_pool_packed":
            note = f", points on 1/2/3/4 chunks {r['tiers']}"
        elif name == "pe_gather_fused" and "bitwise_v5" in r:
            note = f", bitwise equal to K5 -> K6 {r['bitwise_v5']} (K5 + K6 {r['v5_ms']:.3f} ms)"
        log(f"{name} {where}: {r['unequal']} of {r['entries']} outputs unequal (plain vs itself one ulp up: "
            f"{r['spread']}), {100 * r['within_ulp']:.4f}% within one bf16 ulp, max |diff| {r['err']:.3e} of max "
            f"{r['ref']:.3e} (two ulps {r['two_ulps']:.3e}){note}, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    for name, by_cloud in cases.items():
        for cname, r in by_cloud.items():
            line(name, f"32x2048 S2 256 on {cname}", r)
    for name, r in s512.items():
        line(name, f"32x2048 S2 512 on cubes x{DENSE_SCALE}", r)
    log(f"S2 512 cubes x{DENSE_SCALE}: 64-point blocks on K19's fast path "
        f"{100 * s512_full['fast']:.1f}%, points on the 512-slot tier of K21/K22 {100 * s512_full['tier512']:.1f}%")
    for name, r in s768.items():
        line(name, f"32x2048 S2 768 on cubes x{DENSE_768_SCALE}, r1 {R1_768}", r)
    log(f"S2 768 cubes x{DENSE_768_SCALE}: 64-point blocks on K19's fast path {100 * s768_full['fast']:.1f}%, "
        f"points on the 768-slot tier of K21/K22 {100 * s768_full['tier768']:.1f}%")
    for label, r in extra.items():
        log(f"pe_packed 32 clouds at {label} (uniform cubes): {r['unequal']} of {r['entries']} outputs unequal "
            f"(plain vs itself one ulp up: {r['spread']}), max |diff| {r['err']:.3e}, overflow {r['overflow']}, "
            f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")

    failed = []
    for name, by_cloud in cases.items():
        cube, surf = by_cloud["uniform cube"], by_cloud["sphere surfaces"]
        if not (cube["finite"] and surf["finite"] and cube_gate(name, cube)):
            failed.append(f"{name} on the cubes: beyond its gate, or not finite")
        if surf["within_ulp"] < 0.999 or surf["err"] > surf["two_ulps"]:
            failed.append(f"{name} on the surfaces: beyond one bf16 ulp on more than 0.1%, or two ulps of the max")
        if name == "pe_gather_fused" and not (cube["bitwise_v5"] and surf["bitwise_v5"]):
            failed.append("pe_gather_fused is not bitwise equal to pe_channels -> pe_mlp_pool")
    if s512_full["fast"] == 1.0 or s512_full["tier512"] == 0.0:
        failed.append("the S2 512 cubes left K19's full path or the 512-slot tier unused")
    for name, r in s512.items():
        if not (r["finite"] and cube_gate(name, r)):
            failed.append(f"{name} at S2 512: beyond its gate, or not finite")
    if s768_full["fast"] == 1.0 or s768_full["tier768"] == 0.0:
        failed.append("the S2 768 cubes left K19's full path or the 768-slot tier unused")
    for name, r in s768.items():
        if not (r["finite"] and cube_gate(name, r)):
            failed.append(f"{name} at S2 768: beyond its gate, or not finite")
    for label, r in extra.items():
        if r["overflow"] or not r["finite"] or r["unequal"] > 2 * r["spread"]:
            failed.append(f"pe_packed at {label}: overflow, not finite or beyond twice the twin's one-ulp spread")
    if failed:
        raise AssertionError("; ".join(failed))
    for name, by_cloud in cases.items():
        cube, surf = by_cloud["uniform cube"], by_cloud["sphere surfaces"]
        results[name] = dict(max_abs_err=cube["err"], ms=cube["ms"], plain_ms=cube["plain_ms"], library_ms=None,
                             bound_ms=cube["bound_ms"], bound_by=cube["bound_by"], unequal=cube["unequal"],
                             spread=cube["spread"], surface_max_abs_err=surf["err"], surface_within_ulp=surf["within_ulp"],
                             surface_ms=surf["ms"], surface_plain_ms=surf["plain_ms"], surface_bound_ms=surf["bound_ms"],
                             s512_ms=s512[name]["ms"], s512_plain_ms=s512[name]["plain_ms"],
                             s512_bound_ms=s512[name]["bound_ms"], s512_max_abs_err=s512[name]["err"],
                             s768_ms=s768[name]["ms"], s768_plain_ms=s768[name]["plain_ms"],
                             s768_bound_ms=s768[name]["bound_ms"], s768_max_abs_err=s768[name]["err"],
                             s768_unequal=s768[name]["unequal"], s768_spread=s768[name]["spread"])
    results["pe_gather_fused"].update(bitwise_v5=True, v5_ms=cases["pe_gather_fused"]["uniform cube"]["v5_ms"],
                                      surface_v5_ms=cases["pe_gather_fused"]["sphere surfaces"]["v5_ms"])
    results["pe_packed"].update(alone_ms=cases["pe_packed"]["uniform cube"]["alone_ms"],
                                surface_alone_ms=cases["pe_packed"]["sphere surfaces"]["alone_ms"],
                                s512_alone_ms=s512["pe_packed"]["alone_ms"], s768_alone_ms=s768["pe_packed"]["alone_ms"])
    results["pe_packed"].update(s512_fast=s512_full["fast"], s768_fast=s768_full["fast"], s512_cube_ms=extra["S2 512"]["ms"],
                                s512_cube_plain_ms=extra["S2 512"]["plain_ms"], n1984_ms=extra["N 1984"]["ms"],
                                n1984_plain_ms=extra["N 1984"]["plain_ms"])
    results["first_k_select"] = dict(n1984_ms=k3[1984]["ms"], n2000_ms=k3[2000]["ms"])
    return results


def bf16_case(kernel, plain, reordered) -> dict:
    """A kernel against its plain twin where no frame is involved, by ``profile_r9.bf16_agreement``'s rule
    (the CPU tests' too): the share bitwise equal, the outputs past one bf16 ulp of their own value, whether
    all lie within one ulp of their row's largest. Beside it the twin against itself in another float32 sum
    order (``reordered``: the hidden units permuted, the same function), which shows what sum order alone
    moves past one ulp of an output's own value; and both times."""
    import torch

    from unopose_tpu_torch.benchmarks.profile_r9 import bf16_agreement

    with torch.no_grad():
        want = plain()
        r = bf16_agreement(kernel(), want)
        order = bf16_agreement(reordered(), want)
        del want
        torch.cuda.synchronize()
    r.update(order_equal=order["equal"], order_past_own=order["past_own"], order_within_row=order["within_row"])
    r["ms"], r["plain_ms"] = cuda_ms(kernel), cuda_ms(plain, reps=2)
    return r


def bf16_line(r: dict) -> str:
    return (f"{100 * r['equal']:.4f}% of {r['entries']} outputs bitwise equal, {r['past_own']} past one bf16 ulp "
            f"of their own value, all within one ulp of the row's max {r['within_row']} (plain vs itself in another "
            f"sum order: {100 * r['order_equal']:.4f}%, {r['order_past_own']}, {r['order_within_row']}), max |diff| "
            f"{r['err']:.3e}, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")


def permuted_mlp(Ws, bs, gen):
    """The same MLP with its two hidden layers' units permuted: each layer's float32 sums in another order."""
    import torch

    p1, p2 = torch.randperm(Ws[0].shape[1], generator=gen), torch.randperm(Ws[1].shape[1], generator=gen)
    p1, p2 = p1.to(Ws[0].device), p2.to(Ws[0].device)
    return [Ws[0][:, p1], Ws[1][p1][:, p2], Ws[2][p2]], [bs[0][p1], bs[1][p2], bs[2]]


def check_profile_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the TPU profiling kernels of ``benchmarks/`` (K23-K27), each on its script's inputs at the
    script's shapes: the three compaction kernels (256 blocks of 256 rows) every output equal, rounds at 9
    and 7; row 24 (32 x 2048, S2 256) ``matmul_only`` by ``profile_r9.bf16_agreement``'s rule (no frame:
    ``bf16_case``; at least 99.9% of outputs bitwise equal, at most one in 10^4 past one bf16 ulp of its own
    value, all within one ulp of their row's largest output), ``full_nobias`` at the
    cubes' gate of K19 (``cube_gate``); row 20 (32 x 2048, the first 128 of 256 slots) in each of its seven
    sets, at the cubes' gate where its output uses the frames and at ``matmul_only``'s where it uses none.
    Each with kernel and plain ms, K26 with one ``torch.gather``'s and its time alone, and its bound:
    ``tools/tpu_profile_bounds.py``'s bytes and operations, the MLP's operations of rows 20 and 24 counted on
    the slots this run's masks keep (a masked slot changes no max) and K26's bytes on the 32-byte sectors of x
    this run's draws touch (``profile_compact_micro.gather_sectors``), the tool's shape-only bound beside them
    in the log."""
    import torch

    from unopose_tpu_torch.benchmarks import profile_compact_micro as cm
    from unopose_tpu_torch.benchmarks import profile_pe_ablate as pa
    from unopose_tpu_torch.benchmarks import profile_r9 as r9
    from unopose_tpu_torch.tools.tpu_profile_bounds import bounds as tool_bounds

    tool = {site.split("/")[-1]: v for site, v in tool_bounds().items()}
    up = lambda xs: tuple(torch.nextafter(x, torch.full_like(x, float("inf"))) for x in xs)
    results, failed = {}, []

    # K25-K27
    d = {k: torch.from_numpy(v).to(dev) for k, v in cm.script_inputs(np.random.default_rng(seed)).items()}
    rows = d["li"].numel() // cm.K2
    compact = {
        "compact_rounds": ("profile_compact_micro.py:34", lambda: cm.compact_rounds_cuda(d["x"], 9),
                           lambda: cm.compact_rounds_plain(d["x"], 9)),
        "compact_gather": ("profile_compact_micro.py:54", lambda: cm.compact_gather_cuda(d["x"], d["li"], d["bi"]),
                           lambda: cm.compact_gather_plain(d["x"], d["li"], d["bi"])),
        "compact_wherechain": ("profile_compact_micro.py:134", lambda: cm.compact_wherechain_cuda(d["li"]),
                               lambda: cm.compact_wherechain_plain(d["li"])),
    }
    for name, (site, kern, plain) in compact.items():
        with torch.no_grad():
            got, want = kern(), plain()
            err = (got.long() - want.long()).abs().max().item()
        del got, want
        r = dict(max_abs_err=float(err), ms=cuda_ms(kern), plain_ms=cuda_ms(plain, reps=2), library_ms=None,
                 **bound(*tool[site]))
        if name == "compact_gather":  # the sectors of x these draws touch, both index tensors, the output
            sectors = cm.gather_sectors(d["li"], d["bi"])
            tool_ms = r["bound_ms"]
            r.update(bound(sectors * 32 + 3 * d["li"].numel() * 4, *tool[site][1:]))
            flat = (d["bi"] * 128 + d["li"]).long().view(rows, cm.K2)
            x2 = d["x"].view(rows, -1)
            r["library_ms"] = cuda_ms(lambda: torch.gather(x2, 1, flat))
            del flat
            r["alone_ms"] = alone_ms("unopose_compact_gather", d["x"], d["li"], d["bi"], torch.empty_like(d["li"]), rows)
        if name == "compact_rounds":
            with torch.no_grad():
                r["rounds7_equal"] = torch.equal(cm.compact_rounds_cuda(d["x"], 7), cm.compact_rounds_plain(d["x"], 7))
            r["rounds7_ms"] = cuda_ms(lambda: cm.compact_rounds_cuda(d["x"], 7))
            if not r["rounds7_equal"]:
                failed.append("compact_rounds at 7 rounds differs from its plain twin")
        results[name] = r
        lib = ""
        if r["library_ms"] is not None:
            lib = (f" (alone, back to back: {r['alone_ms']:.3f} ms), torch.gather {r['library_ms']:.3f} ms "
                   f"(kernel faster: {r['ms'] < r['library_ms']})")
        how = r["bound_by"]
        if name == "compact_gather":
            how += (f"; {sectors} of x's {rows * cm.C * cm.W // 8} 32-byte sectors touched, the tool's expectation "
                    f"{tool_ms:.4f} ms")
        log(f"{name} {rows} rows: max |diff| {err}, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{lib}, "
            f"bound {r['bound_ms']:.4f} ms ({how})")
        if err:
            failed.append(f"{name} differs from its plain twin")
    del d
    torch.cuda.empty_cache()

    # K23
    rin = r9.script_inputs(np.random.default_rng(seed))
    g2 = tuple(torch.from_numpy(x).to(dev) for x in rin["g2"])
    mask = torch.from_numpy(rin["w1"]).to(dev)
    center = tuple(torch.from_numpy(np.ascontiguousarray(rin["pts"][..., i])).to(dev) for i in range(3))
    Ws1, Ws2 = (list(W.to(dev) for W in Ws) for Ws in r9.script_weights(torch.Generator().manual_seed(seed)))
    packed = r9.pack_nobias(Ws1, Ws2)
    plain = lambda mode, g=g2, c=center, W1=Ws1, W2=Ws2: r9.r9_variant_plain(g, mask, c, W1, W2, mode)
    kern = lambda mode: r9.r9_variant_cuda(g2, mask, center, packed, mode)
    gen = torch.Generator().manual_seed(seed)
    P1, P2 = (permuted_mlp(Ws, [torch.zeros(W.shape[1], device=dev) for W in Ws], gen)[0] for Ws in (Ws1, Ws2))
    mm = bf16_case(lambda: kern("matmul_only"), lambda: plain("matmul_only"),
                   lambda: plain("matmul_only", W1=P1, W2=P2))
    fn = twin_case(lambda: kern("full_nobias"), lambda: plain("full_nobias"),
                   lambda: plain("full_nobias", up(g2), up(center)))
    points, S = mask.shape[0] * mask.shape[1], mask.shape[2]
    nbytes, ops, rate = tool["profile_r9.py:100"]
    r9_bound = bound(nbytes, SLOT_FLOPS * ((mask > 0).sum().item() + points * S), BF16_FLOPS)
    log(f"profile_r9 32x2048 S2 256 matmul_only: {bf16_line(mm)}")
    log(f"profile_r9 32x2048 S2 256 full_nobias: {fn['unequal']} of {fn['entries']} outputs unequal (plain vs itself "
        f"one ulp up: {fn['spread']}), max |diff| {fn['err']:.3e} of max {fn['ref']:.3e}, kernel {fn['ms']:.3f} ms, "
        f"plain {fn['plain_ms']:.3f} ms, bound {r9_bound['bound_ms']:.4f} ms ({r9_bound['bound_by']}; on every slot "
        f"{bound(nbytes, ops, rate)['bound_ms']:.4f})")
    if not mm["ok"]:
        failed.append("profile_r9 matmul_only: beyond bf16_agreement's rule")
    if not (fn["finite"] and cube_gate("profile_r9", fn)):
        failed.append("profile_r9 full_nobias: beyond twice the twin's one-ulp spread, or not finite")
    results["profile_r9"] = dict(max_abs_err=fn["err"], ms=fn["ms"], plain_ms=fn["plain_ms"], library_ms=None,
                                 **r9_bound, unequal=fn["unequal"], spread=fn["spread"], matmul_only_ms=mm["ms"],
                                 matmul_only_plain_ms=mm["plain_ms"], matmul_only_equal=mm["equal"],
                                 matmul_only_max_abs_err=mm["err"], matmul_only_past_own=mm["past_own"])
    del g2, mask, center
    torch.cuda.empty_cache()

    # K24
    gd = pa.script_grouping(torch.from_numpy(pa.script_clouds(np.random.default_rng(seed))).to(dev))
    if gd["overflow"]:
        raise AssertionError("the ablation's grouping overflowed")
    g2, w1, w2, center = gd["g2"], gd["w1"], gd["w2"], gd["center"]
    h2 = w1.shape[-1] // 2
    gen = torch.Generator().manual_seed(seed)
    reordered = tuple(permuted_mlp(*mlp, gen) for mlp in (gd["mlp1"], gd["mlp2"]))
    sets = {}
    for drop in pa.ALL_DROPS:
        name = pa.set_name(drop)
        kern = lambda drop=drop: pa.pe_ablate_cuda(g2, w1, w2, center, gd["packed"], drop)
        plain = lambda drop=drop, g=g2, c=center, mlps=(gd["mlp1"], gd["mlp2"]): pa.pe_ablate_plain(
            g, w1, w2, c, *mlps, drop)
        if not {"lrf", "stack", "mlp"} & set(drop):  # the output uses the frames
            r = twin_case(kern, plain, lambda drop=drop: plain(drop, up(g2), up(center)))
            ok = r["finite"] and cube_gate("pe_ablate", r)
            log(f"pe_ablate {name}: {r['unequal']} of {r['entries']} outputs unequal (plain vs itself one ulp up: "
                f"{r['spread']}), max |diff| {r['err']:.3e}, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
        else:
            r = bf16_case(kern, plain, lambda drop=drop: plain(drop, mlps=reordered))
            ok = r["ok"]
            log(f"pe_ablate {name}: {bf16_line(r)}")
        if not ok:
            failed.append(f"pe_ablate {name}: beyond its gate")
        sets[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"], max_abs_err=r["err"])
        torch.cuda.empty_cache()
    kept = (w1[..., :h2] > 0).sum().item() + (w2[..., :h2] > 0).sum().item()
    nbytes, ops, rate = tool["profile_pe_ablate.py:68"]
    ab_bound = bound(nbytes, SLOT_FLOPS * kept, BF16_FLOPS)
    log(f"pe_ablate 32x2048 (first 128 of 256 slots): kept slot-scales {kept} of {2 * w1[..., :h2].numel()}, bound "
        f"{ab_bound['bound_ms']:.4f} ms ({ab_bound['bound_by']}; on every slot "
        f"{bound(nbytes, ops, rate)['bound_ms']:.4f})")
    none = sets["fast_drop_none"]
    results["pe_ablate"] = dict(max_abs_err=none["max_abs_err"], ms=none["ms"], plain_ms=none["plain_ms"],
                                library_ms=None, **ab_bound, sets=sets)
    if failed:
        raise AssertionError("; ".join(failed))
    return results


def random_rotations(gen, shape, dev):
    """Uniform random rotations of ``shape`` + (3, 3) float32 (QR of Gaussians, determinant +1)."""
    import torch

    q, r = torch.linalg.qr(torch.randn(*shape, 3, 3, generator=gen, dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
    q = q * torch.sign(torch.linalg.det(q))[..., None, None]
    return q.float().to(dev)


def check_hypsel_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the coarse selection kernel K17 in its two modes (TP in the
    kernel from bf16 operands, row 18; TP read from the float32 product, row
    19) at the production path's shapes: 16 clouds of 196 FPS nodes, 300
    hypotheses, 196 model nodes. Against its plain twins bitwise (the same
    float32 operations in one order) and the same argmax; beside it the
    plain selection it replaces (the (B, P2, N1, N2) expansion-form
    distances), whose scores row 19 meets within 1e-4 relative (direct
    against expansion form), with the same argmax wherever the plain
    selection's best two scores lie further apart than that (row 18's bf16
    TP moves its scores by a few percent from the float32 plain selection:
    logged)."""
    import torch

    from unopose_tpu_torch.ops import hyp_select as hs
    from unopose_tpu_torch.ops.solver import select_scores_plain

    rng = np.random.default_rng(seed + 17)
    gen = torch.Generator().manual_seed(seed + 17)
    B, N, P2 = BATCH, 196, 300
    model = lrf_cloud(rng, dev, B, N)
    # the observed nodes: the model's under one pose per cloud, with noise; the hypotheses near it
    true_R = random_rotations(gen, (B,), dev)
    pts1 = torch.matmul(model, true_R.transpose(1, 2)) + 0.05 + 0.002 * torch.randn(B, N, 3, generator=gen).to(dev)
    skew = torch.randn(B, P2, 3, 3, generator=gen).to(dev)
    rs = torch.matmul(true_R[:, None], torch.linalg.matrix_exp(0.1 * (skew - skew.transpose(-1, -2))))
    ts = 0.05 + 0.01 * torch.randn(B, P2, 3, generator=gen).to(dev)
    w1 = torch.from_numpy((rng.random((B, N)) < 0.7).astype(np.float32)).to(dev)
    args = (pts1, model, rs, ts, w1)
    sel = select_scores_plain(*args)
    top2 = sel.topk(2, dim=1).values
    apart = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0]
    sel_ms = cuda_ms(lambda: select_scores_plain(*args), reps=3)
    results = {}
    for name, mode, kernel, plain in (
            ("hyp_select", 0, hs.hypothesis_select_scores_cuda, hs.hypothesis_select_scores_plain),
            ("hyp_select_v2", 1, hs.hypothesis_select_scores_v2_cuda, hs.hypothesis_select_scores_v2_plain)):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, want)
        sel_rel = ((got - sel).abs() / sel.abs()).max().item()
        sel_argmax = bool((got.argmax(1) == sel.argmax(1))[apart].all())
        argmax_ok = bool(torch.equal(got.argmax(1), want.argmax(1))) and (mode == 0 or sel_argmax)
        if mode == 0:
            launch = lambda: hs._dist_sums_cuda(0, pts1, model, w1, rs=rs, ts=ts)
            nbytes = 4 * (3 * B * N * 2 + 12 * B * P2 + B * N + B * P2)
            per_row = 21.0  # TP: 3 differences, 9 products, 6 sums; then the square root, the weight, the sum
        else:
            tp = hs.transform_f32(pts1, rs, ts)
            launch = lambda: hs._dist_sums_cuda(1, pts1, model, w1, tp=tp)
            nbytes = 4 * (3 * B * P2 * N + 3 * B * N + B * N + B * P2)
            per_row = 3.0
        # per (hypothesis, row, model point) 3 differences, 3 products, 2 sums and the min
        bnd = bound(nbytes, 9.0 * B * P2 * N * N + per_row * B * P2 * N, F32_FLOPS)
        r = dict(max_abs_err=(got - want).abs().max().item(), ms=cuda_ms(launch), plain_ms=cuda_ms(lambda: plain(*args),
                 reps=3), library_ms=None, **bnd, wrapper_ms=cuda_ms(lambda: kernel(*args)), plain_selection_ms=sel_ms,
                 plain_selection_max_rel=sel_rel, bitwise=bitwise, ties=int((~apart).sum()))
        results[name] = r
        log(f"{name} ({B} clouds x {P2} hypotheses, N1 = N2 = {N}; mode {mode}): bitwise equal to the plain twin "
            f"{bitwise}, argmax equal {argmax_ok}; vs the plain selection max rel {sel_rel:.3e}, argmax equal where "
            f"apart {sel_argmax}, clouds whose best two "
            f"plain scores lie within 1e-4 {r['ties']} of {B}; kernel {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} "
            f"ms), plain twin {r['plain_ms']:.3f} ms, plain selection {sel_ms:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if not bitwise or not argmax_ok or (mode == 1 and sel_rel > 1e-4):
            raise AssertionError(f"{name} differs from its plain twin or from the plain selection beyond its gates")
    return results


def check_frozen_kernels(log, dev, seed: int) -> dict:
    """Phase 3, the frozen-BN train stack at the train step's shapes (B 8, P
    2048, S 256 and 64): K12 on the buffer filled from the running
    statistics and K18 (the one-sweep backward) against their plain passes,
    K18 fed its own side's forward: the pooled output, the dW and every
    layer's sums of g and g zhat within 1e-2 of each tensor's max with the
    median under 1e-3 (the gates of K11-K14), the tie counts and two runs of
    K18 equal; then the whole autograd function against the frozen twin on
    autograd (2e-2, median 2e-3, the gates of the batch-statistics stack)."""
    import torch

    from unopose_tpu_torch.configs import pe_train_chans, pe_train_weights
    from unopose_tpu_torch.ops import pe_train as pt

    rng = np.random.default_rng(seed + 19)
    gen = torch.Generator().manual_seed(seed + 19)
    Bt, P = 8, 2048
    Ws, gammas, betas = pe_train_weights(dev, seed)
    occupancy = pe_train_occupancy(log, [("K18", "K18", 0)])["K18"]
    means = [(0.1 * torch.randn(d, generator=gen)).to(dev) for d in pt.DIMS[1:]]
    vars_ = [(0.5 + torch.rand(d, generator=gen)).to(dev) for d in pt.DIMS[1:]]

    def rel(got, want):
        d = (got - want).abs()
        scale = want.abs().max().clamp_min(1e-30)
        return (d.max() / scale).item(), (d.median() / scale).item()

    out = {}
    for S in (256, 64):
        chans = pe_train_chans(rng, dev, Bt, P, S)
        n = Bt * P * S
        bn = pt.frozen_buffer(gammas, betas, means, vars_, 1e-5, dev)
        pooled, cnt = pt.fwd_plain(chans, Ws, bn)
        k_pooled, k_cnt = pt.fwd_cuda(chans, Ws, bn)
        fwd_err, cnt_equal = rel(k_pooled, pooled), (k_cnt == cnt).float().mean().item()
        dpool = torch.from_numpy(rng.standard_normal((Bt, P, 128)).astype(np.float32)).to(dev)
        bn_plain, bn_k, bn_again = bn.clone(), bn.clone(), bn.clone()
        dws = pt.frozen_bwd_plain(chans, Ws, bn_plain, pooled, cnt, dpool)
        k_dws = pt.frozen_bwd_cuda(chans, Ws, bn_k, k_pooled, k_cnt, dpool)
        again = pt.frozen_bwd_cuda(chans, Ws, bn_again, k_pooled, k_cnt, dpool)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k_dws, again)) and torch.equal(bn_k, bn_again)
        dw_err = [rel(a, b) for a, b in zip(k_dws, dws)]
        sums = [(bn_k[l, row, :d], bn_plain[l, row, :d]) for l, d in enumerate(pt.DIMS[1:]) for row in (pt.SG, pt.SGZ)]
        sums_err = [rel(a, b) for a, b in sums]
        absolute = max(max((a - b).abs().max().item() for a, b in zip(k_dws, dws)),
                       max((a - b).abs().max().item() for a, b in sums))
        ms = cuda_ms(lambda: pt.frozen_bwd_cuda(chans, Ws, bn.clone(), k_pooled, k_cnt, dpool))
        plain_ms = cuda_ms(lambda: pt.frozen_bwd_plain(chans, Ws, bn.clone(), pooled, cnt, dpool), reps=2)
        fwd_ms = cuda_ms(lambda: pt.fwd_cuda(chans, Ws, bn))
        # K14's work (the recompute, every dz, the dW) and the sums; float32 chans, pooled, counts and dpool
        # read once, the dW and the sums written once
        chain = sum(a * b for a, b in zip(pt.DIMS[:-1], pt.DIMS[1:]))
        bnd = bound(chans.numel() * 4 + 3 * Bt * P * 128 * 4 + (pt.DW_SIZE + pt.FROZEN_SUMS) * 4,
                    2.0 * n * (2 * chain + 128 * 64 + 64 * 32), BF16_FLOPS)
        out[S] = dict(ms=ms, plain_ms=plain_ms, fwd_ms=fwd_ms, absolute=absolute, rel=max(e[0] for e in dw_err + sums_err),
                      same=same, **bnd)
        log(f"pe_train frozen S={S} ({Bt}x{P}x{S}): K12 on the running statistics: pooled (max, median of max) "
            f"{fwd_err}, tie counts equal {100 * cnt_equal:.4f}%, {fwd_ms:.3f} ms; K18 dW {dw_err}, sums (g, g zhat by "
            f"layer) {sums_err}, two runs equal {same}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if any(mx > 1e-2 or med > 1e-3 for mx, med in [fwd_err, *dw_err, *sums_err]) or cnt_equal < 1.0 or not same:
            raise AssertionError(f"the frozen-BN kernels at S={S} differ from their plain passes beyond the gates")
        del chans, bn, pooled, cnt, dpool, k_pooled, k_cnt
        torch.cuda.empty_cache()

    # the whole function on the card against the frozen twin on autograd, scale 2's shape
    chans = pe_train_chans(rng, dev, Bt, P, 256)
    R = torch.from_numpy(rng.standard_normal((Bt, P, 128)).astype(np.float32)).to(dev)
    grads = []
    for fn in (pt.pe_mlp_bn_pool_frozen, pt.pe_mlp_bn_pool_frozen_plain):
        params = [t.clone().requires_grad_() for t in (*Ws, *gammas, *betas)]
        pooled = fn(chans, params[:3], params[3:6], params[6:], means, vars_)
        (pooled * R).sum().backward()
        grads.append((pooled.detach(), [p.grad for p in params]))
        del pooled
        torch.cuda.empty_cache()
    (ko, kg), (po, pg) = grads
    whole = dict(pooled=rel(ko, po), grads=[rel(a, b) for a, b in zip(kg, pg)])
    log(f"pe_mlp_bn_pool_frozen whole function vs the frozen twin on autograd (S=256): {whole}")
    if any(mx > 2e-2 or med > 2e-3 for mx, med in [whole["pooled"], *whole["grads"]]):
        raise AssertionError("pe_mlp_bn_pool_frozen on the card differs from the frozen twin beyond its gates")
    main, small = out[256], out[64]
    return {"pe_train_frozen_bwd": dict(
        max_abs_err=main["absolute"], max_rel_err=main["rel"], ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=None, bound_ms=main["bound_ms"], bound_by=main["bound_by"], frozen_fwd_ms=main["fwd_ms"],
        s64_ms=small["ms"], s64_plain_ms=small["plain_ms"], s64_bound_ms=small["bound_ms"], occupancy=occupancy)}


def check_subset_8192(log, dev, seed: int) -> dict:
    """Phase 3, ``subset_config()``'s fine PE grouping at N 8192 (two clouds):
    both scales through K15 (the permuted cloud staged in two chunks),
    bitwise equal to the plain twin on every output, miss slots included."""
    import torch

    from unopose_tpu_torch.configs import subset_config
    from unopose_tpu_torch.kernels import LAUNCHES
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import ball_group_subset_plain

    fm = subset_config().fine_point_matching
    pe = FinePositionalEncoding(256, fm.pe_radius1, fm.pe_radius2, fm.nsample1, fm.nsample2, fused=True,
                                neighbor_mode="subset").to(dev)
    pts = lrf_cloud(np.random.default_rng(seed + 21), dev, 2, 8192)
    before = LAUNCHES["ball_group_subset"]
    g1, v1, g2, v2 = pe._subset_groups(pts)
    launched = LAUNCHES["ball_group_subset"] - before
    bitwise = True
    for (g, v), (r, S) in zip(((g1, v1), (g2, v2)), ((fm.pe_radius1, fm.nsample1), (fm.pe_radius2, fm.nsample2))):
        want = ball_group_subset_plain(r, S, pts)
        bitwise &= all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(g, want[0]))
        bitwise &= torch.equal(v, want[2])
        del want
    ms = cuda_ms(lambda: pe._subset_groups(pts))
    log(f"subset_config grouping at N 8192 (2 clouds, S {fm.nsample1} and {fm.nsample2}): K15 launched {launched}x, "
        f"every output bitwise equal to the plain twin {bitwise}, valid slots {100 * v1.float().mean().item():.2f}% / "
        f"{100 * v2.float().mean().item():.2f}%, both scales {ms:.3f} ms")
    if not bitwise or launched != 2:
        raise AssertionError("the subset grouping at N 8192 differs from its plain twin or skipped K15")
    torch.cuda.empty_cache()
    return dict(n8192_bitwise=bitwise, n8192_ms=ms)


def check_overflow(log, dev, seed: int) -> None:
    """Phase 4: a dense cloud overflows the packed budget; the plain PE, the
    fused PE-v5 and the fused PE under ``UNOPOSE_PE_V5=0`` (row 10) must
    take the exact fallback, launching no fused PE kernel, and its grouping
    (gather kernel included) must equal the CPU plain one."""
    import torch

    from unopose_tpu_torch.kernels import LAUNCHES
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import first_k_in_radius, sqdist_expansion, two_scale_group_first_k_packed
    from unopose_tpu_torch.tools.profile_slice import PE_OFF, V5_OFF, env_switch

    rng = np.random.default_rng(seed + 1)
    pts = torch.from_numpy(rng.uniform(-0.08, 0.08, size=(4, 2048, 3)).astype(np.float32))
    *_, overflow = two_scale_group_first_k_packed(0.1, 64, 0.2, 256, pts.to(dev))
    if not bool(overflow):
        raise AssertionError("the dense cloud did not overflow the packed grouping")
    # the plain PE, PE-v5, and row 10 (the fused PE on the materialised packed grouping, UNOPOSE_PE_V5=0)
    for fused, env, label in ((False, PE_OFF, "plain"), (True, PE_OFF, "PE-v5"), (True, V5_OFF, "row 10")):
        torch.manual_seed(seed)
        pe = FinePositionalEncoding(256, fused=fused).to(dev)
        before = dict(LAUNCHES)
        with env_switch(env), torch.no_grad():
            feat = pe(pts.to(dev))
            torch.cuda.synchronize()
            gathers = LAUNCHES["gather_planar"] - before.get("gather_planar", 0)
            fused_pe = sum(LAUNCHES[k] - before.get(k, 0) for k in ("pe_channels", "pe_mlp_pool") + PE_VARIANTS)
            if pe.last_branch != "exact" or not torch.isfinite(feat).all() or gathers == 0 or fused_pe:
                raise AssertionError(f"overflow fallback not taken, not finite, not gathered by the kernel or a fused "
                                     f"PE launched ({label} PE): {pe.last_branch}, {gathers} gather launches")
            feat_cpu = pe.cpu()(pts)
        err = (feat.cpu() - feat_cpu).abs().amax(-1)
        log(f"overflow ({label} PE): fallback taken ({pe.last_branch}), "
            f"{gathers} gather launches, PE vs CPU median row error {err.median().item():.2e}")
    for r, k in ((0.1, 64), (0.2, 256)):
        gpu = first_k_in_radius(sqdist_expansion(pts.to(dev), pts.to(dev)) < r * r, k).cpu()
        cpu = first_k_in_radius(sqdist_expansion(pts, pts) < r * r, k)
        if not torch.equal(gpu, cpu):
            raise AssertionError(f"exact grouping (r={r}, k={k}) differs between card and CPU")
    log("overflow: exact grouping equal to the CPU's")


def check_tiny(log, dev, seed: int, name: str) -> None:
    """Phase 5: a float32 tiny config, card (kernels) vs CPU (plain versions).

    The subset config's fine scores move by about the slice's gates on the
    CPU alone: its subset neighbourhoods hold a few points each, and their
    local frames flip under a one-ulp nudge of either cloud (ROADMAP Queue
    3). There the slice's fine-score gates hold the card's fine stage fed
    the CPU's PE features; the card's subset groupings of the CPU's PE input
    must equal the CPU's bit for bit; and the card's fine scores as they are
    must stay within twice the CPU's own largest one-ulp spread (median and
    95th percentile, four nudges)."""
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.models import UNOPose

    cfg = configs.CONFIGS[name](tiny=True)
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg, torch.float32, torch.float32).eval()
    rng = np.random.default_rng(seed + 2)
    inputs = configs.synthetic_inputs(rng, 2, tiny=True, npts=cfg.fine_npoint)
    uniforms = torch.from_numpy(rng.uniform(size=(2, 3 * cfg.coarse_point_matching.nproposal1)).astype(np.float32))
    pe, seen = model.fine_matching.pe, []
    own = pe.forward

    def record(pts):
        out = own(pts)
        seen.append((pts.cpu(), out.cpu()))
        return out

    pe.forward = record
    run = lambda where, inp: model({k: torch.from_numpy(v).to(where) for k, v in inp.items()},
                                   uniforms=uniforms.to(where), return_intermediates=True)
    out_cpu = run("cpu", inputs)
    branch_cpu = model.fine_matching.pe.last_branch
    fine_err = lambda out: (out["fine_score"].cpu() - out_cpu["fine_score"]).abs().flatten()
    quantiles = lambda e: (e.median().item(), e.quantile(0.95).item())
    subset = cfg.fine_point_matching.get("pe_neighbor_mode") == "subset"
    if subset:
        nudged = [quantiles(fine_err(run("cpu", {**inputs, k: np.nextafter(inputs[k], d * np.inf).astype(np.float32)})))
                  for k in ("pts", "tem1_pts") for d in (1, -1)]
        spread = tuple(max(q[i] for q in nudged) for i in range(2))
    model.to(dev)
    out_gpu = run(dev, inputs)
    idx_equal = all(torch.equal(out_gpu[k].cpu(), out_cpu[k]) for k in ("fps_idx_m", "fps_idx_o"))
    a_err = ((out_gpu["coarse_atten"].cpu() - out_cpu["coarse_atten"]).abs().max() / out_cpu["coarse_atten"].abs().max()).item()
    s_err = (out_gpu["coarse_score"].cpu() - out_cpu["coarse_score"]).abs().max().item()
    f_med, f_p95 = quantiles(fine_err(out_gpu))
    fine_ok, fine_note = f_med < 5e-3 and f_p95 < 5e-2, ""
    if subset:
        from unopose_tpu_torch.ops.ball_query import ball_group_subset, ball_group_subset_plain

        pe_in, pe_out = seen[0]
        fm = cfg.fine_point_matching
        groups_equal = True
        for r, k in ((fm.pe_radius1, fm.nsample1), (fm.pe_radius2, fm.nsample2)):
            got, want = ball_group_subset(r, k, pe_in.to(dev)), ball_group_subset_plain(r, k, pe_in)
            groups_equal &= all(torch.equal(a.cpu(), b) for a, b in zip((*got[0], *got[1:]), (*want[0], *want[1:])))
        pe.forward = lambda pts: pe_out.to(dev)
        r_med, r_p95 = quantiles(fine_err(run(dev, inputs)))
        fine_ok = (groups_equal and r_med < 5e-3 and r_p95 < 5e-2 and f_med <= 2 * spread[0]
                   and f_p95 <= 2 * spread[1])
        fine_note = (f" (the CPU's own one-ulp spread: median {spread[0]:.2e} p95 {spread[1]:.2e}); on the CPU's "
                     f"PE features: fine score median {r_med:.2e} p95 {r_p95:.2e}; subset groupings of the CPU's PE "
                     f"input equal {groups_equal}")
    pe.forward = own
    geo_ok, geo_note = True, ""
    if isinstance(out_cpu["geo"], tuple):
        (e8, sc), (e8_cpu, sc_cpu) = (out_gpu["geo"][0].cpu(), out_gpu["geo"][1].cpu()), out_cpu["geo"]
        geo_diff = (e8.int() - e8_cpu.int()).abs()
        sc_rel = ((sc - sc_cpu).abs() / sc_cpu.abs()).max().item()
        # the subset config's 512-point clouds put one code at a rounding tie: there the codes are held at
        # phase 3's gate for the embedding kernel (one step on at most 0.1% of entries), elsewhere equal
        steps_ok = int(geo_diff.max()) <= 1 and geo_diff.gt(0).float().mean().item() <= 1e-3 if subset else \
            int(geo_diff.max()) == 0
        geo_ok = steps_ok and sc_rel <= 1e-6
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
        f"coarse score {s_err:.2e}, fine score median {f_med:.2e} p95 {f_p95:.2e}{fine_note}, "
        f"PE branch {model.fine_matching.pe.last_branch}{geo_note}{labels_note}")
    if (not idx_equal or a_err > 1e-3 or s_err > 1e-4 or not fine_ok or not geo_ok
            or not labels_ok or model.fine_matching.pe.last_branch != branch_cpu):
        raise AssertionError(f"the tiny {name} config on the card disagrees with the CPU plain path")


def check_pe_routes(log, dev, seed: int) -> None:
    """Phase 5: the production fine PE (fused, budgets 64/256, seeded
    weights) on the card against the CPU with no switch, on uniform cubes
    of 2 clouds at N 576 and 1984 (N % 128 == 64: row 10, K19, on the card,
    neither K16 nor a raise) and at N 272 (N % 32 != 0: the unpacked
    grouping and the plain float32 MLP, as in the JAX package): the same
    branch on both, and the fused PE module's gates of the CPU tests
    (``test_fine_positional_encoding_fused_matches_jax``): median row error
    1e-3, and no more rows off by 0.05 than max(3, twice the CPU's own count
    one ulp up)."""
    import torch

    from unopose_tpu_torch.configs import production_config
    from unopose_tpu_torch.kernels import LAUNCHES
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.tools.profile_slice import PE_OFF, env_switch

    fm = production_config().fine_point_matching
    torch.manual_seed(seed)
    pe = FinePositionalEncoding(256, fm.pe_radius1, fm.pe_radius2, fm.nsample1, fm.nsample2, fused=True)
    rng = np.random.default_rng(seed + 41)
    for n, branch, kernel in ((576, "packed", "pe_packed"), (1984, "packed", "pe_packed"), (272, "unpacked_plain", None)):
        pts = lrf_cloud(rng, "cpu", 2, n)
        with env_switch(PE_OFF), torch.no_grad():
            pe.cpu()
            want = pe(pts)
            branch_cpu = pe.last_branch
            nudged = pe(torch.nextafter(pts, torch.full_like(pts, float("inf"))))
            pe.to(dev)
            before = dict(LAUNCHES)
            got = pe(pts.to(dev)).cpu()
            torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v - before.get(k, 0)}
        err = (got - want).abs().amax(-1)
        ulp = (nudged - want).abs().amax(-1)
        far, far_ulp = int((err > 0.05).sum()), int((ulp > 0.05).sum())
        log(f"fine PE N {n} (no switch), card vs CPU: branch {pe.last_branch} / {branch_cpu}, median row error "
            f"{err.median().item():.2e}, rows off by 0.05: {far} (CPU vs itself one ulp up: {far_ulp}), "
            f"launches {launched}")
        ok = (pe.last_branch == branch_cpu == branch and bool(torch.isfinite(got).all())
              and err.median().item() <= 1e-3 and far <= max(3, 2 * far_ulp) and "pe_masked" not in launched
              and (kernel is None or launched.get(kernel, 0) == 1))
        if not ok:
            raise AssertionError(f"the fine PE at N {n} on the card disagrees with the CPU or took another branch")


def check_tiny_hypsel(log, dev, seed: int) -> None:
    """Phase 5, the coarse selection under ``UNOPOSE_HYPSEL_V2=1`` on the
    float32 tiny production config, card (K17) against CPU (where the switch
    keeps the plain selection), same weights, inputs and draws. On the
    hypotheses the card's solver made: K17's scores within 1e-5 relative of
    its plain twin on the CPU (TP from each device's float32 product) and of
    a float64 evaluation, and the same argmax as the twin wherever the
    twin's best two scores lie further apart than that. The plain selection
    on the CPU is logged beside: its expansion-form distances cancel on the
    tiny clouds' close points (2.0e-4 relative, chip run). Then the card's
    forward with the switch against the card's forward without it (the same
    hypotheses): the coarse pose equal on the clouds whose best two scores
    lie 1e-3 apart, the score within 1e-3 relative. The CPU forward's coarse
    score, from its own hypotheses, is logged too."""
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.kernels import LAUNCHES
    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.ops import solver
    from unopose_tpu_torch.tools.profile_slice import PROFILES, env_switch

    cfg = configs.production_config(tiny=True)
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg, torch.float32, torch.float32).eval()
    rng = np.random.default_rng(seed + 4)
    inputs = configs.synthetic_inputs(rng, 2, tiny=True)
    uniforms = torch.from_numpy(rng.uniform(size=(2, 3 * cfg.coarse_point_matching.nproposal1)).astype(np.float32))
    run = lambda where: model({k: torch.from_numpy(v).to(where) for k, v in inputs.items()}, uniforms=uniforms.to(where))
    seen = []
    own = solver.hypothesis_select_scores_v2

    def record(*args):
        out = own(*args)
        seen.append(([a.cpu() for a in args], out.cpu()))
        return out

    solver.hypothesis_select_scores_v2 = record
    try:
        with env_switch(PROFILES["production_hypsel"][1]):
            out_cpu = run("cpu")
            model.to(dev)
            before = LAUNCHES["hyp_select_v2"]
            out_card = run(dev)
            launched = LAUNCHES["hyp_select_v2"] - before
        out_plain = run(dev)
    finally:
        solver.hypothesis_select_scores_v2 = own
    if len(seen) != 1 or launched != 1:
        raise AssertionError(f"the tiny hypsel run launched K17 {launched}x, recorded {len(seen)} calls (want 1)")
    from unopose_tpu_torch.ops import hyp_select as hs

    (args, got), = seen
    rel_of = lambda a, b: ((a - b).abs() / b.abs()).max().item()
    twin = hs.hypothesis_select_scores_v2_plain(*args)
    p1, m, r, t, w = (a.double() for a in args)
    tp = torch.matmul(p1[:, None] - t[:, :, None, :], r)
    d = ((tp[:, :, :, None, :] - m[:, None, None]) ** 2).sum(-1).amin(-1).sqrt()
    exact = (w.sum(1)[:, None] / ((d * w[:, None]).sum(2) + 1e-8)).float()
    plain = solver.select_scores_plain(*args)
    rel, rel_exact, rel_plain = rel_of(got, twin), rel_of(got, exact), rel_of(plain, exact)
    top2 = twin.topk(2, dim=1).values
    apart = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2[:, 0]
    argmax_ok = bool((got.argmax(1) == twin.argmax(1))[apart].all())
    top2 = plain.topk(2, dim=1).values
    wide = (top2[:, 0] - top2[:, 1]) > 1e-3 * top2[:, 0]
    R, R0 = out_card["init_R"].cpu(), out_plain["init_R"].cpu()
    pose_ok = bool(torch.equal(R[wide], R0[wide])
                   and torch.equal(out_card["init_t"].cpu()[wide], out_plain["init_t"].cpu()[wide]))
    score_rel = ((out_card["init_pose_score"] - out_plain["init_pose_score"]).abs()
                 / out_plain["init_pose_score"].abs()).max().item()
    cpu_rel = ((out_card["init_pose_score"].cpu() - out_cpu["init_pose_score"]).abs()
               / out_cpu["init_pose_score"].abs()).max().item()
    log(f"tiny fp32 production under UNOPOSE_HYPSEL_V2=1: K17 launched {launched}x on the card, none on the CPU; on "
        f"the card's hypotheses K17 vs the CPU's twin max rel {rel:.3e}, vs float64 {rel_exact:.3e} (the CPU's plain "
        f"selection vs float64 {rel_plain:.3e}), argmax equal to the twin's {argmax_ok} on the {int(apart.sum())} of "
        f"{len(apart)} clouds whose best two scores lie apart; card with vs without the switch: coarse pose equal on "
        f"the {int(wide.sum())} clouds 1e-3 apart {pose_ok}, score rel {score_rel:.3e}; card vs CPU coarse score rel "
        f"{cpu_rel:.3e} (not gated: each from its own hypotheses)")
    if rel > 1e-5 or rel_exact > 1e-5 or not argmax_ok or not pose_ok or score_rel > 1e-3:
        raise AssertionError("the selection kernel on the tiny production config disagrees with the plain selection")


def surface_train_inputs(rng, batch: int, npts: int | None = None, ntem: int | None = None) -> dict:
    """A tiny training batch (``configs.synthetic_train_inputs(tiny=True)``,
    at ``npts`` query and ``ntem`` template points where given)
    whose template lies on a bumpy closed surface with every 16th point 0.1 m
    out (they set the radius, so the surface stays dense after the
    normalisation), the observed cloud its points under the label pose: the
    PE's local frames are then mostly well conditioned, unlike on the
    uniform cubes, where a frame that flips between two devices moves the
    whole fine stage."""
    from unopose_tpu_torch.configs import synthetic_train_inputs

    b = synthetic_train_inputs(rng, batch, tiny=True, npts=npts, ntem=ntem)
    R, t, tem = b["rotation_label"], b["translation_label"], b["tem1_pts"]
    B, n = tem.shape[:2]
    dirs = rng.normal(size=(B, n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    bump = 1.0 + 0.25 * np.sin(3.0 * dirs[..., 0] + 1.0) * np.cos(2.0 * dirs[..., 1])
    tem = np.array([0.0, 0.0, 0.6]) + 0.03 * bump[..., None] * dirs + rng.normal(size=(B, n, 3)) * 5e-4
    far = rng.normal(size=(B, n // 16, 3))
    tem[:, ::16] = np.array([0.0, 0.0, 0.6]) + 0.1 * far / np.linalg.norm(far, axis=-1, keepdims=True)
    sel = rng.integers(0, n, size=b["pts"].shape[:2])
    pts = np.einsum("bij,bnj->bni", R, np.take_along_axis(tem, sel[..., None], axis=1)) + t[:, None]
    b.update(tem1_pts=tem.astype(np.float32), pts=(pts + 5e-4 * rng.standard_normal(pts.shape)).astype(np.float32))
    return b


def module_grads(trainer) -> dict:
    """The trainable gradients, flattened and joined per top-level module."""
    import torch

    out = {}
    for name, p in trainer.params:
        out.setdefault(name.split(".")[0], []).append(p.grad.detach().double().cpu().flatten())
    return {k: torch.cat(v) for k, v in out.items()}


def check_train_grouping(log, dev, seed: int) -> None:
    """Phase 5, the train path's grouping (``two_scale_group_first_k_fast``:
    the select and the gather kernels, then scale 1 sorted out of scale 2's
    slots) on the main path's clouds (B 8, N 2048, uniform cubes in their
    global LRF, the train config's radii and budgets) equal to the CPU's,
    slot for slot at both scales."""
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.ops.ball_query import two_scale_group_first_k_fast

    fm = configs.train_config().model.fine_point_matching
    args = (fm.pe_radius1, fm.nsample1, fm.pe_radius2, fm.nsample2)
    pts = lrf_cloud(np.random.default_rng(seed + 12), dev, 8, 2048)
    card = two_scale_group_first_k_fast(*args, pts)
    cpu = two_scale_group_first_k_fast(*args, pts.cpu())
    equal = all(torch.equal(a.cpu(), b) for ga, gb in zip(card, cpu) for a, b in zip(ga, gb))
    log(f"train grouping (8 x 2048, r/k {args}), card vs CPU: every slot equal {equal}")
    if not equal:
        raise AssertionError("the train grouping on the card differs from the CPU's")


def check_tiny_train(log, dev, seed: int, frozen: bool = False, subset: bool = False) -> None:
    """Phase 5, the train step: the float32 tiny ``train_config`` on surface
    clouds, one step from the same weights, batch and noise draws on the card
    (the PE train kernels) and on the CPU (their plain passes); with
    ``frozen``, under ``UNOPOSE_PE_TRAIN_FROZEN=1`` (K12 and K18 on the card,
    which must launch, and every run's fine-PE BatchNorm running statistics
    bitwise unchanged); with ``subset``, the subset-mode step of the tiny
    subset config (``subset_config(tiny=True)``, 512-point clouds, its ViT
    frozen): K15's groupings on the card (which must launch) and its
    plain version on the CPU, the masked channels and the plain MLP on both,
    gated as below with the groupings of the subset mode, and the card step
    fed the CPU step's channels also fed its PE features (the values; the
    card's PE keeps its own gradient), as the tiny subset inference check
    is: its bf16 activations, products rounded on each device, round a few
    entries the other way, and its few-point neighbourhoods carry that to
    the fine losses (measured 1.2e-3 of a fine score loss on the channels
    alone). The PE's
    local frames are ill conditioned on some neighbourhoods of these
    256-point clouds (ROADMAP Queue 3): their float32 sums and arccos run
    differently on each device, a frame that flips moves the fine stage, and
    with random weights the fine losses and every gradient upstream of it
    move with it. So the checks, each at a gate fixed here:

    - the grouping of each cloud the fine PE sees in the CPU step, made on
      the card, equals the CPU's slot for slot;
    - the PE's channels made on the card from the CPU step's clouds and
      groupings: the offsets bitwise equal, and every row whose local-frame
      coordinates differ from the CPU's by over 1e-3 one whose coordinates
      move that far on the CPU alone when the centres or the neighbours move
      one ulp up or down (an ill-conditioned row);
    - the card step with its fine PE fed the CPU step's channels (nothing
      else replaced): every loss term within 1e-3 relative, each top-level
      module's gradient at cosine >= 0.99, the fine PE's BatchNorm running
      buffers within 1e-3 of their max;
    - the card step as it is, where the fine PE does not reach (the coarse
      loss terms and the coarse matcher's gradient): the same gates. The
      rest of it is logged beside the CPU's own spread under one-ulp nudges
      of either cloud."""
    import copy

    import torch

    from unopose_tpu_torch.configs import train_config
    from unopose_tpu_torch.engine.train import Trainer
    from unopose_tpu_torch.kernels import LAUNCHES
    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import two_scale_group_first_k_fast
    from unopose_tpu_torch.ops.rotation import PoseNoiseDraws
    from unopose_tpu_torch.tools.profile_slice import env_switch

    from unopose_tpu_torch.configs import SUBSET_TINY_NPTS, TINY_SIZES, subset_config
    from unopose_tpu_torch.ops.ball_query import ball_group_subset

    title = "tiny fp32 train step" + (" (frozen BN)" if frozen else "") + (" (subset)" if subset else "")
    cfg = train_config(tiny=True)
    rng = np.random.default_rng(seed + 9)
    if subset:
        cfg.model = subset_config(tiny=True)
        batch = surface_train_inputs(rng, 2, SUBSET_TINY_NPTS, TINY_SIZES["ntem"] * 2)
    else:
        batch = surface_train_inputs(rng, 2)
    draws = PoseNoiseDraws.draw(2, torch.Generator().manual_seed(seed))
    torch.manual_seed(seed)
    state = copy.deepcopy(UNOPose.from_config(cfg.model, torch.float32, torch.float32).state_dict())

    def step(where, batch=batch, channels=None, features=None):
        """One step: (loss terms, module gradients, BN buffers) and each fine
        PE call's (cloud, grouping, channels, extra arguments, PE features)
        on the CPU; ``channels(i)``, if given, replaces the channels of
        call i, and ``features(c)`` the values of cloud c's PE features (its
        own PE's gradient kept)."""
        model = UNOPose.from_config(cfg.model, torch.float32, torch.float32)
        model.load_state_dict(state)
        model.to(where)
        pe, seen, outs = model.fine_matching.pe, [], []
        own, own_train = pe.train_channels, pe.forward_train

        def forward_train(pts):
            out = own_train(pts)
            if features is not None:
                out = out + (features(len(outs)).to(where) - out).detach()
            outs.append(out.detach().cpu())
            return out

        pe.forward_train = forward_train

        def record(center, grouped, r, *extra):
            chans = own(center, grouped, r, *extra) if channels is None else channels(len(seen)).to(where)
            seen.append((tuple(c.cpu() for c in center), tuple(g.cpu() for g in grouped), r, chans.cpu(),
                         tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in extra)))
            return chans

        pe.train_channels = record
        trainer = Trainer(model, cfg)
        with env_switch(FROZEN if frozen else {}):
            metrics = trainer.step({k: torch.from_numpy(v).to(where) for k, v in batch.items()},
                                   pose_noise=PoseNoiseDraws(draws.std_index, draws.angles.to(where),
                                                             draws.trans.to(where)))
        bns = {k: v.detach().cpu().double() for k, v in pe.named_buffers()}
        seen = [(*x, outs[i // 2]) for i, x in enumerate(seen)]
        return ({k: float(v) for k, v in metrics.items() if "loss" in k}, module_grads(trainer), bns), seen

    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()))

    def compare(a, b):
        """(term, 1 - cosine, BN) differences of run a against run b, and their gates."""
        (ma, ga, ba), (mb, gb_, bb) = a, b
        diffs = ({k: abs(ma[k] - mb[k]) for k in mb}, {k: 1 - cos(ga[k], gb_[k]) for k in gb_},
                 {k: (ba[k] - bb[k]).abs().max().item() for k in bb})
        gates = ({k: 1e-3 * abs(mb[k]) for k in mb}, {k: 0.01 for k in gb_},
                 {k: 1e-3 * bb[k].abs().max().item() for k in bb})
        return diffs, gates

    cpu, cpu_seen = step("cpu")
    before, subset_before = LAUNCHES["pe_train_frozen_bwd"], LAUNCHES["ball_group_subset"]
    card, card_seen = step(dev)
    # subset: the card's PE also takes the CPU's features, as the tiny subset inference check does
    replayed, _ = step(dev, channels=lambda i: cpu_seen[i][3],
                       features=(lambda c: cpu_seen[2 * c][5]) if subset else None)
    frozen_launches = LAUNCHES["pe_train_frozen_bwd"] - before
    subset_launches = LAUNCHES["ball_group_subset"] - subset_before
    spread = [compare(step("cpu", {**batch, k: np.nextafter(batch[k], d * np.inf).astype(np.float32)})[0], cpu)[0]
              for k in ("pts", "tem1_pts") for d in (1, -1)]
    spread = tuple({k: max(s[i][k] for s in spread) for k in spread[0][i]} for i in range(3))

    # the grouping of each cloud the CPU step's fine PE saw (calls 2c and 2c + 1: cloud c's scales 1 and 2)
    fm = cfg.model.fine_point_matching
    args = (fm.pe_radius1, fm.nsample1, fm.pe_radius2, fm.nsample2)
    grouping_equal = True
    for c in range(len(cpu_seen) // 2):
        pts = torch.stack(cpu_seen[2 * c][0], dim=-1).to(dev)
        if subset:  # each scale's planes and validity
            groups = [(*g, valid) for g, _, valid in (ball_group_subset(r, k, pts) for r, k in zip(args[::2], args[1::2]))]
            wants = [(*want, extra[0]) for _, want, _, _, extra, _ in cpu_seen[2 * c: 2 * c + 2]]
        else:
            groups, wants = two_scale_group_first_k_fast(*args, pts), [x[1] for x in cpu_seen[2 * c: 2 * c + 2]]
        for g, want in zip(groups, wants):
            grouping_equal &= all(torch.equal(a.cpu(), b) for a, b in zip(g, want))
    # the channels alone, from the CPU step's clouds and groupings: the offsets bitwise equal, and every
    # row (point, scale) whose local-frame coordinates differ by over 1e-3 one that moves that far on the
    # CPU when the centres or the neighbours move one ulp up or down
    channels = FinePositionalEncoding.train_channels
    up = lambda xs, d: tuple(torch.nextafter(x, torch.full_like(x, d * np.inf)) for x in xs)
    moved = lambda a, b: (a[:, 3:] - b[:, 3:]).abs().amax(dim=(1, 3)) > 1e-3  # (B, P)
    lrf_rows, offsets_equal = [], True
    for center, grouped, r, want, extra, _ in cpu_seen:
        on_card = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in extra)
        got = channels(tuple(x.to(dev) for x in center), tuple(x.to(dev) for x in grouped), r, *on_card).cpu()
        offsets_equal &= torch.equal(got[:, :3], want[:, :3])
        spread_rows = torch.zeros(want.shape[0], want.shape[2], dtype=torch.bool)
        for d in (1, -1):
            spread_rows |= (moved(channels(up(center, d), grouped, r, *extra), want)
                            | moved(channels(center, up(grouped, d), r, *extra), want))
        card_rows = moved(got, want)
        lrf_rows.append((int(card_rows.sum()), int(spread_rows.sum()), int((card_rows & spread_rows).sum())))
    lrf_ok = offsets_equal and all(c == both for c, _, both in lrf_rows)
    rows = [((a[3] - b[3]).abs().amax(dim=3) > 1e-4).float() for a, b in zip(card_seen, cpu_seen)]  # (B, 6, P)
    offsets = [r[:, :3].amax(dim=1).mean().item() for r in rows]
    frames = [r[:, 3:].amax(dim=1).mean().item() for r in rows]
    log(f"{title}: the grouping of the fine PE's clouds on the card equal to the CPU's "
        f"{grouping_equal}; on the CPU's clouds and groupings, channel offsets bitwise equal {offsets_equal}, "
        f"rows with local-frame coordinates off by over 1e-3 by call (card, CPU one-ulp spread, both) {lrf_rows} "
        f"of {cpu_seen[0][3].shape[0] * cpu_seen[0][3].shape[2]}; in the card step, channel rows off the CPU "
        f"step's by over 1e-4, by call: offsets {[round(x, 4) for x in offsets]}, local-frame coordinates "
        f"{[round(x, 4) for x in frames]}")

    worst = lambda d, g: max((v / max(g[k], 1e-30) for k, v in d.items()), default=0.0)
    failed = ([] if grouping_equal else ["grouping"]) + ([] if lrf_ok else ["channels"])
    coarse = lambda k: k.startswith("coarse")
    fed = "PE channels and features" if subset else "PE channels"
    for name, run, held in ((f"card on the CPU's {fed} vs CPU", replayed, lambda k: True),
                            ("card vs CPU, where the fine PE does not reach", card, coarse)):
        diffs, gates = (tuple({k: v for k, v in x.items() if held(k)} for x in y) for y in compare(run, cpu))
        ratios = [worst(d, g) for d, g in zip(diffs, gates)]
        log(f"{title}, {name}: loss {run[0]['loss']:.6f}, worst loss term "
            f"{max(diffs[0].values(), default=0.0):.2e}, 1 - module gradient cosines "
            f"{({k: round(v, 9) for k, v in diffs[1].items()})}, BN running buffers worst "
            f"{max(diffs[2].values(), default=0.0):.2e}; worst share of the gate (terms, cosines, BN) "
            f"{[round(r, 3) for r in ratios]}, of {[max(d, key=lambda k: d[k] / max(g[k], 1e-30), default=None) for d, g in zip(diffs, gates)]}")
        if max(ratios) > 1.0:
            failed.append(name)
    diffs, _ = compare(card, cpu)
    reached = [{k: v for k, v in d.items() if not coarse(k)} for d in diffs]
    log(f"{title}, card vs CPU where the fine PE reaches (not gated: its channels differ, see "
        f"above), against the CPU's own one-ulp spread: worst loss term {max(reached[0].values()):.2e} vs "
        f"{max(v for k, v in spread[0].items() if not coarse(k)):.2e}, 1 - cos {({k: round(v, 9) for k, v in reached[1].items()})} "
        f"vs {({k: round(v, 9) for k, v in spread[1].items() if not coarse(k)})}, BN {max(reached[2].values()):.2e} "
        f"vs {max(spread[2].values()):.2e}")
    if subset:
        log(f"{title}: K15 launched {subset_launches}x in the two card steps")
        if subset_launches != 8:
            failed.append("K15 launches")
    if frozen:
        start = {k[len("fine_matching.pe."):]: v.double() for k, v in state.items() if k.startswith("fine_matching.pe.")
                 and (k.endswith(".mean") or k.endswith(".var"))}
        unchanged = all(torch.equal(run[2][k], v) for run in (cpu, card, replayed) for k, v in start.items())
        log(f"{title}: K18 launched {frozen_launches}x in the two card steps, the {len(start)} running statistics "
            f"bitwise unchanged in every run {unchanged}")
        if frozen_launches != 8 or len(start) != 12 or not unchanged:
            failed.append("frozen BN (K18 launches or running statistics)")
    if failed:
        raise AssertionError(f"the {title} disagrees: {failed}")


def run_train(log, dev, seed: int, steps: int, frozen: bool = False, name: str = "train") -> dict:
    """The train path at full width: ``train_config()``, B = 8, bf16, seeded
    random weights, ``steps`` steps on synthetic batches. Checks the loss
    terms and the gradient norm, the frozen ViT, that every trainable module
    and all six BatchNorm layers of the fine PE moved, and the path's
    kernel launches; then one more step under the profiler for the device
    time and the PE train kernels' share of it. With ``frozen`` the
    ``train_frozen`` path, under ``UNOPOSE_PE_TRAIN_FROZEN=1``: there the six
    BatchNorm layers' gammas and betas must move and their running
    statistics stay bitwise unchanged. ``name`` one of ``TRAIN_VARIANTS``
    runs that configuration instead (``train_variant_config``), at the same
    gates, and ``train_full`` adds its own (``check_train_full``)."""
    from unopose_tpu_torch.tools.profile_slice import env_switch

    with env_switch(FROZEN if frozen else {}):
        return _run_train(log, dev, seed, steps, "train_frozen" if frozen else name)


def train_variant_config(name: str):
    """The train configuration of a path: ``train_config()``, with for
    ``train_subset`` the subset mode, for ``train_full`` every parameter
    trained, the clip at ``TRAIN_FULL_MAX_NORM`` and the EMA (decay 0.999)
    on a flat learning rate of 1e-4 (the warmup factor 1: the EMA moves by a
    thousandth of each parameter's move, which must stay above float32's
    resolution), and for ``train_pe_*`` the PE key of ``TRAIN_PE_VARIANTS``."""
    from unopose_tpu_torch import configs

    cfg = configs.train_config()
    if name == "train_subset":
        cfg.model.fine_point_matching.pe_neighbor_mode = "subset"
    elif name == "train_full":
        cfg.model.feature_extraction.freeze_vit = False
        cfg.train.clip_grad.update(enabled=True, params=configs.Config(max_norm=TRAIN_FULL_MAX_NORM, norm_type=2))
        cfg.train.model_ema = configs.Config(enabled=True, decay=0.999)
        cfg.lr_multiplier.warmup_factor = 1.0
    elif name in TRAIN_PE_VARIANTS:
        cfg.model.fine_point_matching.update(TRAIN_PE_VARIANTS[name])
    return cfg


def check_train_full(log, trainer, cfg, step_fn) -> dict:
    """The ``train_full`` gates around one more step (``step_fn()``): the
    gradient norm past ``TRAIN_FULL_MAX_NORM`` and the applied (clipped)
    gradients' global norm equal to it within float32 rounding (1e-5
    relative); the EMA equal, within one float32 ulp of each entry, to the
    host's ``decay * ema + (1 - decay) * new`` from the EMA and parameters
    copied before and after the step; then a checkpoint of the trainer
    saved and restored into a fresh model and trainer: the parameters and
    buffers, the EMA, the Adam state and the step count bitwise equal."""
    import shutil
    import tempfile

    import torch

    from unopose_tpu_torch.engine.train import Trainer
    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.utils.checkpoint import Checkpointer

    ema_before = {n: e.to("cpu", copy=True) for n, e in trainer.ema.items()}
    p_before = {n: p.detach().to("cpu", copy=True) for n, p in trainer.params}
    metrics = step_fn()
    torch.cuda.synchronize()
    norm = float(metrics["grad_norm"])
    applied = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad) for _, p in trainer.params])))
    decay = trainer.ema_decay
    worst, bitwise, n_moved = 0.0, True, 0
    for n, p in trainer.params:
        want = decay * ema_before[n] + (1.0 - decay) * p.detach().cpu()
        got = trainer.ema[n].cpu()
        worst = max(worst, ((got - want).abs() / torch.from_numpy(np.spacing(want.abs().numpy()))).max().item())
        bitwise &= torch.equal(got, want)
        n_moved += not torch.equal(got, ema_before[n])
    vit_moved = all(not torch.equal(p.detach().cpu(), p_before[n]) for n, p in trainer.params if ".vit.blocks" in n)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = Checkpointer(tmp)
        t0 = time.perf_counter()
        ckpt.save(trainer.iteration, trainer)
        save_s = time.perf_counter() - t0
        device = next(trainer.model.parameters()).device
        fresh = Trainer(UNOPose.from_config(cfg.model, torch.bfloat16, torch.bfloat16).to(device), cfg)
        t0 = time.perf_counter()
        ckpt.restore(fresh)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state, restored = trainer.model.state_dict(), fresh.model.state_dict()
    same_model = all(torch.equal(v, restored[k]) for k, v in state.items())
    same_ema = all(torch.equal(v, fresh.ema[k]) for k, v in trainer.ema.items())
    sa, sb = trainer.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    same_adam = sa.keys() == sb.keys() and all(torch.equal(v, sb[i][k]) for i in sa for k, v in sa[i].items())
    figures = dict(grad_norm=norm, applied_norm=applied, ema_worst_ulps=worst, ema_bitwise=bitwise,
                   ema_entries_moved=n_moved, vit_moved=vit_moved, checkpoint_save_s=save_s,
                   checkpoint_restore_s=restore_s, restored_bitwise=dict(model=same_model, ema=same_ema, adam=same_adam,
                                                                         iteration=fresh.iteration == trainer.iteration))
    log(f"train_full gates: {json.dumps(figures)}")
    if not (norm > TRAIN_FULL_MAX_NORM and abs(applied - TRAIN_FULL_MAX_NORM) <= 1e-5 * TRAIN_FULL_MAX_NORM
            and worst <= 1.0 and n_moved and vit_moved and all(figures["restored_bitwise"].values())):
        raise AssertionError(f"train_full: the clip, the EMA, the ViT's update or the checkpoint's restore: {figures}")
    del fresh
    return figures


def _run_train(log, dev, seed: int, steps: int, name: str) -> dict:
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.engine.train import Trainer
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.models import UNOPose

    cfg = train_variant_config(name)
    freeze = cfg.model.feature_extraction.get("freeze_vit", False)
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg.model, torch.bfloat16, torch.bfloat16).to(dev)
    trainer = Trainer(model, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed + 11)
    extra = 2 if name == "train_full" else 1  # the profiled step, and train_full's gated one
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in configs.synthetic_train_inputs(rng, cfg.batch_size).items()}
               for _ in range(steps + extra)]
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if "vit" in n and freeze}
    before = {n: p.detach().clone() for n, p in trainer.params}
    bn_before = {n: b.clone() for n, b in model.fine_matching.pe.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    times = []
    for i, batch in enumerate(batches[:steps]):
        t0 = time.perf_counter()
        metrics = trainer.step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        log(f"{name} step {i}: {times[-1]:.1f} ms, loss {m['loss']:.4f}, grad norm {m['grad_norm']:.4f}, "
            f"fine acc {m['fine_acc']:.4f}, coarse acc {m['coarse_hard_acc']:.4f}")
        if bad or not m["grad_norm"] > 0:
            raise AssertionError(f"{name} step {i}: non-finite {bad} or a zero gradient norm: {m}")
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    missing = [k for k in PATH_KERNELS[name] if launches.get(k, 0) == 0]
    stray = [k for k in PATH_NOT_LAUNCHED[name] if launches.get(k, 0)]
    if missing or stray:
        raise AssertionError(f"the {name} path: kernels never launched {missing}, kernels of another path {stray}")
    if not all(torch.equal(p.detach(), frozen[n]) for n, p in model.named_parameters() if n in frozen):
        raise AssertionError("a frozen ViT parameter moved")
    moved = {}
    for n, p in trainer.params:
        part = "vit" if ".vit." in n else n.split(".")[0]  # the trained ViT counts as its own module
        moved[part] = moved.get(part, False) or not torch.equal(p.detach(), before[n])
    bns = dict(model.fine_matching.pe.named_buffers())
    bn_moved = {n: not torch.equal(bns[n], bn_before[n]) for n in bn_before}
    if name == "train_frozen":
        affine = {n: not torch.equal(p.detach(), before[n]) for n, p in trainer.params
                  if ".pe.mlp" in n and "_bn" in n}
        log(f"{name}: the 12 gammas and betas of the fine PE's BatchNorm moved {sum(affine.values())}/{len(affine)}, "
            f"its 12 running statistics unchanged {len(bn_moved) - sum(bn_moved.values())}/{len(bn_moved)}")
        if not all(moved.values()) or len(affine) != 12 or not all(affine.values()) or len(bn_moved) != 12 \
                or any(bn_moved.values()):
            raise AssertionError(f"{name}: a module or a BatchNorm gamma/beta did not move, or a running statistic "
                                 f"moved: {moved}, {affine}, {bn_moved}")
    elif not all(moved.values()) or len(bn_moved) != 12 or not all(bn_moved.values()):
        raise AssertionError(f"a trainable module or a BatchNorm buffer of the fine PE did not move: {moved}, {bn_moved}")
    log(f"{name}: trainable modules moved {moved}, the fine PE's 12 running statistics moved "
        f"{sum(bn_moved.values())}/{len(bn_moved)}")
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    gates = check_train_full(log, trainer, cfg, lambda: trainer.step(batches[-1], generator=gen)) \
        if name == "train_full" else None

    # one more step under the profiler: the kernels' time, the device's busy share, the PE train kernels' part
    from unopose_tpu_torch.tools.profile_slice import PE_TRAIN, kernel_summary

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.step(batches[steps], generator=gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof_sum = kernel_summary(prof, wall, set())
    pe_ms = sum(prof_sum["hand_written_ms"][k] for k in PE_TRAIN)
    log(f"{name}: ms per {cfg.batch_size}-sample step {['%.1f' % x for x in times]} (first includes warm-up), "
        f"steady {steady:.1f} ms = {cfg.batch_size * 1e3 / steady:.2f} samples/s, peak memory {peak:.2f} GiB, "
        f"launches {launches}")
    log(f"{name}, profiled step: wall {wall:.1f} ms, {prof_sum['kernels']} kernels, {prof_sum['kernel_ms']:.2f} ms of "
        f"kernels, device busy {prof_sum['busy_ms']:.2f} ms (idle {100 * prof_sum['idle_share']:.1f}%), PE train "
        f"kernels {pe_ms:.2f} ms ({100 * pe_ms / prof_sum['kernel_ms']:.1f}% of the kernel time); top kernels "
        + ", ".join(f"{k['name'][:60]} {k['ms']:.2f} ms x{k['count']}" for k in prof_sum["top"][:8]))
    del model, trainer, batches
    torch.cuda.empty_cache()
    out = dict(launches=launches, steady_ms=steady, peak_gib=peak, profiled=prof_sum, pe_train_ms=pe_ms)
    return out if gates is None else dict(out, gates=gates)


def run_path(log, dev, seed: int, batches: int, name: str) -> dict:
    """Phase 6: one main path at full width (a profile of
    ``tools/profile_slice.py:PROFILES``: a config of ``configs.CONFIGS``, or
    the production config under an environment switch). Returns timing, peak memory and
    its launch counts."""
    from unopose_tpu_torch.tools.profile_slice import PROFILES, env_switch

    config, env = PROFILES[name]
    with env_switch(env):
        return _run_path(log, dev, seed, batches, name, config)


def run_backbone(log, dev, seed: int, vit_type: str) -> dict:
    """Phase 6: the production inference forward with the ViT backbone
    ``vit_type`` (its width in ``embed_dim``), two 16-pair batches (the
    second steady): the pose gates and launches of the production path (``backbone_<vit_type>``), K7
    at the variant's token count and heads."""
    from unopose_tpu_torch import configs
    from unopose_tpu_torch.models.vit import VIT_VARIANTS
    from unopose_tpu_torch.tools.profile_slice import PE_OFF, env_switch

    def config():
        cfg = configs.production_config()
        cfg.feature_extraction.update(vit_type=vit_type, embed_dim=VIT_VARIANTS[vit_type]["embed_dim"])
        return cfg

    with env_switch(PE_OFF):
        return _run_path(log, dev, seed, 2, f"backbone_{vit_type}", config)


def _run_path(log, dev, seed: int, batches: int, name: str, config) -> dict:
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.models import UNOPose

    cfg = config()
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
        R, t, score = out["pred_R"], out["pred_t"], out["pred_pose_score"]
        orth, det, finite = pose_check(R, t, score)
        log(f"{name} batch {i}: {times[-1]:.1f} ms, PE branch {model.fine_matching.pe.last_branch}, "
            f"|RR^T - I| {orth:.2e}, |det - 1| {det:.2e}, finite {finite}, "
            f"pose score mean {score.mean().item():.3f}")
        if not finite or orth > 1e-3 or det > 1e-3 or tuple(R.shape) != (BATCH, 3, 3) or tuple(t.shape) != (BATCH, 3):
            raise AssertionError(f"{name} batch {i}: poses are not finite orthonormal (B, 3, 3) / (B, 3)")
    launches = dict(LAUNCHES)
    check_launches(name, launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    log(f"{name}: ms per 16-pair batch {['%.1f' % x for x in times]} (first includes warm-up), "
        f"steady {steady:.1f} ms = {BATCH * 1e3 / steady:.1f} pairs/s, peak memory {peak:.2f} GiB, "
        f"launches {launches}")
    del model, batch_inputs
    torch.cuda.empty_cache()
    return dict(launches=launches, steady_ms=steady, peak_gib=peak)


def check_launches(name: str, launches: dict) -> None:
    """Every kernel of the path launched, and none that the path must not launch."""
    missing = [k for k in PATH_KERNELS[name] if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {name} path: {missing}")
    stray = [k for k in PATH_NOT_LAUNCHED.get(name, ()) if launches.get(k, 0)]
    if stray:
        raise AssertionError(f"kernels of another PE path launched on the {name} path: {stray}")


def pose_check(R, t, score) -> tuple:
    """(|RR^T - I|, |det R - 1|, all finite) of a batch of poses."""
    import torch

    R = R.double()
    eye = torch.eye(3, dtype=torch.float64, device=R.device).expand_as(R)
    finite = bool(torch.isfinite(R).all() and torch.isfinite(t).all() and torch.isfinite(score).all())
    return ((R @ R.transpose(1, 2) - eye).abs().max().item(), (torch.linalg.det(R) - 1).abs().max().item(), finite)


# the eval path's synthetic BOP tree: 480 x 640 frames with the standard BOP camera, query images 1-n (n
# EVAL_IMAGES, or EVAL_MEASURED_IMAGES under --eval-only) and the reference image n + 1 of scene 48, two cube objects, and EVAL_DETS
# detections of each object in each query image (each its GT mask shifted a little): 2 x EVAL_DETS instances an
# image, over one chunk of BATCH, all on the two references (48, n + 1, 5) and (48, n + 1, 6)
EVAL_K = np.array([[572.4, 0.0, 320.0], [0.0, 573.6, 240.0], [0.0, 0.0, 1.0]])
EVAL_IMAGES, EVAL_DETS = 3, 10
# --eval-only: runs in one process (the first cold), query images a run (enough that the steady window, the
# images but EVAL_EDGE_IMAGES at each end, holds most chunks), and those edges (the first: the cold first chunk
# and the template encode; the last: the reader, reading 2 images ahead, has stopped)
EVAL_MEASURED_RUNS, EVAL_MEASURED_IMAGES, EVAL_EDGE_IMAGES = 3, 40, 2
# obj_id -> (rows, cols, depth mm, cube side mm)
EVAL_OBJECTS = {5: ((150, 250), (200, 300), 900, 120.0), 6: ((210, 290), (380, 460), 800, 90.0)}
# the cached forward's poses against the uncached forward's on one chunk at the same draws (bf16, full width):
# bitwise equal on the card at seeds 0 and 1 (NVIDIA H100 80GB HBM3, 700.00 W), the query's ViT at batch 16
# giving the bits of the 2B batch; the gate leaves float32 rounding room (rotation rad, translation m, score)
EVAL_CACHE_TOL = dict(rot=1e-5, t=1e-5, score=1e-5)


def write_bop_tree(root: str, seed: int, n_images: int = EVAL_IMAGES) -> tuple:
    """The eval path's BOP tree of ``n_images`` query images under ``root`` (PNGs by the port's stdlib writer, as
    the card has no imageio):
    ``ycbv/test/000048`` (rgb, depth with a 1.5 m background, mask_visib, scene_gt / _info / camera), the
    cross-scene reference map, the detections, the BOP19 targets and the two cubes' meshes and
    ``models_info.json``. Returns (detection path, detections, distinct references)."""
    from unopose_tpu_torch.data.png import write_png
    from unopose_tpu_torch.data.preprocess import binary_mask_to_rle

    rng = np.random.default_rng(seed)
    H, W = 480, 640
    images, ref_image = tuple(range(1, n_images + 1)), n_images + 1
    ds = os.path.join(root, "ycbv")
    scene = os.path.join(ds, "test", "000048")
    for sub in ("depth", "rgb", "mask_visib"):
        os.makedirs(os.path.join(scene, sub))
    depth = np.full((H, W), 1500, np.uint16)
    masks = {}
    for obj, ((r0, r1), (c0, c1), z, _) in EVAL_OBJECTS.items():
        depth[r0:r1, c0:c1] = z
        masks[obj] = np.zeros((H, W), bool)
        masks[obj][r0:r1, c0:c1] = True
    gts, infos, cams = {}, {}, {}
    for im in images + (ref_image,):
        write_png(os.path.join(scene, "depth", f"{im:06d}.png"), depth)
        write_png(os.path.join(scene, "rgb", f"{im:06d}.png"), rng.integers(0, 255, (H, W, 3)).astype(np.uint8))
        gts[str(im)], infos[str(im)] = [], []
        for i, (obj, (_, _, z, _)) in enumerate(EVAL_OBJECTS.items()):
            write_png(os.path.join(scene, "mask_visib", f"{im:06d}_{i:06d}.png"), masks[obj].astype(np.uint8) * 255)
            gts[str(im)].append(dict(obj_id=obj, cam_R_m2c=np.eye(3).reshape(-1).tolist(), cam_t_m2c=[0, 0, float(z)]))
            infos[str(im)].append(dict(visib_fract=1.0))
        cams[str(im)] = dict(cam_K=EVAL_K.reshape(-1).tolist(), depth_scale=1.0)
    for name, d in (("scene_gt", gts), ("scene_gt_info", infos), ("scene_camera", cams)):
        with open(os.path.join(scene, f"{name}.json"), "w") as f:
            json.dump(d, f)
    with open(os.path.join(ds, "test_ref_targets_crossscene_rot50.json"), "w") as f:
        json.dump([dict(scene_id=48, im_id=im, obj_id=obj, ref_scene_id=48, ref_im_id=ref_image)
                   for im in images for obj in EVAL_OBJECTS], f)
    dets = []
    for im in images:
        for obj in EVAL_OBJECTS:
            for k in range(EVAL_DETS):
                m = np.roll(masks[obj], (k % 3 - 1, k // 3 - 1), axis=(0, 1))
                dets.append(dict(scene_id=48, image_id=im, category_id=obj, score=float(0.3 + 0.06 * k), time=0.05,
                                 segmentation=binary_mask_to_rle(m)))
    det_path = os.path.join(root, "dets.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    with open(os.path.join(ds, "test_targets_bop19.json"), "w") as f:
        json.dump([dict(scene_id=48, im_id=im, obj_id=obj, inst_count=1) for im in images for obj in EVAL_OBJECTS], f)
    models = os.path.join(ds, "models_eval")
    os.makedirs(models)
    info = {}
    faces = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
             [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    for obj, (_, _, _, side) in EVAL_OBJECTS.items():
        h = side / 2
        pts = [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)]
        with open(os.path.join(models, f"obj_{obj:06d}.ply"), "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex 8\nproperty float x\nproperty float y\nproperty float z\n"
                    f"element face 12\nproperty list uchar int vertex_indices\nend_header\n")
            f.writelines(f"{x} {y} {z}\n" for x, y, z in pts)
            f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)
        info[str(obj)] = {"diameter": float(side * np.sqrt(3.0))}
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(info, f)
    return det_path, dets, {(48, ref_image, obj) for obj in EVAL_OBJECTS}


def run_eval(log, dev, seed: int, n_images: int = EVAL_IMAGES) -> dict:
    """Phase 6, the evaluation entry point: ``main_unopose.main([... "--eval-only"])`` at full width
    (``configs.eval_config()``: the production model, 224 px, 2048 observed and 5000 template points, chunks of 16,
    the template cache on; bf16) on ``write_bop_tree``'s tree. Gates: one seven-column CSV row per kept detection,
    every pose valid, the scores JSON's AR finite, each distinct reference encoded once; then, on the first
    chunk, the cached forward against the uncached one at the same draws (``check_eval_cache``)."""
    import tempfile

    import torch

    from unopose_tpu_torch import main_unopose
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    with tempfile.TemporaryDirectory(prefix="unopose_eval_") as tmp:
        det_path, dets, refs = write_bop_tree(tmp, seed, n_images)
        out_dir = os.path.join(tmp, "out")
        argv = ["--eval-only", "--device", str(dev), "--config", "unopose_tpu_torch.configs:eval_config",
                f"misc.output_dir={out_dir!r}", "misc.exp_name='smoke'",
                f"dataloader.test.data_dir={tmp!r}", f"dataloader.test.detection_path={det_path!r}",
                "train.matcher_dtype='bfloat16'"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = main_unopose.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        check_launches("eval", launches)
        stats = result["stats"]
        rows = [line.split(",") for line in open(result["csv"]).read().splitlines() if line]
        if len(rows) != len(dets) or any(len(r) != 7 for r in rows):
            raise AssertionError(f"eval: {len(rows)} CSV rows (want {len(dets)}, one per detection, 7 columns each)")
        R = torch.tensor(np.stack([np.array(r[4].split(), np.float64).reshape(3, 3) for r in rows]))
        t = torch.tensor(np.stack([np.array(r[5].split(), np.float64) for r in rows]))
        score = torch.tensor([float(r[3]) for r in rows])
        orth, det, finite = pose_check(R, t, score)
        ar = result["scores"]["AR"] if result["scores"] else float("nan")
        with open(result["csv"].replace(".csv", "_scores.json")) as f:
            ar_json = json.load(f)["AR"]
        ms = stats["chunk_ms"]
        from unopose_tpu_torch.data import preprocess

        log(f"eval: read by {'imageio' if preprocess.imageio else 'data/png.py'}, resized by cv2")
        log(f"eval: {stats['images']} images, {len(rows)} instances, {stats['chunks']} chunks of {BATCH} in "
            f"{stats['seconds']:.2f} s = {stats['images'] / stats['seconds']:.2f} images/s (main() {wall:.1f} s with "
            f"the model's build and the scoring), {stats['wait_s']:.2f} s of it waiting for the reader; ms per chunk {['%.1f' % x for x in ms]}, median {np.median(ms):.1f}; template cache: "
            f"{stats['templates_encoded']} references encoded in {stats['template_calls']} calls, "
            f"{stats['cache_hits']} hits; |RR^T - I| {orth:.2e}, |det - 1| {det:.2e}, finite {finite}; AR {ar:.4f}; "
            f"launches {launches}")
        if not finite or orth > 1e-3 or det > 1e-3:
            raise AssertionError("eval: the CSV's poses are not finite orthonormal")
        if not np.isfinite(ar_json) or ar_json != ar or result["scores"]["n_images"] != n_images:
            raise AssertionError(f"eval: scores JSON AR {ar_json}, returned {ar}, images {result['scores']['n_images']}")
        if stats["templates_encoded"] != len(refs) or stats["cache_hits"] != len(dets) - len(refs):
            raise AssertionError(f"eval: {stats['templates_encoded']} references encoded and {stats['cache_hits']} "
                                 f"cache hits (want {len(refs)} and {len(dets) - len(refs)})")
        cache = check_eval_cache(log, dev, seed, tmp, det_path)
    torch.cuda.empty_cache()
    return dict(launches=launches, images_per_s=stats["images"] / stats["seconds"], chunk_ms=float(np.median(ms)),
                wait_s=stats["wait_s"], cache_hits=stats["cache_hits"], cache=cache, stats=stats)


def eval_steady(stats: dict) -> dict:
    """One ``--eval-only`` run's figures: images/s over the whole run, and over its steady window (the images
    after the first ``EVAL_EDGE_IMAGES`` and before the last ``EVAL_EDGE_IMAGES``, on the host clock of
    ``run_inference``'s image ends); the first chunk's ms, and the median, lowest and highest chunk ms of the
    window, of the images before it and of those after it."""
    ends, ms, e = stats["image_end_s"], stats["chunk_ms"], EVAL_EDGE_IMAGES
    per = stats["chunks"] // stats["images"]
    n = stats["images"]

    def spread(xs):
        return dict(median=float(np.median(xs)), low=float(np.min(xs)), high=float(np.max(xs)))

    return dict(images=n, chunks=stats["chunks"], seconds=stats["seconds"], wait_s=stats["wait_s"],
                images_per_s=n / stats["seconds"], steady_images_per_s=(n - 2 * e) / (ends[n - e - 1] - ends[e - 1]),
                first_chunk_ms=ms[0], head_chunk_ms=spread(ms[:e * per]), steady_chunk_ms=spread(ms[e * per:-e * per]),
                tail_chunk_ms=spread(ms[-e * per:]))


def check_eval_cache(log, dev, seed: int, root: str, det_path: str) -> dict:
    """The eval path's first chunk through the launcher's model (seed 0, bf16) twice at the same uniforms: with
    the template cache's inputs (``encode_template`` of the chunk's references) and with the crops (the uncached
    forward, query and reference through the ViT as one 2B batch). The radius must be bitwise equal; the poses
    within ``EVAL_CACHE_TOL`` (the ViT's other batch may move bf16 bits)."""
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.data.dataset_test import BOPTestsetPoseFreeOneRef
    from unopose_tpu_torch.engine.inference import pad_to
    from unopose_tpu_torch.models import UNOPose

    cfg = configs.eval_config()
    test = cfg.dataloader.test
    test.update(data_dir=root, detection_path=det_path)
    data = BOPTestsetPoseFreeOneRef(test, eval_dataset_name="ycbv", detection_path=det_path)[0]
    torch.manual_seed(0)
    model = UNOPose.from_config(cfg.model, torch.bfloat16, torch.bfloat16).to(dev).eval()
    keys = ("pts", "rgb", "rgb_choose", "tem1_rgb", "tem1_choose", "tem1_pts")
    inputs = {k: torch.from_numpy(pad_to(data[k][:BATCH], BATCH)).to(dev) for k in keys}
    gen = torch.Generator(device=dev).manual_seed(seed)
    uniforms = torch.rand((BATCH, 3 * cfg.model.coarse_point_matching.nproposal1), generator=gen, device=dev)
    plain = model(inputs, uniforms=uniforms)
    tem = model.encode_template(inputs["tem1_rgb"], inputs["tem1_choose"], inputs["tem1_pts"])
    cached = model({**{k: inputs[k] for k in keys[:3]}, **tem}, uniforms=uniforms)
    d = plain["pred_R"].double() - cached["pred_R"].double()
    r = dict(radius_equal=bool(torch.equal(plain["radius"], cached["radius"])),
             rot=float((torch.linalg.matrix_norm(d) / np.sqrt(2.0)).max()),
             t=float((plain["pred_t"] - cached["pred_t"]).abs().max()),
             score=float((plain["pred_pose_score"] - cached["pred_pose_score"]).abs().max()),
             init_rot=float((plain["init_R"] - cached["init_R"]).abs().max()),
             poses_bitwise=all(torch.equal(plain[k], cached[k]) for k in ("pred_R", "pred_t", "pred_pose_score")))
    log(f"eval cache check (first chunk, cached vs uncached, same draws): radius bitwise {r['radius_equal']}, pose "
        f"rotation {r['rot']:.3e} rad, translation {r['t']:.3e} m, pose score {r['score']:.3e}, init R "
        f"{r['init_rot']:.3e}, poses bitwise {r['poses_bitwise']} (gates {EVAL_CACHE_TOL})")
    if not r["radius_equal"] or any(r[k] > v for k, v in EVAL_CACHE_TOL.items()):
        raise AssertionError(f"eval: cached and uncached forwards differ: {r}")
    del model
    return r


# the train_launcher path: main_unopose's train branch at main_config()'s full width, B 8 (the per-rank batch of the
# published recipe): LAUNCHER_STEPS synthetic iterations (log every one, a checkpoint every 2 kept 2, an evaluation
# every 2 on write_bop_tree's tree), a resume to LAUNCHER_RESUME_STEPS, LAUNCHER_READER_STEPS iterations of the
# MegaPose reader on write_megapose_tree's tree through train_loader with its 8 workers, --eval-only from the
# checkpoint; then one step at the JAX launcher's global batch (configs.GLOBAL_BATCH) as a finding
LAUNCHER_BATCH, LAUNCHER_STEPS, LAUNCHER_RESUME_STEPS, LAUNCHER_READER_STEPS = 8, 4, 6, 3
# the ViT-B/14-reg4 DINOv2 checkpoint's layout in timm's names: width, depth, MLP width, patch, register tokens,
# and the 37 x 37 grid of its 518 px pretraining
TIMM_VIT = dict(dim=768, depth=12, mlp=3072, patch=14, reg=4, grid=37)
# the MegaPose tree: MEGAPOSE_KEYS 480 x 640 images in one GSO shard, two objects taking turns (obj_id -> rows,
# cols, depth mm); each image's visible mask is its object's box, its reference list every image of the object
MEGAPOSE_KEYS = 16
MEGAPOSE_OBJECTS = {1: ((140, 260), (220, 340), 800), 2: ((200, 300), (360, 470), 900)}


def write_fake_timm(path: str, seed: int) -> dict:
    """Seeded random ViT-B/14-reg4 tensors in timm's names (``pos_embed`` on the 37 x 37 grid) saved to ``path``
    as a ``.pth``; returns them (numpy)."""
    import torch

    v = TIMM_VIT
    d, m, p = v["dim"], v["mlp"], v["patch"]
    shapes = {"patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,), "cls_token": (1, 1, d),
              "reg_token": (1, v["reg"], d), "pos_embed": (1, v["grid"] ** 2, d), "norm.weight": (d,),
              "norm.bias": (d,)}
    for i in range(v["depth"]):
        shapes.update({f"blocks.{i}.{k}": s for k, s in (
            ("norm1.weight", (d,)), ("norm1.bias", (d,)), ("norm2.weight", (d,)), ("norm2.bias", (d,)),
            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)), ("attn.proj.weight", (d, d)),
            ("attn.proj.bias", (d,)), ("mlp.fc1.weight", (m, d)), ("mlp.fc1.bias", (m,)),
            ("mlp.fc2.weight", (d, m)), ("mlp.fc2.bias", (d,)), ("ls1.gamma", (d,)), ("ls2.gamma", (d,)))})
    gen = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(s, generator=gen) * (0.02 if len(s) > 1 else 0.1) for k, s in shapes.items()}
    for k in sd:
        if k.endswith(("norm1.weight", "norm2.weight")) or k == "norm.weight":
            sd[k] += 1.0
        elif k.endswith("gamma"):
            sd[k] = sd[k].abs() * 1e-3
    torch.save(sd, path)
    return {k: t.numpy() for k, t in sd.items()}


def write_megapose_tree(root: str, seed: int) -> str:
    """A ``MegaPose-Training-Data`` tree of ``MEGAPOSE_KEYS`` images (``.rgb.jpg`` by cv2, 16-bit depth by the port's
    PNG writer, the card having no imageio): each its object's box at a depth with 5 mm of noise and a random pose,
    the visible mask json, the gt, camera and valid-instance jsons, and each object's reference list. Returns the
    tree's root."""
    import cv2

    from unopose_tpu_torch.data.png import write_png
    from unopose_tpu_torch.data.preprocess import binary_mask_to_rle
    from unopose_tpu_torch.ops.rotation import random_rotation_np

    rng = np.random.default_rng(seed)
    data = os.path.join(root, "MegaPose-Training-Data")
    gso = os.path.join(data, "MegaPose-GSO", "train_pbr_web")
    shard = os.path.join(gso, "000000")
    os.makedirs(shard)
    keys = [f"000000_{i:06d}" for i in range(MEGAPOSE_KEYS)]
    objects = list(MEGAPOSE_OBJECTS)
    refs = {str(o): [] for o in objects}
    for i, key in enumerate(keys):
        obj = objects[i % len(objects)]
        (r0, r1), (c0, c1), z = MEGAPOSE_OBJECTS[obj]
        head = os.path.join(shard, key)
        depth = np.zeros((480, 640), np.uint16)
        depth[r0:r1, c0:c1] = z + rng.integers(-5, 6, (r1 - r0, c1 - c0))
        mask = np.zeros((480, 640), bool)
        mask[r0:r1, c0:c1] = True
        write_png(head + ".depth.png", depth)
        if not cv2.imwrite(head + ".rgb.jpg", rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)):
            raise OSError(f"cv2 could not write {head}.rgb.jpg")
        R = random_rotation_np(rng)
        with open(head + ".gt.json", "w") as f:
            json.dump([dict(obj_id=obj, cam_R_m2c=R.reshape(-1).tolist(), cam_t_m2c=[0.0, 0.0, float(z)])], f)
        with open(head + ".camera.json", "w") as f:
            json.dump(dict(cam_K=EVAL_K.reshape(-1).tolist(), depth_scale=1.0), f)
        with open(head + ".mask_visib.json", "w") as f:
            json.dump({"0": binary_mask_to_rle(mask)}, f)
        refs[str(obj)].append([0, key, 0])
    for name, d in (("MegaPose-GSO/train_pbr_web/key_to_shard.json", {k: 0 for k in keys}),
                    ("megapose_gso_fixed_obj_id_to_visib0_8_scene_im_inst_ids.json", refs),
                    ("megapose_gso_fixed_valid_inst_ids.json", {f"000000/{k}": [0] for k in keys})):
        with open(os.path.join(data, name), "w") as f:
            json.dump(d, f)
    return data


def tensors_equal(a, b) -> bool:
    """Two nested states (dicts, lists, tensors, numbers) bitwise equal, tensors compared on the CPU."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tensors_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


def launcher_figures(stats: dict, batch: int) -> dict:
    """A launcher run's figures from ``train_loop``'s stats: the steady ms an iteration (median of all but the
    first, each ending in the logged step's sync), samples/s, the reader's median wait an iteration, the steady
    ms an iteration less its wait, the checkpoints' save seconds and the restore's."""
    steady = 1e3 * float(np.median(stats["step_s"][1:] if len(stats["step_s"]) > 1 else stats["step_s"]))
    less_wait = [x - w for x, w in zip(stats["step_s"], stats["wait_s"])]
    return dict(iterations=len(stats["step_s"]), step_ms=[1e3 * x for x in stats["step_s"]], steady_ms=steady,
                samples_per_s=batch * 1e3 / steady, wait_ms=1e3 * float(np.median(stats["wait_s"])),
                steady_less_wait_ms=1e3 * float(np.median(less_wait[1:] if len(less_wait) > 1 else less_wait)),
                save_s=stats["save_s"], restore_s=stats["restore_s"])


def csv_poses(path: str) -> tuple:
    """(keys, R (n, 3, 3), t (n, 3) in meters, score (n,)) of a BOP19 CSV, float64 tensors."""
    import torch

    rows = [line.split(",") for line in open(path).read().splitlines() if line]
    if not rows or any(len(r) != 7 for r in rows):
        raise AssertionError(f"{path}: {len(rows)} rows, or rows without 7 columns")
    R = torch.tensor(np.stack([np.array(r[4].split(), np.float64).reshape(3, 3) for r in rows]))
    t = torch.tensor(np.stack([np.array(r[5].split(), np.float64) for r in rows])) / 1000.0
    return [tuple(r[:3]) for r in rows], R, t, torch.tensor([float(r[3]) for r in rows], dtype=torch.float64)


def run_train_launcher(log, dev, seed: int) -> dict:
    """Phase 6, the train entry point: ``main_unopose.main`` trains ``configs.main_config()`` at full width (224 px,
    2048 / 5000 points, matchers float32 and backbone bf16, the launcher's default dtypes) on the card at
    ``misc.train_batch_size`` ``LAUNCHER_BATCH``, the ViT grafted from ``write_fake_timm``'s checkpoint. In order:
    ``--synthetic-data`` for ``LAUNCHER_STEPS`` iterations, logged each, a checkpoint every 2 (2 kept) and an
    evaluation every 2 on ``write_bop_tree``'s tree; the same call with ``max_iter`` ``LAUNCHER_RESUME_STEPS``,
    which must resume at ``LAUNCHER_STEPS``; ``LAUNCHER_READER_STEPS`` iterations of the MegaPose reader
    (``write_megapose_tree``) through ``train_loader`` with 8 workers; ``--eval-only misc.load_from=<out>/ckpt``.
    Gates: every ViT tensor after training is its mapped source (``pos_embed`` ``interpolate_pos_embed_np``'s 16 x
    16), so the graft took and the frozen ViT did not move; ``metrics.json`` has ``LAUNCHER_STEPS`` lines, all finite
    with ``grad_norm`` > 0; ``ckpt/`` holds 2 and 4, then 4 and 6; both periodic CSVs have one row per detection
    and valid poses; the resumed state (parameters, buffers, Adam state, count) is bitwise what step 4 saved; the
    reader's iterations are finite; the eval-only poses are the ``_iter0000006`` CSV's within ``EVAL_CACHE_TOL``;
    the path's launches. Then one step at ``configs.GLOBAL_BATCH``: its peak memory, or the out-of-memory error,
    logged as a finding."""
    import gc
    import tempfile

    import torch

    from unopose_tpu_torch import main_unopose
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.utils.checkpoint import (
        VIT_PREFIX, Checkpointer, convert_timm_vit_to_flax, interpolate_pos_embed_np)
    from unopose_tpu_torch.utils.convert import flax_to_torch

    with tempfile.TemporaryDirectory(prefix="unopose_train_") as tmp:
        det_path, dets, _ = write_bop_tree(os.path.join(tmp, "bop"), seed)
        vit_ckpt = os.path.join(tmp, "vit.pth")
        sd = write_fake_timm(vit_ckpt, seed)
        out = os.path.join(tmp, "out")
        base = ["--device", str(dev), "misc.exp_name='smoke'", f"misc.train_batch_size={LAUNCHER_BATCH}",
                f"model.feature_extraction.vit_ckpt={vit_ckpt!r}", f"dataloader.test.data_dir={tmp + '/bop'!r}",
                f"dataloader.test.detection_path={det_path!r}", "train.log_period=1", "train.checkpointer.period=2",
                "train.checkpointer.max_to_keep=2", "train.eval_period=2"]
        runs = {}

        def launch(name, argv):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            r = main_unopose.main(argv)
            torch.cuda.synchronize()
            runs[name] = dict(wall_s=time.perf_counter() - t0, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            if "trainer" in r:
                runs[name].update(launcher_figures(r["stats"], LAUNCHER_BATCH))
            log(f"train_launcher {name}: {json.dumps(runs[name])}")
            return r

        reset_launch_counts()
        r = launch("synthetic", ["--synthetic-data"] + base + [f"misc.output_dir={out!r}",
                                                                f"train.max_iter={LAUNCHER_STEPS}"])
        model = r["trainer"].model
        pe = interpolate_pos_embed_np(sd["pos_embed"], model.encoder.rgb_net.vit.grid)
        mapped = flax_to_torch({"params": convert_timm_vit_to_flax({**sd, "pos_embed": pe}, depth=TIMM_VIT["depth"])})
        state = model.state_dict()
        vit_keys = {k for k in state if k.startswith(VIT_PREFIX)}
        grafted = vit_keys == {VIT_PREFIX + k for k in mapped} and all(
            torch.equal(state[VIT_PREFIX + k].cpu(), v) for k, v in mapped.items())
        pe_ok = np.array_equal(state[VIT_PREFIX + "pos_embed"].cpu().numpy(), pe)
        lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json")).read().splitlines()]
        finite = all(np.isfinite(v) for x in lines for v in x.values()) and all(x["grad_norm"] > 0 for x in lines)
        steps = Checkpointer(os.path.join(out, "ckpt")).steps()
        log(f"train_launcher: {len(vit_keys)} ViT tensors, each its mapped timm source after {LAUNCHER_STEPS} "
            f"iterations {grafted}, pos_embed the 37 -> 16 resample {pe_ok}; metrics.json {len(lines)} lines, finite "
            f"with grad norm > 0 {finite} (losses {[round(x['loss'], 4) for x in lines]}); ckpt/ steps {steps}")
        if not (grafted and pe_ok) or len(lines) != LAUNCHER_STEPS or not finite or steps != [2, 4]:
            raise AssertionError("train_launcher: the graft, the frozen ViT, metrics.json or the checkpoints")
        for step in (2, 4):
            keys, R, t, score = csv_poses(os.path.join(out, f"result_smoke_iter{step:07d}_ycbv-test.csv"))
            orth, det, ok = pose_check(R, t, score)
            if len(keys) != len(dets) or not ok or orth > 1e-3 or det > 1e-3:
                raise AssertionError(f"train_launcher: the iteration-{step} evaluation's CSV ({len(keys)} rows)")
        del model, r, state

        saved = Checkpointer(os.path.join(out, "ckpt")).load(LAUNCHER_STEPS)
        restore, checked = Checkpointer.restore, []

        def restore_and_check(self, trainer, step=None):
            out_ = restore(self, trainer, step)
            checked.append((step, tensors_equal(dict(model=trainer.model.state_dict(),
                                                     optimizer=trainer.optimizer.state_dict(),
                                                     iteration=trainer.iteration), saved)))
            return out_

        Checkpointer.restore = restore_and_check
        try:
            r = launch("resume", ["--synthetic-data"] + base + [f"misc.output_dir={out!r}",
                                                                 f"train.max_iter={LAUNCHER_RESUME_STEPS}"])
        finally:
            Checkpointer.restore = restore
        lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json")).read().splitlines()]
        steps = Checkpointer(os.path.join(out, "ckpt")).steps()
        log(f"train_launcher resume: restored {checked} (step, state bitwise the saved one), started at "
            f"{r['stats']['start_iter']}, logged {[x['iteration'] for x in lines[LAUNCHER_STEPS:]]}, ckpt/ steps "
            f"{steps}")
        if checked != [(LAUNCHER_STEPS, True)] or r["stats"]["start_iter"] != LAUNCHER_STEPS or steps != [
                LAUNCHER_STEPS, LAUNCHER_RESUME_STEPS] or [x["iteration"] for x in lines] != list(
                range(LAUNCHER_RESUME_STEPS)):
            raise AssertionError("train_launcher: the resume")
        del r, saved

        data_dir = write_megapose_tree(os.path.join(tmp, "megapose"), seed)
        r = launch("reader", base + [f"misc.output_dir={tmp + '/out_reader'!r}",
                                     f"dataloader.train.data_dir={data_dir!r}",
                                     f"train.max_iter={LAUNCHER_READER_STEPS}", "train.eval_period=0",
                                     "dataloader.train.num_workers=8"])
        lines = [json.loads(x) for x in open(os.path.join(tmp, "out_reader", "metrics.json")).read().splitlines()]
        if len(lines) != LAUNCHER_READER_STEPS or not all(np.isfinite(v) for x in lines for v in x.values()):
            raise AssertionError(f"train_launcher: the reader run's metrics {lines}")
        del r

        r = launch("eval_only", ["--eval-only"] + base + [f"misc.output_dir={tmp + '/out_eval'!r}",
                                                           f"misc.load_from={out + '/ckpt'!r}"])
        keys, R, t, score = csv_poses(r["csv"])
        keys6, R6, t6, score6 = csv_poses(
            os.path.join(out, f"result_smoke_iter{LAUNCHER_RESUME_STEPS:07d}_ycbv-test.csv"))
        d = dict(rot=float((torch.linalg.matrix_norm(R - R6) / np.sqrt(2.0)).max()), t=float((t - t6).abs().max()),
                 score=float((score - score6).abs().max()))
        log(f"train_launcher eval_only from ckpt/{LAUNCHER_RESUME_STEPS}: poses against the iteration-"
            f"{LAUNCHER_RESUME_STEPS} evaluation's {d} (gates {EVAL_CACHE_TOL}), rows in the same order "
            f"{keys == keys6}")
        if keys != keys6 or any(d[k] > v for k, v in EVAL_CACHE_TOL.items()):
            raise AssertionError(f"train_launcher: --eval-only from the checkpoint differs: {d}")
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        check_launches("train_launcher", launches)
        log(f"train_launcher: launches {launches}")
        del r
    gc.collect()  # the launcher's models, before the largest step of the script
    torch.cuda.empty_cache()
    runs["global_batch"] = global_batch_step(log, dev, seed)
    return dict(launches=launches, runs=runs)


def global_batch_step(log, dev, seed: int) -> dict:
    """One training step of ``main_config()`` (the launcher's dtypes) at the JAX launcher's global batch,
    ``configs.GLOBAL_BATCH``, on the one card: its ms and peak memory, or the out-of-memory error, as a finding."""
    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.engine.train import Trainer
    from unopose_tpu_torch.models import UNOPose

    cfg = configs.main_config()
    B = configs.GLOBAL_BATCH
    torch.manual_seed(seed)
    model = UNOPose.from_config(cfg.model, torch.float32, torch.bfloat16).to(dev)
    trainer = Trainer(model, cfg)
    tr = cfg.dataloader.train
    batch = {k: torch.from_numpy(v).to(dev) for k, v in configs.synthetic_train_inputs(
        np.random.default_rng(seed), B, img=tr.img_size, npts=tr.n_sample_observed_point,
        ntem=tr.n_sample_template_point).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        metrics = trainer.step(batch, generator=torch.Generator(device=dev).manual_seed(seed))
        loss = float(metrics["loss"])
        r = dict(batch=B, fits=True, ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    except torch.cuda.OutOfMemoryError as e:
        r = dict(batch=B, fits=False, error=str(e).splitlines()[0],
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"train_launcher: one step at the global batch {B} on one card (first step, warm-up included): {json.dumps(r)}")
    del model, trainer, batch
    torch.cuda.empty_cache()
    return r


# the ddp path: main_unopose's train branch on DDP_RANKS ranks at main_config()'s full width, LAUNCHER_BATCH a rank
# (the published per-rank batch), DDP_STEPS synthetic iterations with a checkpoint at the last, the ViT grafted from
# write_fake_timm's file; against one process on the same global batch, whose own spread under a one-ulp nudge of
# its input clouds (up, and down) sets the gates of the losses, parameters and running statistics (DDP_GATE times it,
# the losses plus DDP_LOSS_RTOL of their value); the first step's averaged gradients, each tensor within DDP_GRAD_RTOL
# of its largest |gradient| (plus DDP_GRAD_FLOOR of the largest over all tensors), and DDP_CONTROLS, each a fault of
# the data-parallel path in the ranks' processes alone, which must fail that gate; then --eval-only from the checkpoint on DDP_RANKS ranks over write_bop_tree's tree, each rank's shard against one
# process's run_inference of that shard at the same draws; and one NCCL rank at world size 1 for DDP_STEPS iterations
DDP_RANKS, DDP_STEPS, DDP_GATE, DDP_LOSS_RTOL = 2, 3, 3.0, 1e-5
# The parameters after DDP_STEPS warm-up steps (learning rates near 1e-7) cannot show a wrong gradient, and a one-ulp
# nudge of the clouds moves the first step's gradients by about their own size (it flips the pipeline's discrete
# selections), so that gate is set apart: the ranks differ from one process by rounding, which their other batch
# size's products amplify through those selections, the faults by the tensor's own size or more (the controls:
# gamma and beta gradients from the reduced sums, R times theirs; K13 and K14 centering over one rank's count)
DDP_GRAD_RTOL, DDP_GRAD_FLOOR = 0.25, 1e-6
DDP_CONTROLS = ("reduced_dgamma", "local_count")
DDP_TIMEOUT = 420  # seconds for the ranks of one launch
DDP_CONFIG = "unopose_tpu_torch.configs:main_config"


def check_split_passes(log, dev, seed: int) -> dict:
    """The ddp path's K11 entry points on the card at one rank's shapes (B 8, P 2048, S 256): the block pass and
    the finish from its sums, at one rank's count, fill the statistics buffer bitwise as the one-call entry point
    does (so world size 1, which keeps the one-call point, and a reduction of one rank's sums agree); K13 and K14
    with the spare row's 1/n at one rank's count bitwise as with 0 (the local count), and at twice the count equal
    to the plain passes given the same row within the phase-3 gate (1e-2 of each tensor's max). Returns the split
    K11's ms (block passes and finishes of the three depths, no reduction) beside the one-call passes'."""
    import torch

    from unopose_tpu_torch.configs import pe_train_chans, pe_train_weights
    from unopose_tpu_torch.ops import pe_train as pt

    rng = np.random.default_rng(seed + 7)
    Bt, P, S = LAUNCHER_BATCH, 2048, 256
    n = Bt * P * S
    Ws, gammas, betas = pe_train_weights(dev, seed)
    chans = pe_train_chans(rng, dev, Bt, P, S)
    bn, gb = pt.stats_buffer(gammas, betas, dev)
    split = bn.clone()
    for depth in (1, 2, 3):
        pt.stats_cuda(chans, Ws, gb, bn, depth, 1e-5)
        pt.stats_finish_cuda(pt.stats_partial_cuda(chans, Ws, split, depth), gb, split, depth, n, 1e-5)
    stats_equal = bool(torch.equal(bn, split))
    pooled, cnt = pt.fwd_cuda(chans, Ws, bn)
    dpool = torch.from_numpy(rng.standard_normal((Bt, P, 128)).astype(np.float32)).to(dev)
    for layer in (3, 2, 1):
        pt.bwd_sums_cuda(chans, Ws, bn, pooled, cnt, dpool, layer)
    dw = pt.bwd_dw_cuda(chans, Ws, bn, pooled, cnt, dpool)
    local = bn.clone()
    local[0, pt.INV_N, 0] = 1.0 / n
    again, local_sums = bn.clone(), local.clone()
    pt.bwd_sums_cuda(chans, Ws, again, pooled, cnt, dpool, 2)
    pt.bwd_sums_cuda(chans, Ws, local_sums, pooled, cnt, dpool, 2)
    row_local = bool(torch.equal(again[1, pt.SG:pt.SGZ + 1], local_sums[1, pt.SG:pt.SGZ + 1])) and all(
        torch.equal(a, b) for a, b in zip(dw, pt.bwd_dw_cuda(chans, Ws, local, pooled, cnt, dpool)))
    doubled = bn.clone()
    doubled[0, pt.INV_N, 0] = 1.0 / (2 * n)
    # each side fed its own forward's max and tie count (the backward finds its max slots by an exact compare)
    plain_dw = pt.bwd_dw_plain(chans, Ws, doubled, *pt.fwd_plain(chans, Ws, bn), dpool)
    k_dw = pt.bwd_dw_cuda(chans, Ws, doubled, pooled, cnt, dpool)
    doubled_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(k_dw, plain_dw))
    moved = any(not torch.equal(a, b) for a, b in zip(k_dw, dw))

    def split_stats():
        for depth in (1, 2, 3):
            pt.stats_finish_cuda(pt.stats_partial_cuda(chans, Ws, split, depth), gb, split, depth, n, 1e-5)

    def fused_stats():
        for depth in (1, 2, 3):
            pt.stats_cuda(chans, Ws, gb, bn, depth, 1e-5)

    ms = dict(stats_split=cuda_ms(split_stats), stats_one_call=cuda_ms(fused_stats))
    log(f"ddp: K11 split (block pass, finish from its sums) bitwise the one-call entry point {stats_equal}; K13 and "
        f"K14 with the spare row at one rank's 1/n bitwise as with 0 {row_local}; at twice the count K14 moved "
        f"{moved}, against the plain passes {doubled_err:.2e} (gate 1e-2); ms of the three depths, split against one "
        f"call: {json.dumps(ms)}")
    if not (stats_equal and row_local and moved) or doubled_err > 1e-2:
        raise AssertionError("ddp: K11's split entry points or the spare row's count")
    return ms


@contextlib.contextmanager
def first_step_grads(into: dict):
    """Within it, ``Trainer.step`` puts into ``into`` (where empty) the trainable parameters' gradients after its
    step, averaged over the ranks, on the host."""
    from unopose_tpu_torch.engine.train import Trainer

    plain = Trainer.step

    def step(self, *args, **kwargs):
        metrics = plain(self, *args, **kwargs)
        if not into:  # the next step zeroes them
            into.update({name: p.grad.detach().cpu().clone() for name, p in self.params})
        return metrics

    Trainer.step = step
    try:
        yield into
    finally:
        Trainer.step = plain


def install_control(name: str) -> None:
    """One of ``DDP_CONTROLS``, a deliberate fault of the data-parallel train PE, patched into this process (a
    rank's own): ``reduced_dgamma`` returns the gamma and beta gradients from the sums reduced across the ranks
    (R times a rank's, before the gradient average); ``local_count`` clears the forward's 1/n of the global count,
    so that K13 and K14 centre over this rank's B P S."""
    from unopose_tpu_torch.ops import pe_train as pt

    if name == "reduced_dgamma":
        backward = pt.train_backward

        def faulty_backward(chans, Ws, bn, pooled, cnt, dpool):
            dws, _, _ = backward(chans, Ws, bn, pooled, cnt, dpool)
            return (dws, tuple(bn[l, pt.SGZ, :pt.DIMS[l + 1]].clone() for l in range(3)),
                    tuple(bn[l, pt.SG, :pt.DIMS[l + 1]].clone() for l in range(3)))

        pt.train_backward = faulty_backward
    elif name == "local_count":
        forward = pt.train_forward

        def faulty_forward(*args, **kwargs):
            pooled, cnt, bn = forward(*args, **kwargs)
            bn[0, pt.INV_N, 0] = 0.0
            return pooled, cnt, bn

        pt.train_forward = faulty_forward
    else:
        raise ValueError(f"no control {name!r}")


def ddp_rank(index: int, ranks: int, port: int, backend: str, device: str, argv: list, out: str,
             control: str = "") -> None:
    """One rank of the ddp path, in a process of its own (start method spawn): under ``nccl``, torchrun's
    environment, from which ``main`` starts the group on card ``index``; under ``gloo``, a group this function
    starts over ``tcp://localhost:port`` with every rank on ``device`` (card 0), which ``main`` uses as it is;
    ``control``, where given, patched in first (``install_control``). The launch counts and the collectives are
    zeroed just before ``main_unopose.main(argv)`` and read just after; they, the loop's stats, the first step's
    gradients and the model's state (training) or the CSV (evaluation) go to ``out.rank<index>``."""
    import torch

    sys.path.insert(0, ROOT)
    from unopose_tpu_torch import main_unopose
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.parallel import mesh

    if backend == "gloo":
        if device.startswith("cuda"):
            torch.cuda.set_device(device)
        torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=index,
                                             world_size=ranks)
    else:
        os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(ranks), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        device = "cuda"
    try:
        if control:
            install_control(control)
        grads: dict = {}
        reset_launch_counts()
        mesh.REDUCTIONS.clear()
        with first_step_grads(grads):
            r = main_unopose.main(["--device", device] + argv)
        on_card = device.startswith("cuda")
        if on_card:
            torch.cuda.synchronize()
        result = dict(launches=dict(LAUNCHES), reductions=dict(mesh.REDUCTIONS),
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0)
        if "trainer" in r:
            result.update(stats=r["stats"], trainable=[name for name, _ in r["trainer"].params], grads=grads,
                          state={k: v.detach().cpu() for k, v in r["trainer"].model.state_dict().items()})
        else:
            result.update(csv=r["csv"], rows=r["rows"])
        torch.save(result, f"{out}.rank{index}")
    finally:
        if backend == "gloo":
            torch.distributed.destroy_process_group()


def launch_ranks(ranks: int, backend: str, device: str, argv: list, out: str, control: str = "") -> list:
    """``ddp_rank`` in ``ranks`` spawned processes (``control`` patched into each); all must end within ``DDP_TIMEOUT`` seconds with exit code 0
    (a failure or the time limit ends them all). Returns each rank's results."""
    import torch
    import torch.multiprocessing as mp

    from unopose_tpu_torch.parallel import mesh

    ctx = mp.start_processes(ddp_rank, args=(ranks, mesh.free_port(), backend, device, argv, out, control),
                             nprocs=ranks, join=False, start_method="spawn")
    deadline = time.perf_counter() + DDP_TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.perf_counter() > deadline:
                raise AssertionError(f"ddp: {ranks} {backend} ranks still running after {DDP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(f"{out}.rank{r}", weights_only=False) for r in range(ranks)]


def ulp_nudged(direction: int):
    """``synthetic_train_iter`` with both clouds of every batch moved one float32 ulp (``direction`` +1 or -1)."""
    from unopose_tpu_torch.data import loader

    plain = loader.synthetic_train_iter

    def nudged(*args, **kwargs):
        for batch in plain(*args, **kwargs):
            yield {k: np.nextafter(v, np.float32(direction * np.inf)).astype(np.float32)
                   if k in ("pts", "tem1_pts") else v for k, v in batch.items()}

    return nudged


def ddp_reference(log, dev, argv: list, out: str, direction: int = 0) -> dict:
    """The one-process run of the ddp path's global batch on card 0 (``direction``: its clouds one ulp up or down):
    the logged losses, the first step's gradients, the trainable parameters and the fine PE's BatchNorm running
    statistics after it."""
    import torch

    from unopose_tpu_torch import main_unopose
    from unopose_tpu_torch.data import loader

    plain = loader.synthetic_train_iter
    if direction:
        loader.synthetic_train_iter = ulp_nudged(direction)
    grads: dict = {}
    try:
        with first_step_grads(grads):
            r = main_unopose.main(["--device", str(dev)] + argv + [f"misc.output_dir={out!r}"])
    finally:
        loader.synthetic_train_iter = plain
    torch.cuda.synchronize()
    state = {k: v.detach().cpu() for k, v in r["trainer"].model.state_dict().items()}
    trainable = [name for name, _ in r["trainer"].params]
    lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json")).read().splitlines()]
    del r
    torch.cuda.empty_cache()
    return ddp_summary(state, trainable, lines, grads)


def ddp_summary(state: dict, trainable: list, lines: list, grads: dict) -> dict:
    bn = [k for k in state if ".pe." in k and k.endswith((".mean", ".var"))]
    if len(bn) != 12:
        raise AssertionError(f"ddp: {len(bn)} running-statistics buffers of the fine PE (want 6 layers x 2)")
    if sorted(grads) != sorted(trainable):
        raise AssertionError(f"ddp: first-step gradients of {len(grads)} tensors, {len(trainable)} trainable")
    return dict(losses=[x["loss"] for x in lines], params={k: state[k] for k in trainable},
                stats={k: state[k] for k in bn}, grads=grads)


def ddp_gaps(a: dict, b: dict) -> dict:
    """The largest |a - b| of the losses (each step), the trainable parameters and the running statistics; of the
    first step's gradients, the largest over the tensors of |a - b| over the tensor's largest |b| (plus
    ``DDP_GRAD_FLOOR`` of the largest |b| over all tensors), and that tensor."""
    def gap(x, y):
        return max((x[k].double() - y[k].double()).abs().max().item() for k in x)

    floor = DDP_GRAD_FLOOR * max(g.abs().max().item() for g in b["grads"].values())
    rel = {k: (a["grads"][k].double() - g.double()).abs().max().item() / (g.abs().max().item() + floor)
           for k, g in b["grads"].items()}
    worst = max(rel, key=rel.get)
    return dict(losses=[abs(x - y) for x, y in zip(a["losses"], b["losses"])], params=gap(a["params"], b["params"]),
                stats=gap(a["stats"], b["stats"]), grads=rel[worst], grads_worst=worst)


def run_ddp(log, dev, seed: int, ranks: int = DDP_RANKS) -> dict:
    """Phase 6, the ddp path (see above ``DDP_RANKS``) on ``ranks`` ranks. With as many cards, NCCL ranks a card
    each (``main`` starts the group from torchrun's environment); with fewer, NCCL refuses two ranks on one card, so
    gloo ranks share card 0. Gates: the ranks' parameters and buffers bitwise equal to each other;
    against the one-process run of the global batch, each step's loss within ``DDP_GATE`` times its largest one-ulp
    spread plus ``DDP_LOSS_RTOL`` of its value, the trainable parameters and the running statistics each within
    ``DDP_GATE`` times theirs (largest |difference| over the tensors); the first step's averaged gradients, each
    tensor within ``DDP_GRAD_RTOL`` of its largest |gradient| (``ddp_gaps``); one ``ckpt/`` with the one step and
    one ``metrics.json``, a log a rank; K11 and K13 launched with their reductions on every rank (3 depths / layers
    x 2 scales x 2 clouds a step). Each of ``DDP_CONTROLS`` (one iteration on ``ranks`` ranks, that fault patched
    into them) must fail the gradients' gate; their launches are not counted. Then ``--eval-only`` from the checkpoint on ``ranks`` ranks: every detection of
    ``write_bop_tree``'s tree in the merged CSV once, valid poses, each shard's rows those of one process's
    ``run_inference`` of that shard (the checkpoint's weights, the same draws) within ``EVAL_CACHE_TOL``; then one
    NCCL rank at world size 1 for ``DDP_STEPS`` iterations. The launches of the ranks' runs are summed. (Each
    rank reads its shard with a reader of its own, whose point sampling starts from its seed at the shard's first
    image, as in the JAX package's processes: the merged CSV is not one process's CSV of every image.)"""
    import gc
    import tempfile

    import torch

    from unopose_tpu_torch import main_unopose
    from unopose_tpu_torch.data.dataset_test import BOPTestsetPoseFreeOneRef
    from unopose_tpu_torch.engine.inference import make_infer_fn, make_template_fn, run_inference
    from unopose_tpu_torch.models import UNOPose

    split_ms = check_split_passes(log, dev, seed)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= ranks else "gloo"
    log(f"ddp: {cards} card(s): {ranks} {backend} ranks" + ("" if backend == "nccl" else
        " sharing card 0 (NCCL refuses two ranks on one card; the ranks' collectives go through the host)"))
    with tempfile.TemporaryDirectory(prefix="unopose_ddp_") as tmp:
        det_path, dets, _ = write_bop_tree(os.path.join(tmp, "bop"), seed, max(EVAL_IMAGES, ranks))
        vit_ckpt = os.path.join(tmp, "vit.pth")
        write_fake_timm(vit_ckpt, seed)
        base = ["--config", DDP_CONFIG, "misc.exp_name='smoke'", f"model.feature_extraction.vit_ckpt={vit_ckpt!r}",
                f"dataloader.test.data_dir={tmp + '/bop'!r}", f"dataloader.test.detection_path={det_path!r}"]
        train = ["--synthetic-data"] + base + [f"misc.train_batch_size={ranks * LAUNCHER_BATCH}",
                                               f"train.max_iter={DDP_STEPS}", "train.log_period=1",
                                               f"train.checkpointer.period={DDP_STEPS}", "train.eval_period=0"]
        ref = ddp_reference(log, dev, train, os.path.join(tmp, "ref"))
        nudges = [ddp_reference(log, dev, train, os.path.join(tmp, f"ref{d}"), d) for d in (1, -1)]
        spreads = [ddp_gaps(n, ref) for n in nudges]
        spread = dict(losses=max(max(s["losses"]) for s in spreads), params=max(s["params"] for s in spreads),
                      stats=max(s["stats"] for s in spreads), grads=max(s["grads"] for s in spreads))
        gc.collect()
        torch.cuda.empty_cache()

        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        runs = launch_ranks(ranks, backend, str(dev), train + [f"misc.output_dir={out!r}"],
                             os.path.join(tmp, "train"))
        wall = time.perf_counter() - t0
        lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json")).read().splitlines()]
        got = ddp_summary(runs[0]["state"], runs[0]["trainable"], lines, runs[0]["grads"])
        gaps = ddp_gaps(got, ref)
        same = all(tensors_equal(runs[0]["state"][k], r["state"][k]) for r in runs[1:] for k in runs[0]["state"])
        loss_gates = [DDP_GATE * spread["losses"] + DDP_LOSS_RTOL * abs(x) for x in ref["losses"]]
        listing = sorted(os.listdir(out))
        steps = sorted(os.listdir(os.path.join(out, "ckpt")))
        per_run = 3 * 2 * 2 * DDP_STEPS
        reduced = [(r["reductions"].get("pe_train_stats", 0), r["reductions"].get("pe_train_bwd_sums", 0),
                    r["reductions"].get("gradients", 0)) for r in runs]
        figures = [launcher_figures(r["stats"], LAUNCHER_BATCH) for r in runs]
        log(f"ddp train: {ranks} {backend} ranks x B {LAUNCHER_BATCH}, {DDP_STEPS} iterations in {wall:.1f} s of "
            f"spawn and run; steady ms an iteration by rank {[round(f['steady_ms'], 3) for f in figures]} (step ms "
            f"{[[round(x, 3) for x in f['step_ms']] for f in figures]}; the synthetic feeder's median wait, every "
            f"rank drawing the global batch, {[round(f['wait_ms'], 3) for f in figures]}; steady less the wait "
            f"{[round(f['steady_less_wait_ms'], 3) for f in figures]}), peak GiB by rank "
            f"{[round(r['peak_gib'], 2) for r in runs]}; ranks' state bitwise equal {same}; against one process at "
            f"B {ranks * LAUNCHER_BATCH}: losses {ref['losses']} vs {got['losses']}, gaps {json.dumps(gaps)}, "
            f"one-ulp spread {json.dumps(spread)}, gates: losses {loss_gates}, params "
            f"{DDP_GATE * spread['params']:.3e}, running statistics {DDP_GATE * spread['stats']:.3e}, first-step "
            f"gradients {DDP_GRAD_RTOL} of each tensor's largest (not the spread); out/ {listing}, "
            f"ckpt/ {steps}; (K11, K13, gradient) reductions by rank {reduced}")
        if not same:
            raise AssertionError("ddp: the ranks' parameters or buffers differ")
        if len(got["losses"]) != DDP_STEPS or any(g > gate for g, gate in zip(gaps["losses"], loss_gates)) \
                or gaps["params"] > DDP_GATE * spread["params"] or gaps["stats"] > DDP_GATE * spread["stats"] \
                or gaps["grads"] > DDP_GRAD_RTOL:
            raise AssertionError(f"ddp: {ranks} ranks against one process past the gates: {gaps} vs {spread}")
        if steps != [str(DDP_STEPS)] or listing.count("metrics.json") != 1 or not {"log.txt", "log.rank1.txt"} <= set(
                listing) or any(name.startswith("metrics") and name != "metrics.json" for name in listing):
            raise AssertionError(f"ddp: out/ {listing}, ckpt/ {steps}")
        if any(r != (per_run, per_run, DDP_STEPS) for r in reduced) or any(
                r["launches"].get("pe_train_stats", 0) < per_run or r["launches"].get("pe_train_bwd_sums", 0)
                < per_run for r in runs):
            raise AssertionError(f"ddp: K11 / K13 not launched with their reductions on every rank: {reduced}")
        launches = {}
        for r in runs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        del runs, got

        controls = {}
        for name in DDP_CONTROLS:
            cout = os.path.join(tmp, f"control_{name}")
            faulty = launch_ranks(ranks, backend, str(dev), train + [f"misc.output_dir={cout!r}", "train.max_iter=1"],
                                  os.path.join(tmp, f"control_{name}"), control=name)[0]
            lines = [json.loads(x) for x in open(os.path.join(cout, "metrics.json")).read().splitlines()]
            c = ddp_gaps(ddp_summary(faulty["state"], faulty["trainable"], lines, faulty["grads"]), ref)
            controls[name] = dict(grads=c["grads"], grads_worst=c["grads_worst"], loss=c["losses"][0])
        log(f"ddp controls (one iteration, {ranks} {backend} ranks, each fault patched into the ranks): first-step "
            f"gradients' largest gap over each tensor's largest |gradient| {json.dumps(controls)}; gate "
            f"{DDP_GRAD_RTOL}, each must fail it (the honest ranks: {gaps['grads']:.3e}, {gaps['grads_worst']})")
        if any(c["grads"] <= DDP_GRAD_RTOL for c in controls.values()):
            raise AssertionError(f"ddp: a control passed the gradients' gate: {controls}")
        del ref, nudges, faulty

        ev = os.path.join(tmp, "eval")
        eval_argv = ["--eval-only"] + base + [f"misc.output_dir={ev!r}", f"misc.load_from={out + '/ckpt'!r}"]
        t0 = time.perf_counter()
        runs = launch_ranks(ranks, backend, str(dev), eval_argv, os.path.join(tmp, "eval"))
        eval_wall = time.perf_counter() - t0
        merged = runs[0]["csv"]
        keys, R, t, score = csv_poses(merged)
        orth, det, finite = pose_check(R, t, score)
        cfg = main_unopose.load_cfg(DDP_CONFIG).apply_overrides(eval_argv[3:])
        torch.manual_seed(0)
        model = UNOPose.from_config(cfg.model, main_unopose.DTYPES[cfg.train.matcher_dtype],
                                    main_unopose.DTYPES[cfg.train.backbone_dtype])
        main_unopose.restore_eval_variables(model, cfg)
        model = model.to(dev).eval()
        test = cfg.dataloader.test
        shards = []
        for r in range(ranks):
            # a reader of its own for each shard, as each rank has: its point sampling draws from a generator
            # seeded 0 that advances image by image
            dataset = BOPTestsetPoseFreeOneRef(test, eval_dataset_name=test.eval_dataset_name,
                                               detection_path=test.detection_path)
            path = os.path.join(tmp, f"shard{r}.csv")
            run_inference(make_infer_fn(model, dev), dataset, path, instance_batch_size=cfg.test.instance_batch_size,
                          template_fn=make_template_fn(model, dev), num_shards=ranks, shard_index=r)
            shards.append(path if r == 0 else f"{path}.rank{r}")
        want = [csv_poses(p) for p in shards]
        wkeys = [k for w in want for k in w[0]]
        wR, wt, wscore = (torch.cat([w[i] for w in want]) for i in (1, 2, 3))
        d = dict(rot=float((torch.linalg.matrix_norm(R - wR) / np.sqrt(2.0)).max()), t=float((t - wt).abs().max()),
                 score=float((score - wscore).abs().max()))
        log(f"ddp eval-only: {ranks} {backend} ranks in {eval_wall:.1f} s of spawn and run, merged CSV "
            f"{len(keys)} rows for {len(dets)} detections, shard rows {[r['rows'] for r in runs[1:]]} past rank 0; "
            f"|RR^T - I| {orth:.2e}, |det - 1| {det:.2e}, finite {finite}; against one process's shards {d} (gates "
            f"{EVAL_CACHE_TOL}), rows in the same order {keys == wkeys}")
        if len(keys) != len(dets) or keys != wkeys or not finite or orth > 1e-3 or det > 1e-3 or any(
                d[k] > v for k, v in EVAL_CACHE_TOL.items()):
            raise AssertionError(f"ddp: --eval-only on {ranks} ranks: {len(keys)} rows, {d}")
        for r in runs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        del model, runs

        one = launch_ranks(1, "nccl", str(dev), train + [f"misc.output_dir={tmp + '/one'!r}",
                                                          f"misc.train_batch_size={LAUNCHER_BATCH}"],
                           os.path.join(tmp, "one"))[0]
        one_fig = launcher_figures(one["stats"], LAUNCHER_BATCH)
        log(f"ddp one NCCL rank at world size 1, B {LAUNCHER_BATCH}: steady {one_fig['steady_ms']:.3f} ms an "
            f"iteration (step ms {[round(x, 3) for x in one_fig['step_ms']]}; the feeder's median wait, drawing "
            f"{LAUNCHER_BATCH}, {one_fig['wait_ms']:.3f}; steady less the wait {one_fig['steady_less_wait_ms']:.3f}), "
            f"collectives {one['reductions']}; {ranks} {backend} ranks at B {LAUNCHER_BATCH} each: "
            f"{[round(f['steady_ms'], 3) for f in figures]}, less the wait "
            f"{[round(f['steady_less_wait_ms'], 3) for f in figures]}")
        if one["reductions"]:
            raise AssertionError(f"ddp: world size 1 launched collectives {one['reductions']}")
        for k, v in one["launches"].items():
            launches[k] = launches.get(k, 0) + v
    check_launches("ddp", launches)
    log(f"ddp: launches {launches}")
    torch.cuda.empty_cache()
    return dict(launches=launches, split_ms=split_ms, gaps=gaps, spread=spread, controls=controls,
                steady_ms=[f["steady_ms"] for f in figures], wait_ms=[f["wait_ms"] for f in figures],
                steady_less_wait_ms=[f["steady_less_wait_ms"] for f in figures],
                one_rank_steady_ms=one_fig["steady_ms"], one_rank_wait_ms=one_fig["wait_ms"],
                one_rank_steady_less_wait_ms=one_fig["steady_less_wait_ms"], eval=d)


# the precision path: the production configs against the reference-faithful one on the same weights and scenes
PRECISION_CONFIGS = (("faithful", "faithful_config", "float32"),
                     ("production_bf16_geo", "production_bf16_geo_config", "bfloat16"),
                     ("production", "production_config", "bfloat16"))
# the JAX production gate's limits (tests/test_production_gate.py), applied to each group of its 4 pairs
PRECISION_LIMITS = dict(coarse_atten_rel=0.03, coarse_scores=0.05, fine_scores_median=0.05, fine_scores_p95=0.2,
                        pose_score=0.05)
PRECISION_GROUP = 4
PRECISION_TAPS = ("coarse_atten", "coarse_score", "fine_score", "pred_pose_score", "init_R", "pred_R")


def rotation_deltas_deg(Ra, Rb) -> np.ndarray:
    """Geodesic angles (degrees) between two batches of rotations (numpy)."""
    cos = (np.einsum("bij,bij->b", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64)) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def precision_deltas(ref: dict, got: dict) -> dict:
    """The JAX gate's deltas of ``got`` against ``ref`` (numpy taps of
    BATCH pairs), the worst over the groups of ``PRECISION_GROUP`` pairs, and
    each limit's verdict; plus the coarse and fine pose differences in
    degrees (ungated)."""
    d = {k: 0.0 for k in PRECISION_LIMITS}
    for g in range(0, len(ref["pred_pose_score"]), PRECISION_GROUP):
        sl = slice(g, g + PRECISION_GROUP)
        fa, pa = ref["coarse_atten"][sl], got["coarse_atten"][sl]
        dfs = np.abs(got["fine_score"][sl] - ref["fine_score"][sl])
        d["coarse_atten_rel"] = max(d["coarse_atten_rel"], float(np.abs(pa - fa).max() / (np.abs(fa).max() + 1e-9)))
        d["coarse_scores"] = max(d["coarse_scores"], float(np.abs(got["coarse_score"][sl] - ref["coarse_score"][sl]).max()))
        d["fine_scores_median"] = max(d["fine_scores_median"], float(np.median(dfs)))
        d["fine_scores_p95"] = max(d["fine_scores_p95"], float(np.percentile(dfs, 95)))
        d["pose_score"] = max(d["pose_score"], float(np.abs(got["pred_pose_score"][sl] - ref["pred_pose_score"][sl]).max()))
    coarse = rotation_deltas_deg(got["init_R"], ref["init_R"])
    fine = rotation_deltas_deg(got["pred_R"], ref["pred_R"])
    return dict(deltas=d, passed={k: d[k] < lim for k, lim in PRECISION_LIMITS.items()},
                coarse_rot_delta_deg=dict(median=float(np.median(coarse)), max=float(coarse.max())),
                fine_rot_delta_deg=dict(median=float(np.median(fine)), max=float(fine.max())))


def run_precision(log, dev, seed: int) -> dict:
    """Phase 6, the ``precision`` path: the faithful config (float32 model
    and backbone), production with the bf16 fused embedding and production
    (both bf16) at full width, one batch of ``BATCH`` pairs of
    ``tools/scenes.py:scene_batch`` scenes (224 px, 2048 query and 5000
    template points), every config on the same weights: a full-width fake
    reference checkpoint of the faithful model's seeded init, loaded through
    ``utils/ref_convert.py`` with ``parity_gather=True``; the same
    coarse-solver uniforms in every config. Each production config against
    faithful at the JAX gate's limits (``PRECISION_LIMITS``); every delta
    and the pose differences are logged. The launch counts are zeroed
    before the three configs and read after them."""
    import tempfile

    import torch

    from unopose_tpu_torch import configs
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.tools.fake_reference import write_fake_reference
    from unopose_tpu_torch.tools.scenes import scene_batch
    from unopose_tpu_torch.utils.ref_convert import load_reference_into

    def config(fn_name: str):
        cfg = getattr(configs, fn_name)()
        cfg.fine_point_matching.parity_gather = True
        return cfg

    rng = np.random.default_rng(seed + 19)
    inputs, R_gt, _ = scene_batch(rng, BATCH, img=configs.FULL_SIZES["img"], nq=configs.FULL_SIZES["npts"],
                                  nt=configs.FULL_SIZES["ntem"])
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    taps, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.pth")
        t0 = time.perf_counter()
        torch.manual_seed(seed)
        write_fake_reference(path, UNOPose.from_config(config("faithful_config")))
        log(f"precision: full-width fake reference checkpoint written in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(path) / 2**20:.0f} MiB)")
        models = {}
        for name, fn_name, dtype in PRECISION_CONFIGS:
            dt = getattr(torch, dtype)
            models[name] = load_reference_into(UNOPose.from_config(config(fn_name), dt, dt), path).to(dev).eval()
    uniforms = torch.rand((BATCH, 3 * models["faithful"].nproposal1), generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, model in models.items():
        t0 = time.perf_counter()
        out = model(inputs, uniforms=uniforms, return_intermediates=True)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        geo = out["geo"]
        kind = "int8 codes" if isinstance(geo, tuple) else str(geo.dtype)
        want = {"faithful": "torch.float32", "production_bf16_geo": "torch.bfloat16", "production": "int8 codes"}
        if kind != want[name]:
            raise AssertionError(f"precision {name}: geometric embedding {kind}, expected {want[name]}")
        taps[name] = {k: out[k].float().cpu().numpy() for k in PRECISION_TAPS}
        orth, det, finite = pose_check(out["pred_R"], out["pred_t"], out["pred_pose_score"])
        log(f"precision {name}: {times[name]:.1f} ms, embedding {kind}, PE branch {model.fine_matching.pe.last_branch}, "
            f"fused assignment {model.fused_assignment}, |RR^T - I| {orth:.2e}, finite {finite}")
        if not finite or orth > 1e-3 or det > 1e-3:
            raise AssertionError(f"precision {name}: poses are not finite orthonormal")
    launches = dict(LAUNCHES)
    check_launches("precision", launches)
    del models
    torch.cuda.empty_cache()
    gt = rotation_deltas_deg(taps["faithful"]["init_R"], R_gt)
    log(f"precision faithful: coarse pose against the scenes' ground truth, median {np.median(gt):.3f} deg, "
        f"max {gt.max():.3f} deg")
    result = dict(launches=launches, ms=times, configs={})
    failed = []
    for name, _, _ in PRECISION_CONFIGS[1:]:
        r = precision_deltas(taps["faithful"], taps[name])
        result["configs"][name] = r
        for k, v in r["deltas"].items():
            log(f"precision {name} vs faithful: {k} {v:.6g} (limit {PRECISION_LIMITS[k]})"
                f"{'' if r['passed'][k] else ' FAILED'}")
            if not r["passed"][k]:
                failed.append(f"{name} {k}")
        for k in ("coarse_rot_delta_deg", "fine_rot_delta_deg"):
            log(f"precision {name} vs faithful: {k} median {r[k]['median']:.4f}, max {r[k]['max']:.4f} (ungated)")
    if failed:
        raise AssertionError(f"precision gate failed: {failed}")
    return result


def run_pose_recovery(log, dev) -> dict:
    """Phase 6, the ``pose_recovery`` path: ``examples/
    pose_recovery_synthetic_torch.py:run`` on the card at B 4, N 2048: FPS
    196 (the fps kernel), the grouping, the coarse (6000 / 300) and fine
    solvers on the oracle attention within 1 degree and 0.02 for both
    stages, and a finite pose on the all-zero probe. Its launch counts are
    zeroed before and read after."""
    import importlib.util

    import torch

    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    spec = importlib.util.spec_from_file_location(
        "pose_recovery_synthetic_torch", os.path.join(ROOT, "examples", "pose_recovery_synthetic_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = example.run(str(dev), batch=4, npts=2048, npoint=196, n_proposal1=6000, n_proposal2=300,
                      log=lambda m: log(f"pose_recovery: {m}"))
    launches = dict(LAUNCHES)
    check_launches("pose_recovery", launches)
    return dict(launches=launches, **out)


def run_bench(log) -> dict:
    """Phase 6, the bench: ``unopose_tpu_torch.bench.run()`` as ``python -m unopose_tpu_torch.bench`` runs it
    (the production config, B 16, full depth), its JSON line logged, the last timed batch's poses gated."""
    from unopose_tpu_torch import bench
    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from unopose_tpu_torch.tools.profile_slice import PROFILES, env_switch

    with env_switch(PROFILES["production"][1]):
        reset_launch_counts()
        r = bench.run(batch=BATCH)
        launches = dict(LAUNCHES)
    orth, det, finite = pose_check(r["pred_R"], r["pred_t"], r["pred_pose_score"])
    prof = r["profiled"]
    log(f"bench: {json.dumps(r['line'])}; {r['ms_per_batch']:.3f} ms per {BATCH}-pair batch (best of "
        f"{bench.TRIALS} calls of {bench.ITERS}), init {r['init_s']:.1f} s, first run {r['first_s']:.1f} s; profiled "
        f"batch {prof['kernels']} kernels, {prof['kernel_ms']:.3f} ms of kernels, idle share "
        f"{100 * prof['idle_share']:.1f}%; |RR^T - I| {orth:.2e}, |det - 1| {det:.2e}, finite {finite}; "
        f"launches {launches}")
    if not finite or orth > 1e-3 or det > 1e-3 or tuple(r["pred_R"].shape) != (BATCH, 3, 3):
        raise AssertionError("bench: poses are not finite orthonormal (B, 3, 3) / (B, 3)")
    check_launches("bench", launches)
    return dict(launches=launches, line=r["line"], ms_per_batch=r["ms_per_batch"], profiled=prof)


def run_script(log, name: str) -> dict:
    """Phase 6, a profiling script of ``unopose_tpu_torch/benchmarks/``: its ``main()`` at ``SCRIPT_ITERS``
    chained calls a timing, its printed lines logged (its JSON of results last)."""
    import contextlib
    import importlib
    import io

    import torch

    from unopose_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    module = importlib.import_module(f"unopose_tpu_torch.benchmarks.{name}")
    out = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = module.main(["--iters", str(SCRIPT_ITERS)])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"{name}: {line}")
    log(f"{name}: launches {launches}")
    if rc != 0:
        raise AssertionError(f"{name}.main() returned {rc}")
    check_launches(name, launches)
    torch.cuda.empty_cache()
    return dict(launches=launches, results=json.loads(lines[-1]))


def variant_runs(log, dev, args) -> dict:
    """The train configurations past the six-channel float32 recipe
    (``TRAIN_VARIANTS``: the subset mode and ``train_full`` at
    ``--train-steps``, each PE variant for one step) and the production
    forward on each backbone of ``BACKBONES``."""
    runs = {name: run_train(log, dev, args.seed, args.train_steps if name in ("train_subset", "train_full") else 1,
                            name=name) for name in TRAIN_VARIANTS}
    runs.update({f"backbone_{v}": run_backbone(log, dev, args.seed, v) for v in BACKBONES})
    return runs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batches", type=int, default=3, help="full-width batches of the production path")
    parser.add_argument("--train-steps", type=int, default=3, help="full-width steps of the train path")
    parser.add_argument("--train-only", action="store_true", help="only the train and train_frozen paths")
    parser.add_argument("--eval-only", action="store_true",
                        help="only the eval path, timed over EVAL_MEASURED_RUNS runs of EVAL_MEASURED_IMAGES images")
    parser.add_argument("--launcher-only", action="store_true", help="only the train_launcher path")
    parser.add_argument("--ddp-only", action="store_true", help="only the ddp path")
    parser.add_argument("--ddp-ranks", type=int, default=DDP_RANKS, help="ranks of the ddp path")
    parser.add_argument("--precision-only", action="store_true", help="only the precision and pose_recovery paths")
    parser.add_argument("--variants-only", action="store_true",
                        help="only K7 and K8-K10's checks, the tiny subset train step and the train variant and "
                             "backbone paths")
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
    from unopose_tpu_torch.data import native

    t0 = time.perf_counter()
    lib = native.build()  # the host library of the eval path's reader and evaluator; a failed build raises
    if not native.have_native():
        raise AssertionError(f"host library {lib} built but does not load")
    log(f"host library built and loaded in {time.perf_counter() - t0:.1f} s ({lib})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    if args.train_only:
        runs = {"train": run_train(log, dev, args.seed, args.train_steps),
                "train_frozen": run_train(log, dev, args.seed, args.train_steps, frozen=True)}
        print(json.dumps({name: dict(steady_ms=r["steady_ms"], kernel_ms=r["profiled"]["kernel_ms"],
                                     pe_train_ms=r["pe_train_ms"]) for name, r in runs.items()}))
        return 0
    if args.launcher_only:
        r = run_train_launcher(log, dev, args.seed)
        print(json.dumps({"train_launcher": r["runs"]}))
        return 0
    if args.ddp_only:
        r = run_ddp(log, dev, args.seed, args.ddp_ranks)
        print(json.dumps({"ddp": {k: v for k, v in r.items() if k != "launches"}}))
        return 0
    if args.precision_only:
        r = run_precision(log, dev, args.seed)
        pose = run_pose_recovery(log, dev)
        print(json.dumps({"precision": {k: v for k, v in r.items() if k != "launches"},
                          "pose_recovery": {k: v for k, v in pose.items() if k != "launches"}}))
        return 0
    if args.variants_only:
        results = check_production_kernels(log, dev, args.seed)
        check_tiny_train(log, dev, args.seed, subset=True)
        runs = variant_runs(log, dev, args)
        print(json.dumps({"mha_fused": results["mha_fused"], **{name: {k: v for k, v in r.items() if k != "profiled"}
                                                                for name, r in runs.items()}}))
        return 0
    if args.eval_only:
        figures = []
        for k in range(EVAL_MEASURED_RUNS):
            figures.append(eval_steady(run_eval(log, dev, args.seed, EVAL_MEASURED_IMAGES)["stats"]))
            log(f"eval run {k + 1} of {EVAL_MEASURED_RUNS}: {json.dumps(figures[-1])}")
        print(json.dumps({"eval": figures}))
        return 0
    results = check_kernels(log, dev, args.seed)
    results.update(check_fused_kernels(log, dev, args.seed))
    results.update(check_production_kernels(log, dev, args.seed))
    results.update(check_train_kernels(log, dev, args.seed))
    results.update(check_subset_kernels(log, dev, args.seed))
    results["ball_group_subset"].update(check_subset_8192(log, dev, args.seed))
    results.update(check_hypsel_kernels(log, dev, args.seed))
    results.update(check_frozen_kernels(log, dev, args.seed))
    packed = check_packed_kernels(log, dev, args.seed)
    results["first_k_select"].update(packed.pop("first_k_select"))
    results.update(packed)
    results.update(check_profile_kernels(log, dev, args.seed))
    check_overflow(log, dev, args.seed)
    for name in INFER_PATHS:
        check_tiny(log, dev, args.seed, name)
    check_pe_routes(log, dev, args.seed)
    check_tiny_hypsel(log, dev, args.seed)
    check_train_grouping(log, dev, args.seed)
    check_tiny_train(log, dev, args.seed)
    check_tiny_train(log, dev, args.seed, frozen=True)
    check_tiny_train(log, dev, args.seed, subset=True)
    runs = {
        "slice": run_path(log, dev, args.seed, EARLY_BATCHES, "slice"),
        "fused_matchers": run_path(log, dev, args.seed, EARLY_BATCHES, "fused_matchers"),
        "production": run_path(log, dev, args.seed, args.batches, "production"),
        "production_hypsel": run_path(log, dev, args.seed, args.batches, "production_hypsel"),
        "subset": run_path(log, dev, args.seed, EARLY_BATCHES, "subset"),
        "firstk_unpacked": run_path(log, dev, args.seed, 1, "firstk_unpacked"),
        **{name: run_path(log, dev, args.seed, 1, name) for name in PE_PATHS},
        "production_s768": run_path(log, dev, args.seed, 1, "production_s768"),
        "precision": run_precision(log, dev, args.seed),
        "pose_recovery": run_pose_recovery(log, dev),
        "bench": run_bench(log),
        "eval": run_eval(log, dev, args.seed),
        **{name: run_script(log, name) for name in SCRIPTS},
        "train": run_train(log, dev, args.seed, args.train_steps),
        "train_frozen": run_train(log, dev, args.seed, args.train_steps, frozen=True),
        **variant_runs(log, dev, args),
        "train_launcher": run_train_launcher(log, dev, args.seed),
        "ddp": run_ddp(log, dev, args.seed, args.ddp_ranks),
    }
    split = runs["ddp"]["split_ms"]
    results["pe_train_stats"].update(ddp_split_ms=split["stats_split"], ddp_one_call_ms=split["stats_one_call"])

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
