"""The flat-and-anneal learning-rate schedule (counterpart of
``unopose_tpu/engine/schedule.py``): warmup (linear, pow, exp or constant),
a flat region, then an anneal (cosine, linear, poly, exp or step) to
``target_lr_factor``. ``schedule(i)`` is the learning rate of update ``i``
(0-based), as optax's ``scale_by_schedule`` reads it at count ``i``. The
arithmetic is float32, as the JAX package's.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Callable, Sequence

import numpy as np


def flat_and_anneal_schedule(
    total_iters: int,
    warmup_iters: int = 0,
    warmup_factor: float = 0.1,
    warmup_method: str = "linear",
    warmup_pow: float = 2.0,
    anneal_point: float = 0.72,
    anneal_method: str = "cosine",
    target_lr_factor: float = 0.0,
    poly_power: float = 1.0,
    step_gamma: float = 0.1,
    steps: Sequence[float] = (2.0 / 3.0, 8.0 / 9.0),
    base_lr: float = 1.0,
) -> Callable[[int], float]:
    if warmup_method not in ("constant", "linear", "pow", "exp"):
        raise ValueError(warmup_method)
    if anneal_method not in ("cosine", "linear", "poly", "exp", "step", "none"):
        raise ValueError(anneal_method)
    if anneal_method == "step":
        anneal_start = steps[0] * total_iters
    else:
        if not 0.0 <= anneal_point <= 1.0:
            raise ValueError(anneal_point)
        anneal_start = anneal_point * total_iters
    f32 = np.float32

    def schedule(count: int) -> float:
        x = f32(count)
        alpha = x / f32(max(warmup_iters, 1))
        if warmup_method == "linear":
            wf = f32(1 - warmup_factor) * alpha + f32(warmup_factor)
        elif warmup_method == "pow":
            wf = f32(1 - warmup_factor) * alpha ** f32(warmup_pow) + f32(warmup_factor)
        elif warmup_method == "exp":
            wf = f32(warmup_factor) ** (f32(1) - alpha)
        else:
            wf = f32(warmup_factor)
        frac = np.clip((x - f32(anneal_start)) / f32(max(total_iters - anneal_start, 1e-8)), f32(0), f32(1))
        if anneal_method == "cosine":
            af = f32(target_lr_factor) + f32(0.5 * (1 - target_lr_factor)) * (f32(1) + np.cos(f32(np.pi) * frac))
        elif anneal_method == "linear":
            af = f32(target_lr_factor) + f32(1 - target_lr_factor) * (f32(1) - frac)
        elif anneal_method == "poly":
            af = f32(target_lr_factor) + f32(1 - target_lr_factor) * (f32(1) - frac) ** f32(poly_power)
        elif anneal_method == "exp":
            af = f32(max(target_lr_factor, 5e-3)) ** frac
        elif anneal_method == "step":
            af = f32(step_gamma) ** f32(bisect_right([s * total_iters for s in steps], float(x)))
        else:
            af = f32(1)
        factor = wf if x < warmup_iters else (f32(1) if x < anneal_start else af)
        if x >= total_iters:
            factor = f32(target_lr_factor) if anneal_method != "step" else af
        return float(f32(base_lr) * f32(factor))

    return schedule


def build_schedule_from_cfg(cfg, base_lr: float) -> Callable[[int], float]:
    """cfg: the ``lr_multiplier`` section of ``configs.train_config()``."""
    return flat_and_anneal_schedule(
        total_iters=cfg.total_iters,
        warmup_iters=cfg.get("warmup_iters", 0),
        warmup_factor=cfg.get("warmup_factor", 0.1),
        warmup_method=cfg.get("warmup_method", "linear"),
        anneal_point=cfg.get("anneal_point", 0.72),
        anneal_method=cfg.get("anneal_method", "cosine"),
        target_lr_factor=cfg.get("target_lr_factor", 0.0),
        base_lr=base_lr,
    )
