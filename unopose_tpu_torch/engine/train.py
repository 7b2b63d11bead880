"""The training step (counterpart of ``unopose_tpu/engine/train.py``:
``build_optimizer``, ``make_train_step``, ``train_loop``).

- Adam (betas 0.5 / 0.999, eps 1e-6 added after the square root and the
  bias correction, as optax's) on the flat-and-anneal schedule: the
  learning rate of update ``i`` is the schedule at count ``i``;
- ``freeze_vit`` (required): every parameter whose name contains "vit" is
  frozen (``requires_grad`` off, left out of the optimizer), and autograd
  stops at the ViT's output; ``output_upscaling`` trains;
- the step: the train forward with the initial-pose noise, the loss terms
  and ``process_loss``, backward, non-finite gradients zeroed, the global
  gradient norm of the trainable parameters, the update. The BatchNorm
  running statistics are updated inside the forward; under
  ``UNOPOSE_PE_TRAIN_FROZEN=1`` the fine PE normalises with them instead
  and leaves them unchanged (its gammas and betas still train).

Not ported: training the ViT, gradient clipping (off in the
configuration), the model EMA, the checkpointer, the metrics writer and the
data-parallel mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from unopose_tpu_torch.configs import Config
from unopose_tpu_torch.engine.schedule import build_schedule_from_cfg
from unopose_tpu_torch.losses import process_loss
from unopose_tpu_torch.models.unopose import UNOPose, compute_train_losses
from unopose_tpu_torch.ops.rotation import PoseNoiseDraws

FROZEN = "vit"  # the frozen backbone: every parameter path containing it


def trainable_parameters(model: torch.nn.Module, cfg: Config) -> List[Tuple[str, torch.nn.Parameter]]:
    """The parameters the optimizer updates; the frozen ones get
    ``requires_grad`` off. The model's train forward runs the ViT without
    autograd, so a config that trains it is refused."""
    if not cfg.model.feature_extraction.get("freeze_vit", False):
        raise NotImplementedError("not ported: training the ViT (feature_extraction.freeze_vit=False)")
    out = []
    for name, p in model.named_parameters():
        if FROZEN in name:
            p.requires_grad_(False)
        else:
            out.append((name, p))
    return out


def build_optimizer(cfg: Config, params) -> Tuple[torch.optim.Adam, Callable[[int], float]]:
    """(Adam over ``params``, the learning-rate schedule)."""
    if cfg.train.get("clip_grad", {}).get("enabled", False):
        raise NotImplementedError("not ported: gradient clipping (train.clip_grad.enabled)")
    if cfg.train.get("model_ema", {}).get("enabled", False):
        raise NotImplementedError("not ported: the model EMA (train.model_ema.enabled)")
    opt = cfg.optimizer
    sched = build_schedule_from_cfg(cfg.lr_multiplier, base_lr=opt.lr)
    adam = torch.optim.Adam(params, lr=sched(0), betas=tuple(opt.betas), eps=opt.eps,
                            weight_decay=opt.get("weight_decay", 0.0))
    return adam, sched


class Trainer:
    """A model, its optimizer and the step count: ``step(batch)`` runs one
    training step and returns its metrics (0-d tensors, not synchronised)."""

    def __init__(self, model: UNOPose, cfg: Config):
        self.model, self.cfg = model, cfg
        self.params = trainable_parameters(model, cfg)
        self.optimizer, self.schedule = build_optimizer(cfg, [p for _, p in self.params])
        self.iteration = 0

    def step(self, batch: Dict[str, torch.Tensor], pose_noise: Optional[PoseNoiseDraws] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        outputs = self.model(batch, train=True, pose_noise=pose_noise, generator=generator)
        loss_dict = process_loss(compute_train_losses(outputs, batch, self.cfg.model))
        self.optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        grads = []
        for _, p in self.params:
            if p.grad is None:  # optax updates every trainable leaf, with a zero gradient if unused
                p.grad = torch.zeros_like(p)
            torch.nan_to_num_(p.grad, nan=0.0, posinf=0.0, neginf=0.0)
            grads.append(p.grad)
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.iteration)
        self.optimizer.step()
        self.iteration += 1
        return metrics


def train_loop(trainer: Trainer, data_iter: Iterator[Dict[str, torch.Tensor]], steps: int,
               generator: Optional[torch.Generator] = None) -> List[Dict[str, float]]:
    """``steps`` steps; halts with ``FloatingPointError`` on a non-finite loss
    (the gradients are sanitised every step, but a non-finite loss means the
    model state is already broken). Returns each step's metrics as floats."""
    history = []
    for _ in range(steps):
        metrics = {k: float(v) for k, v in trainer.step(next(data_iter), generator=generator).items()}
        if not math.isfinite(metrics["loss"]):
            raise FloatingPointError(f"non-finite loss at iteration {trainer.iteration - 1}: {metrics}")
        history.append(metrics)
    return history
