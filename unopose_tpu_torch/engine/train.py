"""Training (counterpart of ``unopose_tpu/engine/train.py``:
``build_optimizer``, ``create_train_state``, ``make_train_step``,
``train_loop``).

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

``create_trainer`` grafts the pretrained ViT before freezing it;
``train_loop`` runs the iterations with resume, the metric writers, the
checkpoints and the periodic evaluation.

On several ranks (``parallel/mesh.py``; the JAX package's sharded step)
each rank steps on its rows of the global batch: the fine PE's BatchNorm
statistics span the global batch (``ops/pe_train.py``), the gradients are
averaged across the ranks before they are sanitised and their norm taken,
the pose noise is drawn for the global batch and each rank keeps its rows,
the logged metrics are the ranks' mean, rank 0 alone saves the
checkpoints (every rank restores them), and rank 0's state is broadcast
after the graft or the restore.

Not ported: training the ViT, gradient clipping (off in the
configuration) and the model EMA.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from unopose_tpu_torch.configs import Config
from unopose_tpu_torch.engine.schedule import build_schedule_from_cfg
from unopose_tpu_torch.losses import process_loss
from unopose_tpu_torch.models.unopose import UNOPose, compute_train_losses
from unopose_tpu_torch.ops.rotation import PoseNoiseDraws
from unopose_tpu_torch.parallel import mesh

FROZEN = "vit"  # the frozen backbone: every parameter path containing it
logger = logging.getLogger(__name__)


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
    training step on this rank's rows of the global batch and returns its
    metrics over those rows (0-d tensors, not synchronised). ``pose_noise``
    holds the global batch's draws (else they are drawn from ``generator``
    for the global batch); each rank takes its rows."""

    def __init__(self, model: UNOPose, cfg: Config):
        self.model, self.cfg = model, cfg
        self.params = trainable_parameters(model, cfg)
        self.optimizer, self.schedule = build_optimizer(cfg, [p for _, p in self.params])
        self.iteration = 0

    def step(self, batch: Dict[str, torch.Tensor], pose_noise: Optional[PoseNoiseDraws] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if not self.model.fine_only:  # fine_only starts from the identity pose: no noise
            B = batch["rotation_label"].shape[0] * mesh.world_size()
            if pose_noise is None:
                dev = generator.device if generator is not None else batch["rotation_label"].device
                pose_noise = PoseNoiseDraws.draw(B, generator, device=dev)
            rows = mesh.local_batch_slice(B)
            pose_noise = pose_noise._replace(angles=pose_noise.angles[rows], trans=pose_noise.trans[rows])
        outputs = self.model(batch, train=True, pose_noise=pose_noise, generator=generator)
        loss_dict = process_loss(compute_train_losses(outputs, batch, self.cfg.model))
        self.optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        for _, p in self.params:
            if p.grad is None:  # optax updates every trainable leaf, with a zero gradient if unused
                p.grad = torch.zeros_like(p)
        mesh.average_gradients(p for _, p in self.params)
        grads = []
        for _, p in self.params:  # JAX sanitises the global gradient
            torch.nan_to_num_(p.grad, nan=0.0, posinf=0.0, neginf=0.0)
            grads.append(p.grad)
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.iteration)
        self.optimizer.step()
        self.iteration += 1
        return metrics


def create_trainer(model: UNOPose, cfg: Config) -> Trainer:
    """The train state: the pretrained DINOv2 weights grafted into the ViT
    where the config asks for them (``utils/checkpoint.py:maybe_load_pretrained_vit``),
    then the ViT frozen and the optimizer built."""
    from unopose_tpu_torch.utils.checkpoint import maybe_load_pretrained_vit

    maybe_load_pretrained_vit(model, cfg.model.feature_extraction)
    return Trainer(model, cfg)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``. To the card each array goes
    through a fresh pinned copy and an asynchronous copy: the pinned block
    is not handed out again before the copy that reads it has ended."""
    if device.type != "cuda":
        return {k: torch.as_tensor(v) for k, v in batch.items()}
    return {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True) for k, v in batch.items()}


def train_loop(model: UNOPose, cfg: Config, data_iter: Iterator[Dict[str, np.ndarray]],
               trainer: Optional[Trainer] = None, start_iter: int = 0, max_iter: Optional[int] = None, writer=None,
               checkpointer=None, seed: int = 1, eval_fn: Optional[Callable] = None,
               stats: Optional[dict] = None) -> Trainer:
    """Iterations ``start_iter`` .. ``max_iter`` (``train.max_iter``) of
    ``trainer`` (``create_trainer(model, cfg)`` by default) on the host
    batches of ``data_iter``, moved to the model's device. Returns the trainer.

    - resume: where ``checkpointer.latest_step()`` is past ``start_iter``, that
      step is restored (on every rank) and the loop starts there; on several
      ranks rank 0's model state is then broadcast;
    - the pose noise is drawn from one generator seeded ``train.seed``
      (``seed`` without it); the stream starts again from the seed on resume,
      as the JAX package's key does;
    - at ``it % train.log_period == 0`` and at the last iteration, and only
      there, the metrics come back to the host (on several ranks, their mean
      over the ranks: every rank takes part, so every rank passes a writer or
      none): a non-finite loss raises ``FloatingPointError``; else
      ``writer.write(it, metrics)`` with
      ``iter_time``, the seconds an iteration since the last logged one, and
      with ``train.vis_img_tbx`` the first input crop as an image;
    - ``checkpointer.save(it + 1, trainer)`` at ``(it + 1) %
      train.checkpointer.period == 0`` and at the last iteration, on rank 0,
      then a barrier of the ranks;
    - ``eval_fn(trainer, it + 1)`` at ``(it + 1) % train.eval_period == 0``.

    ``stats`` (a dict), where given, gets each iteration's host seconds up to
    its checkpoint (``step_s``: the batch's wait and copy, the step's
    launches and, at logged iterations, its end on the device), the seconds
    waiting on ``data_iter`` (``wait_s``), the checkpoints' save seconds
    (``save_s``), the restore's (``restore_s``) and the first iteration
    (``start_iter``)."""
    device = next(model.parameters()).device
    max_iter = max_iter or cfg.train.max_iter
    if trainer is None:
        trainer = create_trainer(model, cfg)
    stats = {} if stats is None else stats
    stats.update(step_s=[], wait_s=[], save_s=[], restore_s=None)
    if checkpointer is not None:
        latest = checkpointer.latest_step()
        if latest is not None and latest > start_iter:
            t0 = time.perf_counter()
            checkpointer.restore(trainer, latest)
            stats["restore_s"] = time.perf_counter() - t0
            start_iter = latest
            logger.info("resumed from checkpoint step %d of %s", latest, checkpointer.directory)
    mesh.broadcast_state(model)
    stats["start_iter"] = start_iter
    train = cfg.train
    generator = torch.Generator(device=device).manual_seed(train.get("seed", seed))
    log_period = train.get("log_period", 50)
    ckpt_period = train.get("checkpointer", {}).get("period", 5000)
    eval_period = train.get("eval_period", 0)

    t_last = time.perf_counter()
    last_logged = start_iter - 1
    for it in range(start_iter, max_iter):
        t0 = time.perf_counter()
        host = next(data_iter)
        stats["wait_s"].append(time.perf_counter() - t0)
        batch = to_device(host, device)
        metrics = trainer.step(batch, generator=generator)
        if writer is not None and (it % log_period == 0 or it == max_iter - 1):
            m = {k: float(v) for k, v in mesh.mean_across_ranks(metrics).items()}
            # the gradients are sanitised every step, but a non-finite loss means the state is already broken
            if not math.isfinite(m.get("loss", 0.0)):
                raise FloatingPointError(f"non-finite loss at iteration {it}: {m}")
            m["iter_time"] = (time.perf_counter() - t_last) / (it - last_logged)
            writer.write(it, m)
            if train.get("vis_img_tbx", False) and hasattr(writer, "write_image"):
                from unopose_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD

                img = np.asarray(host["rgb"][0], np.float32)
                writer.write_image(it, "input_image",
                                   np.clip((img * IMAGENET_STD + IMAGENET_MEAN) * 255.0, 0, 255).astype(np.uint8))
            t_last = time.perf_counter()
            last_logged = it
        stats["step_s"].append(time.perf_counter() - t0)
        if checkpointer is not None and ((it + 1) % ckpt_period == 0 or it == max_iter - 1):
            t1 = time.perf_counter()
            if mesh.is_main_process():
                checkpointer.save(it + 1, trainer)
            mesh.sync_processes("checkpoint")
            stats["save_s"].append(time.perf_counter() - t1)
        if eval_fn is not None and eval_period and (it + 1) % eval_period == 0:
            eval_fn(trainer, it + 1)
    return trainer
