"""The data-parallel layer (counterpart of ``unopose_tpu/parallel/mesh.py``).

The JAX package runs R devices as one program over a 1-D data mesh: the
parameters replicated, the batch sharded on axis 0, GSPMD inserting the
gradient all-reduce and reducing BatchNorm's batch statistics across the
devices. The port runs one process a rank (``torchrun``, or the launcher's
``--num-devices N``), each on its B / R rows of the global batch, and this
module makes the ranks compute what that one program computes:

- ``average_gradients``: one all-reduce of the flattened trainable
  gradients, divided by R (every rank holds B / R rows, so the mean of the
  ranks' local-mean losses is the global mean);
- ``all_reduce_sum``: the fine PE's BatchNorm sums, reduced inside
  ``ops/pe_train.py`` (K11's between its pass and its finish, K13's after
  its pass);
- ``broadcast_state``: rank 0's parameters and buffers, after the graft or
  the restore;
- ``mean_across_ranks``: the logged metrics as global means;
- ``local_batch_slice``, ``sync_processes`` and ``is_main_process`` with
  the JAX package's semantics.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo takes
those on CUDA tensors too. At world size 1 (no process group, or a group of
one) every function returns at once and launches no collective.
``REDUCTIONS`` counts the collectives by name.
"""

from __future__ import annotations

import logging
import os
import socket
from collections import Counter
from typing import Dict, Iterable

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

REDUCTIONS: Counter = Counter()
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")  # torchrun's


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main_process() -> bool:
    """Rank 0 (``comm.is_main_process`` of the reference)."""
    return rank() == 0


def local_batch_slice(global_batch_size: int) -> slice:
    """This rank's contiguous rows of a globally indexed batch: ``global //
    R`` rows from ``rank * (global // R)``."""
    per = global_batch_size // world_size()
    start = rank() * per
    return slice(start, start + per)


def init_distributed(device) -> torch.device:
    """Join this run's process group and return this rank's device.

    - A group already initialised is used as it is, on ``device``.
    - Under torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
      ``MASTER_ADDR``, ``MASTER_PORT``): a group over ``env://``, NCCL on card
      ``LOCAL_RANK`` for a CUDA ``device`` (any index it names is replaced),
      gloo for the CPU. One all-reduce follows, so that a group that does not
      come up raises here; so do fewer cards than ranks on this host. There
      is no fallback to gloo or to the CPU.
    - Otherwise: world size 1, no group, ``device``."""
    device = torch.device(device)
    if initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    r, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", r))
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(f"rank {r} of {world} takes card {local}, and this host has {cards}: fewer cards "
                               "than ranks")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend, init_method="env://", rank=r, world_size=world)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if probe.item() != world:
        raise RuntimeError(f"the {backend} group's first all-reduce gave {probe.item()}, not {world}")
    logger.info("rank %d of %d on %s (%s)", r, world, device, backend)
    return device


def free_port() -> int:
    """A free TCP port on this host, for a group's ``MASTER_PORT``."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sync_processes(name: str = "sync") -> None:
    """A barrier of every rank (``comm.synchronize`` of the reference); a
    no-op at world size 1. ``name`` says which one in the debug log."""
    if world_size() == 1:
        return
    logger.debug("barrier %s", name)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    REDUCTIONS["barrier"] += 1


def all_reduce_sum(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` summed over the ranks, in place; counted under ``name``."""
    dist.all_reduce(t)
    REDUCTIONS[name] += 1
    return t


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, list]:
    groups: Dict[torch.dtype, list] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Each parameter's ``.grad`` replaced by its mean over the ranks: one
    all-reduce of the flattened gradients (one a dtype), then a divide by R."""
    R = world_size()
    if R == 1:
        return
    for grads in _by_dtype(p.grad for p in params).values():
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), "gradients")
        flat.div_(R)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into every rank's ``module``: one
    broadcast a dtype."""
    if world_size() == 1:
        return
    for dtype, tensors in _by_dtype([*module.parameters(), *module.buffers()]).items():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        if dtype == torch.bool:  # gloo has no bool type
            flat = flat.to(torch.uint8)
        dist.broadcast(flat, 0)
        REDUCTIONS["broadcast"] += 1
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view(t.shape))


def mean_across_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics (0-d tensors) as their mean over the ranks: one
    all-reduce of all of them (float32)."""
    if world_size() == 1:
        return metrics
    keys = sorted(metrics)
    v = all_reduce_sum(torch.stack([metrics[k].detach().float().reshape(()) for k in keys]), "metrics")
    return dict(zip(keys, (v / world_size()).unbind()))
