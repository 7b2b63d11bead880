"""Chained back-to-back timing of a function on the card (counterpart of ``benchmarks/_timing.py``).

``timed_loop`` runs ``fn(eps, *args)`` k times in a row, each call's ``eps`` a zero-valued float32 scalar
that depends on every output of the call before (``alive``), so every launch stays on the dependency chain,
and reports the best of ``outer`` such loops on the host clock, each ending in ``torch.cuda.synchronize()``,
divided by k. The scalar's reductions (one sum per output tensor) are inside the time. ``fn`` adds ``eps``
to an input, cast to its type.
"""

from __future__ import annotations

import time

import torch


def card() -> torch.device:
    """The CUDA card the scripts time their kernels on; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the profiling scripts time their kernels on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def checksum(out) -> torch.Tensor:
    """A float32 scalar that depends on every element of every tensor in ``out``: the sum of their sums."""
    acc = torch.zeros((), dtype=torch.float32, device=_tensors(out)[0].device)
    for t in _tensors(out):
        acc = acc + t.sum().float()
    return acc


def alive(out) -> torch.Tensor:
    """A float32 zero that depends on every output (the counterpart of ``_alive``): ``checksum`` times zero,
    a non-finite product (an infinite output) taken to zero."""
    return torch.nan_to_num(checksum(out) * 0.0, nan=0.0, posinf=0.0, neginf=0.0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_loop(name: str, fn, *args, k: int = 20, outer: int = 3, results: dict | None = None) -> float:
    """``fn(eps, *args)`` -> a tensor or a tuple, list or dict of them. Returns the seconds per call: the
    best of ``outer`` loops of ``k`` chained calls (after one warm-up loop), divided by k; with
    ``results``, also stores the ms there under ``name``."""
    device = _tensors(list(args))[0].device

    def loop(kk: int):
        eps = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(kk):
            eps = alive(fn(eps, *args))
        return eps

    loop(1)
    _sync(device)
    best = float("inf")
    for _ in range(outer):
        t0 = time.perf_counter()
        loop(k)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    dt = best / k
    if results is not None:
        results[name] = round(dt * 1e3, 3)
    print(f"{name:44s} {dt * 1e3:9.3f} ms/iter   ({k} chained calls, best of {outer})", flush=True)
    return dt
