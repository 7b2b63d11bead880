"""The port's bench (``unopose_tpu_torch/bench.py``) and its timing loop (``benchmarks/_timing.py``) on the CPU.

The bench runs here at the tiny production config through the plain versions (its numbers are the CPU's and
mean nothing for the card); what is checked is its JSON line, its inputs (the JAX bench's, draw for draw)
and that the timing loop's chained scalar depends on every output.
"""

import functools
import json

import numpy as np
import pytest
import torch

from __graft_entry__ import _full_inputs
from unopose_tpu_torch import bench, configs
from unopose_tpu_torch.benchmarks import _timing


def test_bench_line_on_cpu_tiny(monkeypatch, capsys):
    """``main()`` with ``run(device="cpu")`` on ``production_config(tiny=True)``, ITERS 1: the last stdout
    line parses as JSON with the JAX bench's four keys, a positive rate against its A100 reference. Both
    numbers are rounded from the same unrounded rate, as in the JAX bench (``value`` to 2 decimals,
    ``vs_baseline`` to 3), so ``vs_baseline`` is the rounding of a rate within 0.005 of ``value``."""
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, device="cpu", tiny=True, batch=2, iters=1,
                                                        warmup=1, trials=1))
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "query_ref_pairs_per_sec_per_chip" and line["unit"] == "pairs/s"
    assert line["value"] > 0
    ref = bench.A100_REFERENCE_PAIRS_PER_SEC
    lo, hi = (round((line["value"] + d) / ref, 3) for d in (-0.005, 0.005))
    assert lo <= line["vs_baseline"] <= hi


def test_bench_refuses_without_card(monkeypatch):
    """With no card the bench raises rather than timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()


def test_synthetic_inputs_are_the_jax_bench_draws():
    """``configs.synthetic_inputs`` equals ``__graft_entry__._full_inputs`` (the JAX bench's inputs) draw for
    draw at the tiny sizes: the same keys, shapes, types and values from the same seed."""
    sizes = configs.TINY_SIZES
    ours = configs.synthetic_inputs(np.random.default_rng(0), 2, tiny=True)
    theirs = _full_inputs(np.random.default_rng(0), B=2, img=sizes["img"], npts=sizes["npts"], ntem=sizes["ntem"])
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        w = np.asarray(theirs[k])
        assert v.dtype == w.dtype and v.shape == w.shape, k
        np.testing.assert_array_equal(v, w, err_msg=k)


@pytest.mark.parametrize("leaf", [0, 1, 2, 3])
def test_timing_chain_depends_on_every_output(leaf):
    """``_timing.checksum`` moves when one element of any output tensor moves (float32, bf16, int32 and
    bool leaves, nested in a dict and a tuple); ``alive`` stays a finite zero, infinite outputs included."""
    out = {"a": torch.ones(3), "b": (torch.full((2, 2), 2, dtype=torch.bfloat16), torch.arange(4, dtype=torch.int32)),
           "c": torch.tensor([True, False])}
    leaves = [out["a"], out["b"][0], out["b"][1], out["c"]]
    before = _timing.checksum(out).item()
    flat = leaves[leaf].view(-1)
    flat[-1] = ~flat[-1] if flat.dtype == torch.bool else flat[-1] + 1
    assert _timing.checksum(out).item() != before
    out["a"][0] = float("-inf")
    assert _timing.alive(out).item() == 0.0


def test_timed_loop_chains_its_calls():
    """``timed_loop`` runs one warm-up call and ``outer`` loops of k calls, each call's eps a zero computed
    from the call before (the first of a loop a fresh zero), and stores the ms per call."""
    seen = []

    def fn(eps, x):
        seen.append(eps)
        return x * 2

    results = {}
    dt = _timing.timed_loop("double", fn, torch.ones(4), k=3, outer=2, results=results)
    assert len(seen) == 1 + 2 * 3
    assert all(e.item() == 0.0 and e.dtype == torch.float32 for e in seen)
    assert dt > 0 and results["double"] == round(dt * 1e3, 3)
