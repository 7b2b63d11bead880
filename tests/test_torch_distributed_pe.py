"""The fine PE's train stack with its BatchNorm statistics reduced across 2
gloo ranks (``tests/torch_dist_pe_worker.py``), each on half of a global
(4, 6, 64, 16) batch, against the JAX package's
``pe_mlp_bn_pool_train(interpret=True)`` on the whole batch; the split
passes and a group of one against the unsynced passes; and the data-parallel
helpers' units against the JAX package's. Each test states its tolerance."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_distributed import RANKS, run_ranks
from test_torch_train import pe_inputs, rel_max, t, torch_pe
from torch_dist_pe_worker import ROUTES
from unopose_tpu_torch.ops import pe_train
from unopose_tpu_torch.parallel import mesh

jpt = importlib.import_module("unopose_tpu.ops.pe_train")
jmesh = importlib.import_module("unopose_tpu.parallel.mesh")
GLOBAL = dict(B=4, P=64, S=16)


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """The global inputs and each rank's results (one run of the worker)."""
    tmp = tmp_path_factory.mktemp("pe")
    chans, Ws, gammas, betas, R = pe_inputs(seed=2, **GLOBAL)
    arrays = dict(chans=chans, R=R, **{f"{name}{i}": x for name, xs in (("W", Ws), ("gamma", gammas),
                                                                          ("beta", betas)) for i, x in enumerate(xs)})
    np.savez(tmp / "inputs.npz", **arrays)
    run_ranks("torch_dist_pe_worker.py", "--inputs", tmp / "inputs.npz", "--out", tmp / "out")
    ranks = [dict(np.load(tmp / f"out.rank{r}.npz")) for r in range(RANKS)]
    return (chans, Ws, gammas, betas, R), ranks


def jax_reference(mm, chans, Ws, gammas, betas, R):
    """JAX's pooled rows, [means, variances] and gradients of sum(pooled * R) on the whole batch."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jpt, "_MM_DTYPE", jnp.float32 if mm == "float32" else jnp.bfloat16)

        def f(W, g, b):
            pooled, (mu, var) = jpt.pe_mlp_bn_pool_train(jnp.asarray(chans), W, g, b, interpret=True)
            return jnp.sum(pooled * R), (pooled, [*mu, *var])

        (_, (jp, jstats)), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(Ws, gammas, betas)
    return np.asarray(jp), [np.asarray(s) for s in jstats], [np.asarray(g) for g in (*jg[0], *jg[1], *jg[2])]


@pytest.mark.parametrize("route", ROUTES)
def test_synced_pe_matches_jax_on_the_global_batch(synced, route):
    """Each route on 2 ranks against JAX's kernel (interpret mode) on the
    global batch, with the single-process twin test's gates
    (``test_torch_train.py::test_pe_train_plain_matches_jax_kernel``): the
    ranks' pooled rows stacked, the global means and variances (within 1e-4
    of each tensor's max on every route: float32 sums) and R times the
    averaged gradients, the gradient of the global sum (float32: within
    1e-4 of each tensor's max; bf16 rounding points, the kernels' passes
    included: median error under 6e-2, 95th percentile under 0.15, max
    under 0.5 of each tensor's max). Both ranks hold the same statistics
    and gradients bit for bit."""
    (chans, Ws, gammas, betas, R), ranks = synced
    mm = "float32" if route.endswith("float32") else "bfloat16"
    jp, jstats, jg = jax_reference(mm, chans, Ws, gammas, betas, R)
    assert [tuple(r["rows"]) for r in ranks] == [(0, 2), (2, 4)]
    pooled = np.concatenate([r[f"{route}_pooled"] for r in ranks])
    stats = [ranks[0][f"{route}_stat{i}"] for i in range(6)]
    grads = [RANKS * ranks[0][f"{route}_grad{i}"] for i in range(9)]
    for key in [k for k in ranks[0] if k.startswith(route + "_stat") or k.startswith(route + "_grad")]:
        assert np.array_equal(ranks[0][key], ranks[1][key]), key
    for a, b in zip(stats, jstats):
        assert rel_max(a, b) < 1e-4
    if mm == "float32":
        for a, b in [(pooled, jp), *zip(grads, jg)]:
            assert rel_max(a, b) < 1e-4
    else:
        for a, b in [(pooled, jp), *zip(grads, jg)]:
            err = np.abs(a - b) / np.abs(b).max()
            assert np.median(err) < 6e-2 and np.quantile(err, 0.95) < 0.15 and err.max() < 0.5


def test_synced_pe_collectives(synced):
    """What each rank launched: the passes route 3 reductions of statistics
    sums (one a depth) and 3 of backward sums (one a layer); the autograd
    route, in each precision, 3 of statistics sums and, in its backward, 3
    of their cotangents; one gradient average a route."""
    for r in synced[1]:
        red = {k[len("reductions_"):]: int(v) for k, v in r.items() if k.startswith("reductions_")}
        assert red == dict(pe_train_stats=9, pe_train_bwd_sums=3, pe_train_stats_grad=6, gradients=3), red


def test_world_size_one_is_the_unsynced_stack(tmp_path):
    """K11's split passes at one rank's count (``stats_partial`` then
    ``stats_finish``) fill the statistics buffer bit for bit as the one-call
    pass does, and K13 given that count's 1/n in the spare row ``INV_N``
    writes its sums bit for bit as with 0 there; in a gloo group
    of one rank, both routes' outputs and gradients are bitwise those of no
    group at all, and no collective is launched."""
    chans, Ws, gammas, betas, R = pe_inputs(seed=2, **GLOBAL)
    tc, tW, tg, tb = t(chans), [t(w) for w in Ws], [t(g) for g in gammas], [t(b) for b in betas]
    bn, gb = pe_train.stats_buffer(tg, tb, "cpu")
    split = bn.clone()
    n = chans.shape[0] * chans.shape[2] * chans.shape[3]
    for depth in (1, 2, 3):
        pe_train.stats_plain(tc, tW, gb, bn, depth, 1e-5)
        pe_train.stats_finish_plain(pe_train.stats_partial_plain(tc, tW, split, depth), gb, split, depth, n, 1e-5)
        assert torch.equal(bn, split), depth
    pooled, cnt = pe_train.fwd_plain(tc, tW, bn)
    dpool = t(R)
    split[0, pe_train.INV_N, 0] = 1.0 / n
    for layer in (3, 2, 1):
        pe_train.bwd_sums_plain(tc, tW, bn, pooled, cnt, dpool, layer)
        pe_train.bwd_sums_plain(tc, tW, split, pooled, cnt, dpool, layer)
        assert torch.equal(bn[:, :pe_train.INV_N], split[:, :pe_train.INV_N]), layer

    routes = (pe_train.pe_mlp_bn_pool_train, pe_train.pe_mlp_bn_pool_train_plain)
    alone = [torch_pe(fn, chans, Ws, gammas, betas, R) for fn in routes]
    before = dict(mesh.REDUCTIONS)
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        assert mesh.initialized() and mesh.world_size() == 1
        grouped = [torch_pe(fn, chans, Ws, gammas, betas, R) for fn in routes]
    finally:
        torch.distributed.destroy_process_group()
    for a, b in zip(alone, grouped):
        for x, y in zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]):
            assert np.array_equal(x, y)
    assert dict(mesh.REDUCTIONS) == before


@pytest.mark.parametrize("world, global_batch", [(1, 8), (2, 8), (4, 8), (2, 10), (4, 32)])
def test_local_batch_slice_and_sync_follow_jax(monkeypatch, world, global_batch):
    """``local_batch_slice`` equals the JAX package's for every rank of each
    world size (its process count and index patched likewise), the ranks'
    slices tiling the first ``world * (global // world)`` rows; at world size
    1 ``sync_processes`` returns at once in both packages and launches no
    barrier."""
    got = []
    for r in range(world):
        monkeypatch.setattr(mesh, "world_size", lambda: world)
        monkeypatch.setattr(mesh, "rank", lambda: r)
        monkeypatch.setattr(jmesh.jax, "process_count", lambda: world)
        monkeypatch.setattr(jmesh.jax, "process_index", lambda: r)
        got.append(mesh.local_batch_slice(global_batch))
        assert got[-1] == jmesh.local_batch_slice(global_batch)
    monkeypatch.undo()
    per = global_batch // world
    assert [(s.start, s.stop) for s in got] == [(r * per, (r + 1) * per) for r in range(world)]
    before = dict(mesh.REDUCTIONS)
    assert mesh.world_size() == 1 and mesh.sync_processes("unit") is None and jmesh.sync_processes("unit") is None
    assert dict(mesh.REDUCTIONS) == before
