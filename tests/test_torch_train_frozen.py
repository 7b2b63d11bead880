"""The frozen-BN fine-PE train stack of the PyTorch port against the JAX
package (CPU).

Under ``UNOPOSE_PE_TRAIN_FROZEN=1`` both packages train the fine PE with
BatchNorm normalising by its running statistics (``pe_mlp_bn_pool_frozen``:
the JAX package's Pallas kernels, run here in interpret mode; the port's
plain passes of K12 and K18 on the CPU), leaving the statistics unchanged.
Inputs are made with numpy from a seed; each test states its tolerance and
why.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from test_torch_models import perturb
from test_torch_train import (
    MODULES, TB, _JitInit, jax_draws, jax_train_config, module_cosines, rel_max, sorted_offsets, surface_batch, t,
)
from unopose_tpu_torch.configs import train_config
from unopose_tpu_torch.engine.train import Trainer
from unopose_tpu_torch.kernels import LAUNCHES, build
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.models import matching as tmatching
from unopose_tpu_torch.models.matching import FinePositionalEncoding
from unopose_tpu_torch.ops import pe_train
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jpt = importlib.import_module("unopose_tpu.ops.pe_train")
jtrain = importlib.import_module("unopose_tpu.engine.train")
jrot = importlib.import_module("unopose_tpu.ops.rotation")
junopose = importlib.import_module("unopose_tpu.models.unopose")
ENV = "UNOPOSE_PE_TRAIN_FROZEN"


def frozen_inputs(seed=0, B=2, P=64, S=64):
    """Channels with half the slots duplicating the first (ties in the max
    pool), He-normal weights, gammas near 1, betas near 0, running means
    near 0 and variances in [0.5, 2.5), and a cotangent R of the pooled output."""
    rng = np.random.default_rng(seed)
    chans = rng.standard_normal((B, 6, P, S)).astype(np.float32)
    chans[..., S // 2:] = chans[..., :1]
    Ws = [(rng.standard_normal((a, b)) * (2.0 / a) ** 0.5).astype(np.float32) for a, b in ((6, 32), (32, 64), (64, 128))]
    gammas = [(1.0 + 0.3 * rng.standard_normal(d)).astype(np.float32) for d in (32, 64, 128)]
    betas = [(0.3 * rng.standard_normal(d)).astype(np.float32) for d in (32, 64, 128)]
    means = [(0.3 * rng.standard_normal(d)).astype(np.float32) for d in (32, 64, 128)]
    vars_ = [(0.5 + 2.0 * rng.random(d)).astype(np.float32) for d in (32, 64, 128)]
    R = rng.standard_normal((B, P, 128)).astype(np.float32)
    return chans, Ws, gammas, betas, means, vars_, R


def torch_frozen(fn, chans, Ws, gammas, betas, means, vars_, R, **kw):
    """pooled and the gradients of sum(pooled R) with respect to Ws, gammas, betas (and the running statistics)."""
    params = [t(x).requires_grad_() for x in (*Ws, *gammas, *betas)]
    stats = [t(x).requires_grad_() for x in (*means, *vars_)]
    pooled = fn(t(chans), params[:3], params[3:6], params[6:], stats[:3], stats[3:], **kw)
    (pooled * t(R)).sum().backward()
    return pooled.detach().numpy(), [p.grad.numpy() for p in params], [s.grad for s in stats]


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_frozen_plain_matches_jax_kernel(monkeypatch, mm):
    """The frozen twin on autograd against ``pe_mlp_bn_pool_frozen(interpret=True)``
    on the same chans, weights and running statistics, B 2, P 64, S 64, half
    the slots tied: pooled, dW, dgamma and dbeta. float32 (the JAX module's
    ``_MM_DTYPE`` switched as its own test does): within 1e-5 of each
    tensor's max (float32 reassociation of sums over 8192 slots; measured
    1.3e-6). bf16: both round at the same points, within 1e-4 (measured
    1.8e-6, one bf16 flip is 4e-3 of an operand)."""
    chans, Ws, gammas, betas, means, vars_, R = frozen_inputs()
    monkeypatch.setattr(jpt, "_MM_DTYPE", getattr(jnp, mm))

    def f(W, g, b):
        pooled = jpt.pe_mlp_bn_pool_frozen(jnp.asarray(chans), W, g, b, means, vars_, interpret=True)
        return jnp.sum(pooled * R), pooled

    (_, jp), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(Ws, gammas, betas)
    pooled, grads, _ = torch_frozen(pe_train.pe_mlp_bn_pool_frozen_plain, chans, Ws, gammas, betas, means, vars_, R,
                                    mm_dtype=getattr(torch, mm))
    gate = 1e-5 if mm == "float32" else 1e-4
    assert rel_max(pooled, jp) < gate
    for name, a, b in zip([f"{k}{i}" for k in ("W", "gamma", "beta") for i in range(3)], grads, [*jg[0], *jg[1], *jg[2]]):
        assert rel_max(a, b) < gate, (name, rel_max(a, b))


def test_frozen_autograd_function_matches_plain_twin():
    """``pe_mlp_bn_pool_frozen`` (its CPU passes: K12's plain twin on the
    buffer filled from the running statistics, then ``frozen_bwd_plain``,
    K18's) against the twin on autograd, bf16 rounding points on both: the
    same forward bit for bit (the same products and affine), the gradients
    within 1e-5 of each tensor's max (the one-sweep backward sums in another
    order than autograd; measured 2.7e-7). The running statistics get no
    gradient."""
    args = frozen_inputs(seed=1)
    p1, g1, s1 = torch_frozen(pe_train.pe_mlp_bn_pool_frozen, *args)
    p2, g2, _ = torch_frozen(pe_train.pe_mlp_bn_pool_frozen_plain, *args)
    assert np.array_equal(p1, p2)
    for a, b in zip(g1, g2):
        assert rel_max(a, b) < 1e-5
    assert all(s is None for s in s1)


def test_frozen_buffer_is_jax_affine():
    """The statistics buffer of the frozen forward holds the rows of JAX's
    ``_frozen_fwd_impl`` (run op by op): inv = 1 / sqrt(var + eps), a =
    gamma inv, b = beta - gamma mu inv and the running mean, bit for bit
    (the same float32 operations in the same order; under ``jit`` XLA may
    rewrite them, an ulp apart)."""
    chans, Ws, gammas, betas, means, vars_, _ = frozen_inputs(seed=2, P=32, S=16)
    _, (_, _, _, abs_, rows) = jpt._frozen_fwd_impl(jnp.asarray(chans), Ws, gammas, betas, means, vars_, 1e-5, 32,
                                                    True)
    bn = pe_train.frozen_buffer(*([t(x) for x in v] for v in (gammas, betas, means, vars_)), 1e-5, "cpu")
    for l, d in enumerate((32, 64, 128)):
        (a, b), (mu, inv, _) = np.asarray(abs_[l])[0], np.asarray(rows[l])[0]
        for row, want in ((pe_train.A, a), (pe_train.B_, b), (pe_train.MU, mu), (pe_train.INV, inv)):
            assert np.array_equal(bn[l, row, :d].numpy(), want[:d]), (l, row)


def test_frozen_dispatch_and_refusal(monkeypatch):
    """On CPU tensors the frozen stack never reaches the kernel loader nor
    counts a launch; K18's wrapper refuses CPU tensors."""
    chans, Ws, gammas, betas, means, vars_, R = frozen_inputs(seed=3, P=32, S=16)
    bn = pe_train.frozen_buffer(*([t(x) for x in v] for v in (gammas, betas, means, vars_)), 1e-5, "cpu")
    pooled = torch.rand(2, 32, 128)
    with pytest.raises(ValueError):
        pe_train.frozen_bwd_cuda(t(chans), [t(w) for w in Ws], bn, pooled, pooled, pooled)

    def no_loader():
        raise AssertionError("the kernel loader was called for a CPU tensor")

    monkeypatch.setattr(build, "load", no_loader)
    before = dict(LAUNCHES)
    out, grads, _ = torch_frozen(pe_train.pe_mlp_bn_pool_frozen, chans, Ws, gammas, betas, means, vars_, R)
    assert out.shape == (2, 32, 128) and all(np.isfinite(g).all() for g in grads)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("n,frozen", [(64, True), (48, False)])
def test_frozen_route_gate(monkeypatch, n, frozen):
    """Under the switch the fine PE's train forward takes the frozen stack
    when P % 32 == 0 (the JAX package's ``train_shapes_ok``) and leaves the
    running statistics bitwise unchanged; at P = 48 it takes the
    batch-statistics stack, as JAX does, and updates them."""
    monkeypatch.setenv(ENV, "1")
    torch.manual_seed(0)
    pe = FinePositionalEncoding(32, nsample1=8, nsample2=16, fused=True)
    before = {k: v.clone() for k, v in pe.named_buffers()}
    pts = t(np.random.default_rng(4).uniform(-0.2, 0.2, size=(2, n, 3)).astype(np.float32))
    pe.forward_train(pts).sum().backward()
    same = [torch.equal(v, before[k]) for k, v in pe.named_buffers()]
    assert all(same) if frozen else not any(same)
    assert all(getattr(pe, f"mlp{s}_bn{i}").weight.grad is not None for s in (1, 2) for i in range(3))


# ------------------------------------------------------------------ the tiny train step
@pytest.fixture(scope="module")
def frozen_step():
    """One tiny float32 train step with ``UNOPOSE_PE_TRAIN_FROZEN=1`` in both
    packages from the same perturbed train state (running statistics
    included), batch and noise draws; JAX also on the clouds one ulp up and
    down (its own spread) and with its fine PE fed the port's channels; the
    port also with its fine PE fed JAX's channels."""
    mp = pytest.MonkeyPatch()
    mp.setenv(ENV, "1")
    try:
        cfg_j = jax_train_config(tiny=True)
        jm = junopose.UNOPose.from_config(cfg_j.model, dtype=jnp.float32, backbone_dtype=jnp.float32)
        batch = surface_batch()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        state = jtrain.create_train_state(_JitInit(jm), cfg_j, jb, seed=0)
        variables = perturb({"params": state.params, "batch_stats": state.batch_stats}, seed=8)
        state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=jtrain.build_optimizer(cfg_j, variables["params"]).init(variables["params"]))
        noise_key = jax.random.PRNGKey(9)
        grads, chans_j, traced = [], {}, []
        sanitize = jtrain.sanitize_grads
        frozen_j = jpt.pe_mlp_bn_pool_frozen

        def spy(g):
            jax.debug.callback(lambda x: grads.append(jax.tree_util.tree_map(np.asarray, x)), g)
            return sanitize(g)

        def record(chans, *args, **kw):  # the fine PE's channels of JAX's first run, by call
            i = len(traced)
            traced.append(i)
            jax.debug.callback(lambda x: chans_j.setdefault(i, np.asarray(x)), chans)
            return frozen_j(chans, *args, **kw)

        mp.setattr(jtrain, "sanitize_grads", spy)
        mp.setattr(junopose, "aug_pose_noise", lambda key, r, tt: jrot.aug_pose_noise(noise_key, r, tt))
        mp.setattr(jpt, "pe_mlp_bn_pool_frozen", record)
        step = jax.jit(jtrain.make_train_step(jm, cfg_j))
        runs = [jb] + [{**jb, k: jnp.nextafter(jb[k], d * jnp.inf)} for k in ("pts", "tem1_pts") for d in (1, -1)]
        out = {"runs": []}
        for b in runs:
            new_state, metrics = step(state, b, jax.random.PRNGKey(0))
            out["runs"].append((jax.tree_util.tree_map(np.asarray, new_state), {k: float(v) for k, v in metrics.items()}))
            jax.effects_barrier()
        out["grads"] = [traverse_util.unflatten_dict(g) for g in grads[:len(runs)]]
        out["chans"], out["jax_calls"] = dict(chans_j), len(traced)

        cfg_t = train_config(tiny=True)
        frozen_t = tmatching.pe_mlp_bn_pool_frozen

        def port_step(channels):
            """One port step (its frozen-stack calls counted); ``channels(own, center, grouped, r)`` makes the
            fine PE's channels."""
            tm = UNOPose.from_config(cfg_t.model, dtype=torch.float32, backbone_dtype=torch.float32)
            load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
            own = tm.fine_matching.pe.train_channels
            tm.fine_matching.pe.train_channels = lambda *args: channels(own, *args)
            calls = []
            mp.setattr(tmatching, "pe_mlp_bn_pool_frozen", lambda *a, **k: calls.append(1) or frozen_t(*a, **k))
            before = {k: v.clone() for k, v in tm.state_dict().items()}
            trainer = Trainer(tm, cfg_t)
            metrics = trainer.step({k: t(v) for k, v in batch.items()}, pose_noise=jax_draws(noise_key, TB))
            return ({k: float(v) for k, v in metrics.items()}, {n: p.grad.clone() for n, p in trainer.params},
                    before, {k: v.clone() for k, v in tm.state_dict().items()}, len(calls))

        port_chans = []

        def own_channels(own, *args):
            chans = own(*args)
            port_chans.append(chans.numpy())
            return chans

        out["port"] = port_step(own_channels)
        calls = iter(range(len(out["chans"])))
        out["rows_alike"] = []

        def jax_channels(own, center, grouped, r):
            mine, theirs = own(center, grouped, r).numpy(), out["chans"][next(calls)]
            assert mine.shape == theirs.shape
            alike = np.abs(sorted_offsets(mine) - sorted_offsets(theirs)).max(axis=(2, 3)) <= 1e-5
            out["rows_alike"].append(float(alike.mean()))
            return t(theirs)

        out["port_on_jax_channels"] = port_step(jax_channels)
        assert next(calls, None) is None

        # JAX once more, its fine PE fed the port's channels (the four calls of one trace)
        replay = iter(port_chans)
        mp.setattr(jpt, "pe_mlp_bn_pool_frozen", lambda chans, *a, **k: frozen_j(jnp.asarray(next(replay)), *a, **k))
        n_grads = len(grads)
        _, metrics = jax.jit(jtrain.make_train_step(jm, cfg_j))(state, jb, jax.random.PRNGKey(0))
        jax.effects_barrier()
        assert next(replay, None) is None
        out["jax_on_port_channels"] = ({k: float(v) for k, v in metrics.items()},
                                       traverse_util.unflatten_dict(grads[n_grads]))
    finally:
        mp.undo()
    out["variables"] = variables
    return out


def test_tiny_frozen_train_step_matches_jax(frozen_step):
    """One tiny frozen-BN train step, port vs JAX's ``make_train_step``, each
    fine-PE scale through the frozen stack in both (four calls a step).
    ``test_tiny_train_step_matches_jax``'s gates, for its reason (the fine
    PE's local frames are ill conditioned on a few neighbourhoods, and a
    frame that flips between the packages moves everything the fine PE
    reaches): one minus each top-level module's gradient cosine within
    three times JAX's own one-ulp spread plus 1e-6, and the loss terms the
    fine PE does not reach (the coarse ones) within three times the spread
    plus 1e-5 relative. Those gates on the fine terms do not hold here:
    ``fine_saliency_loss2`` lands at 1.08 of its gate (4.5e-4 against a
    spread of 1.4e-4), while the frozen BN, which does not renormalise,
    leaves the fine activations nearer the ReLU threshold than the batch
    statistics do. So every metric is held instead to JAX fed the port's
    own channels, which takes the frames' difference out: within 2e-3
    relative, ``test_tiny_train_step_on_jax_pe_channels_matches_jax``'s gate
    (measured 4.3e-4, ``fine_atten_loss0``), and the module cosines against
    that run under 5e-4 (measured 7.9e-5, the fine matcher)."""
    (_, jm), *nudged = frozen_step["runs"]
    pm, pg, _, _, calls = frozen_step["port"]
    assert frozen_step["jax_calls"] == 4 and calls == 4
    assert sorted(pm) == sorted(jm)
    for k in (k for k in jm if k.startswith("coarse")):
        spread = max(abs(m[k] - jm[k]) for _, m in nudged)
        rows = 0.01 * (1.0 if k.endswith("_acc") else max(abs(jm[k]), 1.0) if k.endswith("_fg_num") else 0.0)
        assert abs(pm[k] - jm[k]) <= 3 * spread + 1e-5 * max(abs(jm[k]), 1.0) + rows, (k, pm[k], jm[k], spread)
    jr, jrg = frozen_step["jax_on_port_channels"]
    for k in jm:
        assert abs(pm[k] - jr[k]) <= 2e-3 * abs(jr[k]) + 1e-6, (k, pm[k], jr[k])
    jg, *ng = ({k: v.numpy() for k, v in flax_to_torch({"params": g}).items()} for g in frozen_step["grads"])
    pg = {k: v.numpy() for k, v in pg.items()}
    assert sorted(pg) == sorted(k for k in jg if "vit" not in k)
    cos_port = module_cosines(pg, jg)
    cos_replay = module_cosines(pg, {k: v.numpy() for k, v in flax_to_torch({"params": jrg}).items()})
    for m in MODULES:
        spread = max(1 - module_cosines(g, jg)[m] for g in ng)
        assert 1 - cos_port[m] <= 3 * spread + 1e-6, (m, cos_port[m], spread)
        assert 1 - cos_replay[m] < 5e-4, (m, cos_replay[m])


def test_tiny_frozen_train_step_on_jax_pe_channels_matches_jax(frozen_step):
    """The frozen step again with the port's fine PE fed JAX's channels (each
    call first checked to see JAX's neighbourhoods on at least 95% of rows):
    every metric within 2e-3 relative, the gate of
    ``test_tiny_train_step_on_jax_pe_channels_matches_jax`` (measured 8.4e-4,
    the gradient norm), and one minus each module's gradient cosine under
    5e-4 (measured 1.6e-4, the fine matcher; 3.3e-5 with batch statistics:
    the frozen BN's activations sit nearer the ReLU threshold, and the
    upstream gradient reaching the PE, whose plain output layer ``mlp3``
    already differs by 2% of its max, carries the softmaxes' amplification
    of float32 differences under random weights)."""
    assert len(frozen_step["rows_alike"]) == 4 and min(frozen_step["rows_alike"]) >= 0.95, frozen_step["rows_alike"]
    _, jm = frozen_step["runs"][0]
    pm, pg, _, _, calls = frozen_step["port_on_jax_channels"]
    assert calls == 4
    for k in jm:
        assert abs(pm[k] - jm[k]) <= 2e-3 * abs(jm[k]) + 1e-6, (k, pm[k], jm[k])
    jg = {k: v.numpy() for k, v in flax_to_torch({"params": frozen_step["grads"][0]}).items()}
    for m, c in module_cosines({k: v.numpy() for k, v in pg.items()}, jg).items():
        assert 1 - c < 5e-4, (m, c)


def test_tiny_frozen_train_step_state(frozen_step):
    """After the frozen step, in both port runs and in JAX's: the fine PE's
    BatchNorm running statistics bitwise unchanged, its six gammas and six
    betas moved, and the frozen ViT bitwise unchanged."""
    variables = frozen_step["variables"]
    start = flax_to_torch({"params": variables["params"], "batch_stats": variables["batch_stats"]})
    state_j, _ = frozen_step["runs"][0]
    new_j = flax_to_torch({"params": state_j.params, "batch_stats": state_j.batch_stats})
    for run in ("port", "port_on_jax_channels"):
        _, _, before, after, _ = frozen_step[run]
        stats = [k for k in after if ".pe." in k and (k.endswith(".mean") or k.endswith(".var"))]
        affine = [k for k in after if ".pe.mlp" in k and "_bn" in k and (k.endswith(".weight") or k.endswith(".bias"))]
        assert len(stats) == 12 and len(affine) == 12
        for k in stats:
            assert torch.equal(after[k], before[k]) and torch.equal(new_j[k], start[k]), k
        for k in affine:
            assert not torch.equal(after[k], before[k]) and not torch.equal(new_j[k], start[k]), k
        vit = [k for k in after if ".vit." in k]
        assert vit and all(torch.equal(after[k], before[k]) and torch.equal(new_j[k], before[k]) for k in vit)
