"""The training step's settings and the tiny train step of the PyTorch port
against the JAX package (CPU): ``train_config`` against ``get_cfg()``, the
schedule, the refused settings, ``train_loop``'s guard, the initial-pose
noise, the gather's backward, and one tiny step of ``Trainer`` against
JAX's ``make_train_step`` (its Pallas train kernels in interpret mode) with
the state after it, and again on two gloo ranks. Split from ``test_torch_train.py`` (its helpers and the
``tiny_step`` fixture stay there) so that ``--dist loadfile`` spreads the
two files; each test states its tolerance and why.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_distributed import RANKS, run_ranks
from test_torch_package import _assert_subset
from test_torch_train import (  # noqa: F401  (tiny_step: the module fixture)
    MODULES, TB, jax_draws, jax_train_config, jrot, jsched, module_cosines, rel_max, t, tiny_step,
)
from unopose_tpu_torch import configs
from unopose_tpu_torch.configs import train_config
from unopose_tpu_torch.engine.schedule import build_schedule_from_cfg
from unopose_tpu_torch.engine.train import Trainer, train_loop
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.ops import gather
from unopose_tpu_torch.ops.rotation import aug_pose_noise
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables


@pytest.mark.parametrize("tiny", [False, True])
def test_train_config_is_get_cfg_with_the_pe_train_kernel(tiny):
    """``train_config`` equals the JAX package's ``get_cfg()`` with
    ``pe_fused=True`` on every key it sets: the model section (with
    ``freeze_vit``), the optimizer, the schedule and the train settings,
    and its batch is ``train_batch_size_per_rank``; the port's model built
    from it has the PE train kernels on."""
    from unopose_tpu.configs import main_cfg

    ref, ours = jax_train_config(tiny), train_config(tiny)
    assert ours.model.feature_extraction.freeze_vit is True
    for section in ("model", "lr_multiplier", "train"):
        _assert_subset(ours[section], ref[section], f"{section}.")
    _assert_subset({k: v for k, v in ours.optimizer.items() if k != "betas"}, ref.optimizer)
    assert tuple(ours.optimizer.betas) == tuple(ref.optimizer.betas)
    assert ours.batch_size == main_cfg.train_batch_size_per_rank
    assert ours.train.max_iter == main_cfg.max_iter
    assert UNOPose.from_config(train_config(tiny=True).model).fine_matching.pe.fused


def test_gather_planar_backward_matches_jax():
    """The gather's scatter-add gradient against ``jax.grad`` of the JAX
    package's ``gather_planar`` (``segment_sum``), repeated indices
    included: equal within float32 summation order (1e-6 of the max)."""
    from unopose_tpu.ops.gather_pallas import gather_planar as jgather

    rng = np.random.default_rng(4)
    planes = [rng.standard_normal((2, 64)).astype(np.float32) for _ in range(3)]
    idx = rng.integers(0, 64, size=(2, 32, 16)).astype(np.int32)
    R = [rng.standard_normal((2, 32, 16)).astype(np.float32) for _ in range(3)]
    jg = jax.grad(lambda x, y, z: sum(jnp.sum(o * r) for o, r in zip(jgather(x, y, z, jnp.asarray(idx)), R)),
                  argnums=(0, 1, 2))(*map(jnp.asarray, planes))
    tp = [t(p).requires_grad_() for p in planes]
    sum((o * t(r)).sum() for o, r in zip(gather.gather_planar(*tp, t(idx)), R)).backward()
    for a, b in zip(jg, tp):
        assert rel_max(b.grad.numpy(), a) < 1e-6


def test_aug_pose_noise_matches_jax():
    """The initial-pose noise on JAX's draws, for several keys (every std
    index drawn at least once over them): rotations and translations within
    1e-6 (float32 trigonometry and one 3x3 product chain)."""
    rng = np.random.default_rng(5)
    R = np.stack([configs.random_rotation_np(rng) for _ in range(6)])
    tr = rng.uniform(-0.3, 0.3, size=(6, 3)).astype(np.float32)
    tr[0, 2] = -0.9  # z clamped positive after the noise
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        jr, jt = jrot.aug_pose_noise(key, jnp.asarray(R), jnp.asarray(tr))
        draws = jax_draws(key, 6)
        seen.add(draws.std_index)
        tr_, tt_ = aug_pose_noise(t(R), t(tr), draws)
        assert np.abs(np.asarray(jr) - tr_.numpy()).max() < 1e-6
        assert np.abs(np.asarray(jt) - tt_.numpy()).max() < 1e-6
    assert seen == set(range(5))


@pytest.mark.parametrize("method", ["cosine", "linear", "step"])
def test_schedule_matches_jax(method):
    """The flat-and-anneal schedule at steps across warmup, the anneal and
    past the end equals the JAX package's (both float32: within 1e-7 of the
    base rate, one float32 rounding of a factor)."""
    cfg = jax_train_config(tiny=False).lr_multiplier
    cfg.anneal_method = method
    ours = train_config().lr_multiplier
    ours.anneal_method = method
    want = jsched.build_schedule_from_cfg(cfg, 1e-4)
    got = build_schedule_from_cfg(ours, 1e-4)
    total = cfg.total_iters
    for step in (0, 1, 500, 999, 1000, 1001, 5000, total // 2, 2 * total // 3 + 1, total - 1, total, total + 7):
        assert abs(got(step) - float(want(step))) <= 1e-7 * 1e-4, step


def test_unported_train_settings_are_refused():
    """Training the ViT, gradient clipping and the model EMA are not ported:
    a config asking for one is refused, not run as something else."""
    for key in ("model.feature_extraction.freeze_vit", "train.clip_grad.enabled", "train.model_ema.enabled"):
        cfg = train_config(tiny=True)
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node.setdefault(p, configs.Config())
        node[leaf] = leaf != "freeze_vit"
        with pytest.raises(NotImplementedError):
            Trainer(UNOPose.from_config(cfg.model), cfg)


def test_train_loop_halts_on_a_non_finite_loss():
    """``train_loop`` reads the loss back only at logged iterations, and
    raises ``FloatingPointError`` there at a non-finite one: a NaN at
    iteration 1 passes at log period 2 (iterations 0 and 2 logged) and
    raises at period 1."""

    class Steps:
        iteration = 0

        def step(self, batch, generator=None):
            self.iteration += 1
            return {"loss": torch.as_tensor(batch["loss"]), "grad_norm": torch.tensor(1.0)}

    class Lines(list):
        def write(self, step, metrics):
            self.append((step, metrics["loss"]))

    cfg = configs.main_config(tiny=True)
    data = [{"loss": np.float32(v)} for v in (1.0, float("nan"), 3.0)]
    cfg.train.log_period = 2
    lines = Lines()
    train_loop(torch.nn.Linear(1, 1), cfg, iter(data), trainer=Steps(), max_iter=3, writer=lines)
    assert lines == [(0, 1.0), (2, 3.0)]
    cfg.train.log_period = 1
    with pytest.raises(FloatingPointError, match="iteration 1"):
        train_loop(torch.nn.Linear(1, 1), cfg, iter(data), trainer=Steps(), max_iter=3, writer=Lines())


def test_tiny_train_step_matches_jax(tiny_step):
    """One tiny train step, port vs JAX's ``make_train_step`` (the Pallas PE
    train kernels in interpret mode), from the same train state, batch and
    noise draws. The fine PE's local frames are ill conditioned on a few
    neighbourhoods (ROADMAP Queue 3), and with random weights a frame that
    flips moves the fine attention, its loss and every gradient upstream of
    it; so the gates are three times JAX's own spread, the largest change of
    JAX's result when either cloud moves one ulp up or down: every metric of
    ``process_loss`` and the gradient norm (plus 1e-5 relative for float32
    reassociation; the accuracies and foreground counts, which count argmax
    rows, plus 1% of the rows), and one minus each top-level module's
    gradient cosine (plus 1e-6). Measured: the loss 4.3e-3 off against a
    spread of 2.4e-2; the fine matcher's gradient cosine 0.75 against a
    spread of 0.16 (0.84), the coarse matcher's 1 - 1.5e-11."""
    (_, jm), *nudged = tiny_step["runs"]
    pm = tiny_step["port"][0]
    assert sorted(pm) == sorted(jm)
    for k in jm:
        spread = max(abs(m[k] - jm[k]) for _, m in nudged)
        # the accuracies and foreground counts count argmax rows, which flip one at a time: plus 1% of the rows
        rows = 0.01 * (1.0 if k.endswith("_acc") else max(abs(jm[k]), 1.0) if k.endswith("_fg_num") else 0.0)
        assert abs(pm[k] - jm[k]) <= 3 * spread + 1e-5 * max(abs(jm[k]), 1.0) + rows, (k, pm[k], jm[k], spread)
    jg, *ng = ({k: v.numpy() for k, v in flax_to_torch({"params": g}).items()} for g in tiny_step["grads"])
    pg = {k: v.numpy() for k, v in tiny_step["port"][1].items()}
    assert sorted(pg) == sorted(k for k in jg if "vit" not in k)
    cos_port = module_cosines(pg, jg)
    for m in MODULES:
        spread = max(1 - module_cosines(g, jg)[m] for g in ng)
        assert 1 - cos_port[m] <= 3 * spread + 1e-6, (m, cos_port[m], spread)


def test_tiny_train_step_state(tiny_step):
    """After the step: the BatchNorm running statistics of the fine PE equal
    JAX's within three times its spread (as above) plus 1e-5 (flax's update
    of the same batch statistics); the frozen ViT is bitwise unchanged in
    both packages; every trainable parameter with a gradient above Adam's
    eps moved; and the port's Adam, handed JAX's own gradients, makes JAX's
    update (within 1e-6 of the learning rate plus 1e-7 of the parameter,
    float32)."""
    new = [flax_to_torch({"params": st.params, "batch_stats": st.batch_stats}) for st, _ in tiny_step["runs"]]
    new_j = new[0]
    _, _, before, after = tiny_step["port"]
    bn_keys = [k for k in after if ".pe." in k and (k.endswith(".mean") or k.endswith(".var"))]
    assert len(bn_keys) == 12
    for k in bn_keys:
        spread = max((n[k] - new_j[k]).abs().max().item() for n in new[1:])
        assert (after[k] - new_j[k]).abs().max().item() <= 3 * spread + 1e-5, k
        assert not torch.equal(after[k], before[k]), k
    vit = [k for k in after if ".vit." in k]
    assert vit and all(torch.equal(after[k], before[k]) and torch.equal(new_j[k], before[k]) for k in vit)
    # the optimizer alone: a fresh port optimizer stepped on JAX's gradients
    tm = UNOPose.from_config(tiny_step["cfg"].model, dtype=torch.float32, backbone_dtype=torch.float32)
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, tiny_step["variables"]))
    trainer = Trainer(tm, tiny_step["cfg"])
    jg = flax_to_torch({"params": tiny_step["grads"][0]})
    for name, p in trainer.params:
        p.grad = jg[name].clone()
    lr = trainer.schedule(0)
    trainer.optimizer.param_groups[0]["lr"] = lr
    trainer.optimizer.step()
    for name, p in trainer.params:
        # Adam moves a parameter by about the learning rate unless its gradient is below eps (the key
        # projections' biases, to which the softmax is invariant, have none)
        assert not torch.equal(after[name], before[name]) or jg[name].abs().max().item() < 1e-5, name
        assert (p.detach() - new_j[name]).abs().max().item() <= 1e-6 * lr + 1e-7 * before[name].abs().max().item(), name


def test_converter_maps_a_train_state(tiny_step):
    """A train-initialised flax tree (``create_train_state``, perturbed)
    loads strictly: every BatchNorm ``scale``/``bias`` becomes a trainable
    parameter and every ``batch_stats`` mean/var the buffer beside it, equal
    to the flax leaf."""
    variables = tiny_step["variables"]
    _, _, before, _ = tiny_step["port"]
    tm = UNOPose.from_config(tiny_step["cfg"].model, dtype=torch.float32, backbone_dtype=torch.float32)
    trainable = {n for n, _ in Trainer(tm, tiny_step["cfg"]).params}
    stats = flax_to_torch({"batch_stats": variables["batch_stats"]})
    assert len(stats) == 12 and all(k.startswith("fine_matching.pe.mlp") for k in stats)
    for k, v in stats.items():
        assert torch.equal(before[k], v), k
        for leaf in ("weight", "bias"):
            assert k.rsplit(".", 1)[0] + "." + leaf in trainable, k


def test_tiny_train_step_on_jax_pe_channels_matches_jax(tiny_step):
    """The tiny step again, the port's fine PE fed JAX's own channels (the
    local-frame coordinates, whose ill-conditioned rows flip between the
    packages, are then the same numbers on both sides): the rest of the step,
    the fine matcher's blocks, saliencies and losses included, is held
    tightly to JAX's. Each call saw JAX's neighbourhoods (the fixture's check,
    measured 99.4-100% of rows). Every metric of ``process_loss`` and the
    gradient norm within 2e-3 relative (measured 7.7e-4, the fine attention
    loss of block 0: the clouds and features reach the fine stage a few
    float32 ulps apart, and the random weights' softmax amplifies that), one
    minus each top-level module's gradient cosine under 1e-4 (measured
    3.3e-5, the fine matcher), the fine PE's BatchNorm running statistics
    within 1e-5 of each buffer's max (measured 3.9e-6); the gates are about
    three times the measured values."""
    assert len(tiny_step["rows_alike"]) == 4 and min(tiny_step["rows_alike"]) >= 0.95, tiny_step["rows_alike"]
    state_j, jm = tiny_step["runs"][0]
    pm, pg, _, after = tiny_step["port_on_jax_channels"]
    assert sorted(pm) == sorted(jm)
    for k in jm:
        assert abs(pm[k] - jm[k]) <= 2e-3 * abs(jm[k]) + 1e-6, (k, pm[k], jm[k])
    jg = {k: v.numpy() for k, v in flax_to_torch({"params": tiny_step["grads"][0]}).items()}
    for m, c in module_cosines({k: v.numpy() for k, v in pg.items()}, jg).items():
        assert 1 - c < 1e-4, (m, c)
    new_j = flax_to_torch({"params": state_j.params, "batch_stats": state_j.batch_stats})
    bn_keys = [k for k in after if ".pe." in k and (k.endswith(".mean") or k.endswith(".var"))]
    assert len(bn_keys) == 12
    for k in bn_keys:
        assert (after[k] - new_j[k]).abs().max().item() <= 1e-5 * new_j[k].abs().max().item(), k


def test_two_rank_tiny_train_step_matches_jax(tiny_step, tmp_path):
    """The tiny step on 2 gloo ranks (``tests/torch_dist_train_worker.py``,
    one sample each of the global batch of 2, the fine PE's BatchNorm
    statistics and sums reduced across the ranks, the gradients averaged),
    from the fixture's state, batch and noise draws: the ranks' mean of
    every ``process_loss`` metric and the gradient norm against JAX's
    ``make_train_step`` on the whole batch within the gates of
    ``test_tiny_train_step_matches_jax`` (three times JAX's own one-ulp
    spread, plus 1e-5 relative, plus 1% of the rows for the accuracies and
    foreground counts); both ranks' states after the step bitwise equal."""
    tm = UNOPose.from_config(tiny_step["cfg"].model, dtype=torch.float32, backbone_dtype=torch.float32)
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, tiny_step["variables"]))
    inputs = tmp_path / "inputs.pt"
    torch.save(dict(state=tm.state_dict(), batch={k: t(v) for k, v in tiny_step["batch"].items()},
                    draws=tuple(jax_draws(jax.random.PRNGKey(9), TB))), inputs)
    run_ranks("torch_dist_train_worker.py", "--mode", "step", "--inputs", inputs, "--out", tmp_path / "out")
    ranks = [torch.load(tmp_path / f"out.rank{r}", weights_only=False) for r in range(RANKS)]
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"])
    (_, jm), *nudged = tiny_step["runs"]
    pm = ranks[0]["metrics"]
    assert sorted(pm) == sorted(jm) and pm == ranks[1]["metrics"]
    for k in jm:
        spread = max(abs(m[k] - jm[k]) for _, m in nudged)
        rows = 0.01 * (1.0 if k.endswith("_acc") else max(abs(jm[k]), 1.0) if k.endswith("_fg_num") else 0.0)
        assert abs(pm[k] - jm[k]) <= 3 * spread + 1e-5 * max(abs(jm[k]), 1.0) + rows, (k, pm[k], jm[k], spread)
