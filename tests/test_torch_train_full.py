"""The train settings that reach past the frozen-backbone recipe, in the
PyTorch port against the JAX package (CPU): training the ViT
(``freeze_vit=False``), gradient clipping (``train.clip_grad``) and the
model EMA (``train.model_ema``), over two tiny steps of ``Trainer`` against
JAX's ``make_train_step``; and a checkpoint's save and restore between the
steps, bitwise equal to the two steps without it. Inputs are made with
numpy from seeds; each test states its tolerance and why.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from test_torch_models import perturb
from test_torch_train import TB, _JitInit, jax_draws, jax_train_config, surface_batch, t
from unopose_tpu_torch import configs
from unopose_tpu_torch.engine.train import Trainer
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.ops.rotation import PoseNoiseDraws
from unopose_tpu_torch.utils.checkpoint import Checkpointer
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jtrain = importlib.import_module("unopose_tpu.engine.train")
jrot = importlib.import_module("unopose_tpu.ops.rotation")
junopose = importlib.import_module("unopose_tpu.models.unopose")

MAX_NORM = 5.0  # below the first step's gradient norm (about 30 here), so the clip binds
DECAY = 0.9  # an EMA that moves visibly in two steps
LR = 1e-3  # flat over the two steps (warmup factor 1)
# the gradient's top-level parts: the ViT, the rest of the encoder (its upscaler), and the other modules
PARTS = ("encoder.rgb_net.vit.", "encoder.rgb_net.output_upscaling.", "geo_embed.", "coarse_matching.",
         "fine_matching.")


def settings(cfg):
    """The train settings of this file on a train config (either package's):
    every parameter trained, the clip binding, the EMA, a flat learning
    rate, and the fine PE's plain MLP without its LRF channels (no
    ill-conditioned local frame then moves the fine stage between the
    packages; the PE's train configurations have their own tests)."""
    cfg.model.feature_extraction.freeze_vit = False
    cfg.model.fine_point_matching.update(pe_fused=False, use_lrf=False)
    cfg.optimizer.lr = LR
    cfg.lr_multiplier.warmup_factor = 1.0
    cfg.train.clip_grad.enabled = True
    cfg.train.clip_grad.params.max_norm = MAX_NORM
    cfg.train.model_ema = type(cfg.train)(enabled=True, decay=DECAY)
    return cfg


def port_config():
    return settings(configs.train_config(tiny=True))


@pytest.fixture(scope="module")
def full_steps():
    """Two tiny steps of JAX's ``make_train_step`` with every parameter
    trained, the clip and the EMA, from a perturbed train state (the EMA
    starting at the perturbed parameters), the same batch and noise draws
    both times, and the first step again with either cloud one ulp up and
    down: the states, metrics and raw gradients; plus the variables, the
    batch and the noise draws."""
    cfg_j = settings(jax_train_config(tiny=True))
    jm = junopose.UNOPose.from_config(cfg_j.model, dtype=jnp.float32, backbone_dtype=jnp.float32)
    batch = surface_batch(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtrain.create_train_state(_JitInit(jm), cfg_j, jb, seed=0)
    assert state.ema_params is not None
    variables = perturb({"params": state.params, "batch_stats": state.batch_stats}, seed=8)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"], ema_params=variables["params"],
                          opt_state=jtrain.build_optimizer(cfg_j, variables["params"]).init(variables["params"]))
    noise_key = jax.random.PRNGKey(9)  # both steps draw the same initial-pose noise
    grads = []
    sanitize = jtrain.sanitize_grads

    def spy(g):
        jax.debug.callback(lambda x: grads.append(jax.tree_util.tree_map(np.asarray, x)), g)
        return sanitize(g)

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "sanitize_grads", spy)
    mp.setattr(junopose, "aug_pose_noise", lambda key, r, tt: jrot.aug_pose_noise(noise_key, r, tt))
    runs = []
    try:
        step = jax.jit(jtrain.make_train_step(jm, cfg_j))
        for i in range(2):
            new_state, metrics = step(state, jb, jax.random.PRNGKey(i))
            jax.effects_barrier()
            runs.append((jax.tree_util.tree_map(np.asarray, new_state), {k: float(v) for k, v in metrics.items()},
                         traverse_util.unflatten_dict(grads.pop())))
            if i == 0:  # either cloud one ulp up and down, as test_tiny_train_step_matches_jax
                spread = []
                for b in ({**jb, k: jnp.nextafter(jb[k], d * jnp.inf)} for k in ("pts", "tem1_pts") for d in (1, -1)):
                    _, m = step(state, b, jax.random.PRNGKey(i))
                    jax.effects_barrier()
                    spread.append(({k: float(v) for k, v in m.items()}, traverse_util.unflatten_dict(grads.pop())))
            state = new_state
    finally:
        mp.undo()
    return dict(runs=runs, spread=spread, variables=variables, batch=batch, draws=jax_draws(noise_key, TB))


def port_trainer(full_steps):
    model = UNOPose.from_config(port_config().model, dtype=torch.float32, backbone_dtype=torch.float32)
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, full_steps["variables"]))
    return Trainer(model, port_config())


def part_cosines(a: dict, b: dict) -> dict:
    """Cosine of two gradient dicts (torch names, numpy) per part of ``PARTS``."""
    out = {}
    for part in PARTS:
        keys = [k for k in b if k.startswith(part)]
        x = np.concatenate([np.ravel(a[k]) for k in keys]).astype(np.float64)
        y = np.concatenate([np.ravel(b[k]) for k in keys]).astype(np.float64)
        out[part] = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    return out


def test_first_step_trains_the_vit_like_jax(full_steps):
    """The first step, port against JAX with every parameter trained: the
    gradient has every parameter, the ViT's included; every metric of
    ``process_loss`` and the gradient norm (before the clip) within three
    times JAX's own spread (either cloud one ulp up and down; measured 1-2
    times the spread) plus 1e-5 relative (plus 1% of
    the rows for the accuracies and foreground counts); one minus the
    gradient's cosine on each part (the ViT, the upscaler, each other
    module) within three times JAX's spread plus 1e-6. The norm is past
    ``MAX_NORM``, so the clip binds in both packages."""
    trainer = port_trainer(full_steps)
    names = {n for n, _ in trainer.params}
    assert names == {n for n, _ in trainer.model.named_parameters()}
    assert any(".vit." in n for n in names)
    assert all(p.requires_grad for _, p in trainer.params)
    pm = {k: float(v) for k, v in trainer.step({k: t(v) for k, v in full_steps["batch"].items()},
                                               pose_noise=full_steps["draws"]).items()}
    _, jm, jg = full_steps["runs"][0]
    assert sorted(pm) == sorted(jm) and jm["grad_norm"] > MAX_NORM and pm["grad_norm"] > MAX_NORM
    for k in jm:
        spread = max(abs(m[k] - jm[k]) for m, _ in full_steps["spread"])
        rows = 0.01 * (1.0 if k.endswith("_acc") else max(abs(jm[k]), 1.0) if k.endswith("_fg_num") else 0.0)
        assert abs(pm[k] - jm[k]) <= 3 * spread + 1e-5 * max(abs(jm[k]), 1.0) + rows, (k, pm[k], jm[k], spread)
    as_np = lambda g: {k: v.numpy() for k, v in flax_to_torch({"params": g}).items()}
    jg = as_np(jg)
    assert sorted(jg) == sorted(names)
    # the port's raw gradients were clipped in place: their direction is the raw one's
    cos = part_cosines({n: p.grad.numpy() for n, p in trainer.params}, jg)
    for part in PARTS:
        spread = max(1 - part_cosines(as_np(g), jg)[part] for _, g in full_steps["spread"])
        assert 1 - cos[part] <= 3 * spread + 1e-6, (part, cos[part], spread)


def test_clip_adam_and_ema_match_jax(full_steps):
    """The update alone, both steps: the port's trainer, from the same state
    and handed JAX's raw gradients of each step (``Trainer.apply_gradients``),
    makes JAX's update: the gradient norm it returns (before the clip) within
    1e-6 relative of JAX's logged one (float32 sums in another order); every
    parameter and every EMA entry within two float32 ulps of its own value
    plus 2e-5 of the learning rate (optax computes Adam's bias corrections
    1 - b^t in float32, which loses 1.3e-5 of 1 - 0.999 at the first step
    and half of that through the square root; torch.optim.Adam computes
    them in double; measured 1.65e-5 of the learning rate after two steps);
    and the EMA moved, apart from the parameters."""
    trainer = port_trainer(full_steps)
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    for i, (state, metrics, raw) in enumerate(full_steps["runs"]):
        g = flax_to_torch({"params": raw})
        for n, p in trainer.params:
            p.grad = g[n].clone()
        norm = float(trainer.apply_gradients())
        assert abs(norm - metrics["grad_norm"]) <= 1e-6 * metrics["grad_norm"], (i, norm, metrics["grad_norm"])
        params, ema = flax_to_torch({"params": state.params}), flax_to_torch({"params": state.ema_params})
        for n, p in trainer.model.named_parameters():
            for got, want in ((p.detach(), params[n]), (trainer.ema[n], ema[n])):
                tol = 2e-5 * LR + 2 * torch.from_numpy(np.spacing(np.abs(want.numpy())))
                assert ((got - want).abs() <= tol).all(), (i, n, (got - want).abs().max().item())
    moved = [n for n, p in trainer.model.named_parameters() if not torch.equal(p.detach(), start[n])]
    assert len(moved) > 0.9 * len(start)
    assert all(not torch.equal(trainer.ema[n], start[n]) and not torch.equal(trainer.ema[n], p.detach())
               for n, p in trainer.model.named_parameters() if n in moved)


def test_clip_scales_the_update_as_optax():
    """The clip on made-up gradients: past ``max_norm`` every gradient
    becomes ``g / norm * max_norm`` (optax's ``clip_by_global_norm``,
    compared bitwise on the same float32 norm), below it the gradients are
    left as they are; the returned norm is the one before the clip."""
    import optax

    cfg = port_config()
    cfg.train.model_ema.enabled = False
    model = torch.nn.Module()
    model.a, model.b = torch.nn.Parameter(torch.zeros(3, 4)), torch.nn.Parameter(torch.zeros(5))
    rng = np.random.default_rng(2)
    for scale in (10.0, 0.1):
        trainer = Trainer(model, cfg)
        trainer.optimizer.step = lambda: None  # the clipped gradients stay in .grad
        raw = {n: (rng.standard_normal(p.shape) * scale).astype(np.float32) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = t(raw[n])
        norm = trainer.apply_gradients()
        want, _ = optax.clip_by_global_norm(MAX_NORM).update({n: jnp.asarray(v) for n, v in raw.items()}, None)
        jnorm = float(optax.global_norm({n: jnp.asarray(v) for n, v in raw.items()}))
        assert abs(float(norm) - jnorm) <= 1e-6 * jnorm
        for n, p in model.named_parameters():
            if scale < 1:
                assert np.array_equal(p.grad.numpy(), raw[n])
            else:
                ref = raw[n] / np.float32(norm) * np.float32(MAX_NORM)
                assert np.array_equal(p.grad.numpy(), ref), n
                assert np.abs(p.grad.numpy() - np.asarray(want[n])).max() <= 1e-6 * np.abs(ref).max(), n


def test_resume_continues_bitwise(tmp_path):
    """Two port steps with every parameter trained, the clip and the EMA,
    against one step, a checkpoint saved and restored into a fresh model and
    trainer, and the second step: the parameters, the BatchNorm running
    statistics, the EMA, the Adam state and the step count bitwise equal.
    A trainer with an EMA refuses a step saved without one."""
    cfg = port_config()
    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(v) for k, v in configs.synthetic_train_inputs(rng, TB, tiny=True).items()}
               for _ in range(2)]
    draws = [PoseNoiseDraws.draw(TB, torch.Generator().manual_seed(s)) for s in (1, 2)]
    torch.manual_seed(0)
    init = UNOPose.from_config(cfg.model, torch.float32, torch.float32).state_dict()

    def fresh():
        model = UNOPose.from_config(cfg.model, torch.float32, torch.float32)
        model.load_state_dict(init)
        return Trainer(model, cfg)

    straight = fresh()
    for b, d in zip(batches, draws):
        straight.step(b, pose_noise=d)
    first = fresh()
    first.step(batches[0], pose_noise=draws[0])
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(1, first)
    resumed = fresh()
    ckpt.restore(resumed)
    assert resumed.iteration == 1
    resumed.step(batches[1], pose_noise=draws[1])
    for k, v in straight.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert sorted(straight.ema) == sorted(resumed.ema)
    assert all(torch.equal(straight.ema[k], resumed.ema[k]) for k in straight.ema)
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert straight.iteration == resumed.iteration == 2
    # a step saved without an EMA cannot resume a trainer that keeps one
    plain_cfg = port_config()
    plain_cfg.train.model_ema.enabled = False
    plain = Trainer(UNOPose.from_config(plain_cfg.model, torch.float32, torch.float32), plain_cfg)
    assert plain.ema is None
    Checkpointer(str(tmp_path / "plain")).save(1, plain)
    with pytest.raises(KeyError):
        Checkpointer(str(tmp_path / "plain")).restore(fresh())
