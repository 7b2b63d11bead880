"""The training step of the PyTorch port against the JAX package (CPU).

The port trains ``configs.train_config()``: the production model with the
PE train kernels (``pe_fused`` on; in training that is the JAX package's
``pe_mlp_bn_pool_train``, run here in interpret mode), batch-statistics
BatchNorm, the overlap and correspondence losses, Adam on the flat-and-anneal
schedule. Inputs are made with numpy from a seed, the pose noise's draws
with JAX from a key split in three as ``aug_pose_noise`` splits it, and both
packages get the same numbers. Each test states its tolerance and why.

This file holds the PE train stack, the train grouping and the losses, and
the helpers and ``tiny_step`` fixture of the tiny train step; the step's
tests, the schedule, the config and the other settings are in
``test_torch_train_step.py`` (their own file, so that ``--dist loadfile``
spreads the two).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from test_torch_models import perturb, slice_inputs
from unopose_tpu_torch import configs
from unopose_tpu_torch.configs import TINY_SIZES, train_config
from unopose_tpu_torch.engine.train import Trainer
from unopose_tpu_torch.losses import compute_overlap_loss, process_loss
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.ops import pe_train
from unopose_tpu_torch.ops.rotation import PoseNoiseDraws
from unopose_tpu_torch.utils.convert import load_flax_variables

jpt = importlib.import_module("unopose_tpu.ops.pe_train")
jbq = importlib.import_module("unopose_tpu.ops.ball_query")
ball_query = importlib.import_module("unopose_tpu_torch.ops.ball_query")  # the package exports the function
jrot = importlib.import_module("unopose_tpu.ops.rotation")
jloss = importlib.import_module("unopose_tpu.losses")
jtrain = importlib.import_module("unopose_tpu.engine.train")
jsched = importlib.import_module("unopose_tpu.engine.schedule")
junopose = importlib.import_module("unopose_tpu.models.unopose")
TB = 2  # the tiny step's batch


def t(x):
    return torch.from_numpy(np.array(x))


def rel_max(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def jax_train_config(tiny: bool):
    """The JAX package's ``get_cfg()`` (or the tests' tiny config with the PE
    budgets 64/256) with ``pe_fused=True``, random backbone weights."""
    from unopose_tpu.configs.main_cfg import get_cfg, get_tiny_cfg

    if tiny:
        cfg = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=TINY_SIZES["npts"], coarse_npoint=16,
                           n_tem=TINY_SIZES["ntem"])
        cfg.model.fine_point_matching.merge(dict(nsample1=64, nsample2=256))
    else:
        cfg = get_cfg()
    cfg.model.use_ref_rad = False
    cfg.model.fine_point_matching.pe_fused = True
    cfg.model.feature_extraction.pretrained = False
    return cfg


# ------------------------------------------------------------------ the PE train stack
def pe_inputs(seed=0, B=2, P=64, S=64):
    rng = np.random.default_rng(seed)
    chans = rng.standard_normal((B, 6, P, S)).astype(np.float32)
    chans[..., S // 2:] = chans[..., :1]  # pads duplicate the first hit: ties in the max pool
    Ws = [(rng.standard_normal((a, b)) * (2.0 / a) ** 0.5).astype(np.float32) for a, b in ((6, 32), (32, 64), (64, 128))]
    gammas = [(1.0 + 0.3 * rng.standard_normal(d)).astype(np.float32) for d in (32, 64, 128)]
    betas = [(0.3 * rng.standard_normal(d)).astype(np.float32) for d in (32, 64, 128)]
    R = rng.standard_normal((B, P, 128)).astype(np.float32)
    return chans, Ws, gammas, betas, R


def torch_pe(fn, chans, Ws, gammas, betas, R, **kw):
    params = [t(x).requires_grad_() for x in (*Ws, *gammas, *betas)]
    pooled, (mus, vars_) = fn(t(chans), params[:3], params[3:6], params[6:], **kw)
    (pooled * t(R)).sum().backward()
    return pooled.detach().numpy(), [m.numpy() for m in (*mus, *vars_)], [p.grad.numpy() for p in params]


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_pe_train_plain_matches_jax_kernel(monkeypatch, mm):
    """The plain twin against ``pe_mlp_bn_pool_train(interpret=True)`` on the
    same chans and weights, B 2, P 64, S 64, half the slots duplicating the
    first (ties in the pool). float32 (the JAX module's ``_MM_DTYPE``
    switched as its own test does): pooled, mean, var and every gradient
    within 1e-4 of each tensor's max, float32 reassociation of sums over
    8192 slots (measured 1e-6). bf16: both round at the same points, so
    the JAX test's gates against its float32 reference (median 6e-2, 95th
    percentile 0.15, max 0.5 of each tensor's max) hold with a wide margin;
    the statistics also within 1e-4 (they are float32 sums)."""
    chans, Ws, gammas, betas, R = pe_inputs()
    jdt = jnp.float32 if mm == "float32" else jnp.bfloat16
    monkeypatch.setattr(jpt, "_MM_DTYPE", jdt)

    def f(W, g, b):
        pooled, (m, v) = jpt.pe_mlp_bn_pool_train(jnp.asarray(chans), W, g, b, interpret=True)
        return jnp.sum(pooled * R), (pooled, [*m, *v])

    (_, (jp, jstats)), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(Ws, gammas, betas)
    jg = [*jg[0], *jg[1], *jg[2]]
    pooled, stats, grads = torch_pe(pe_train.pe_mlp_bn_pool_train_plain, chans, Ws, gammas, betas, R,
                                    mm_dtype=getattr(torch, mm))
    for a, b in zip(stats, jstats):
        assert rel_max(a, b) < 1e-4
    if mm == "float32":
        assert rel_max(pooled, jp) < 1e-4
        for a, b in zip(grads, jg):
            assert rel_max(a, b) < 1e-4
    else:
        for a, b in [(pooled, jp), *zip(grads, jg)]:
            err = np.abs(a - np.asarray(b)) / np.abs(np.asarray(b)).max()
            assert np.median(err) < 6e-2 and np.quantile(err, 0.95) < 0.15 and err.max() < 0.5


def test_pe_train_autograd_function_matches_plain_twin():
    """``pe_mlp_bn_pool_train`` (the kernels' pass structure: its CPU passes,
    each the plain twin of a kernel) against the plain twin on autograd, bf16
    rounding points on both: the same forward bit for bit (the same products
    and sums), the gradients within 1e-3 of each tensor's max (the pass
    structure's hand-written BN backward rounds dz to bf16 after other
    float32 operations than autograd's; measured 9e-5)."""
    args = pe_inputs(seed=1)
    p1, s1, g1 = torch_pe(pe_train.pe_mlp_bn_pool_train, *args)
    p2, s2, g2 = torch_pe(pe_train.pe_mlp_bn_pool_train_plain, *args)
    assert np.array_equal(p1, p2)
    assert all(np.array_equal(a, b) for a, b in zip(s1, s2))
    for a, b in zip(g1, g2):
        assert rel_max(a, b) < 1e-3


# ------------------------------------------------------------------ grouping, noise draws, losses
def test_train_grouping_matches_jax():
    """``two_scale_group_first_k_fast`` against the JAX package's on the tiny
    clouds (256 points, budgets 64/256, radii 0.1/0.2): each row's multiset
    of slot points equal at both scales (the port's select compacts the
    slots globally, the JAX train path keeps the per-chunk order; the PE
    is invariant to the order), the overflow flags equal; and on a dense
    cloud that overflows scale 1 both take the exact grouping, equal slot
    for slot."""
    rng = np.random.default_rng(3)
    sparse = (rng.uniform(-0.5, 0.5, size=(2, 256, 3))).astype(np.float32)
    dense = (rng.uniform(-0.08, 0.08, size=(2, 256, 3))).astype(np.float32)
    args = (0.1, 64, 0.2, 256)

    def rows(planes):
        p = np.stack([np.asarray(x) for x in planes], axis=-1)  # (B, N, k, 3)
        order = np.lexsort((p[..., 2], p[..., 1], p[..., 0]), axis=-1)
        return np.take_along_axis(p, order[..., None], axis=2)

    for cloud, overflows in ((sparse, False), (dense, True)):
        jsel = jbq._first_k_budget_select(*args, jnp.asarray(cloud), 4, False, False)
        tsel = ball_query.first_k_budget_select(*args, t(cloud))
        assert bool(jsel["overflow"]) == bool(tsel["overflow"]) == overflows
        jg = jbq.two_scale_group_first_k_fast(*args, jnp.asarray(cloud))
        tg = ball_query.two_scale_group_first_k_fast(*args, t(cloud))
        for js, ts in zip(jg, tg):
            if overflows:
                assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(js, ts))
            else:
                assert np.array_equal(rows(js), rows([x.numpy() for x in ts]))


def jax_draws(key, batch):
    """The draws of ``aug_pose_noise(key, ...)``, split as it splits its key."""
    k_std, k_ang, k_tr = jax.random.split(key, 3)
    return PoseNoiseDraws(int(jax.random.randint(k_std, (), 0, 5)), t(jax.random.normal(k_ang, (batch, 3))),
                          t(jax.random.normal(k_tr, (batch, 3))))


def test_losses_match_jax():
    """``compute_overlap_loss`` (three blocks) and ``process_loss`` against the
    JAX package on random similarities, scores, saliencies and clouds: every
    term within 1e-5 relative (float32 log-softmax and means)."""
    rng = np.random.default_rng(6)
    B, n1, n2 = 2, 33, 41
    pts1 = rng.uniform(-1, 1, size=(B, n1, 3)).astype(np.float32)
    pts2 = rng.uniform(-1, 1, size=(B, n2, 3)).astype(np.float32)
    R = np.stack([configs.random_rotation_np(rng) for _ in range(B)])
    gt_t = rng.uniform(-0.1, 0.1, size=(B, 3)).astype(np.float32)
    attens = [rng.normal(size=(B, n1 + 1, n2 + 1)).astype(np.float32) * 3 for _ in range(3)]
    scores = [rng.uniform(size=(B, n1 + n2)).astype(np.float32) for _ in range(3)]
    sals = [rng.uniform(size=(B, n1 + n2)).astype(np.float32) for _ in range(3)]
    args = (pts1, pts2, R, gt_t)
    want = jloss.compute_overlap_loss(*[[jnp.asarray(x) for x in l] for l in (attens, scores, sals)],
                                      *map(jnp.asarray, args), predator_thres=0.15, dis_thres=0.3, loss_str="fine")
    got = compute_overlap_loss(*[[t(x) for x in l] for l in (attens, scores, sals)], *map(t, args),
                               predator_thres=0.15, dis_thres=0.3, loss_str="fine")
    assert sorted(want) == sorted(got)
    for k in want:
        assert rel_max(got[k].numpy(), want[k]) < 1e-5, k
    pw, pg = jloss.process_loss(want), process_loss(got)
    assert sorted(pw) == sorted(pg)
    for k in pw:
        assert rel_max(pg[k].numpy(), pw[k]) < 1e-5, k


# ------------------------------------------------------------------ the tiny train step
def surface_batch(seed=7):
    """A tiny train batch on the parity tests' surface clouds
    (``test_torch_models.slice_inputs``: bumpy closed surfaces, whose PE
    frames are mostly well conditioned, unlike the uniform cubes of
    ``configs.synthetic_train_inputs``) and a random pose label."""
    rng = np.random.default_rng(seed)
    batch = slice_inputs(seed)
    R = np.stack([configs.random_rotation_np(rng) for _ in range(TB)])
    tr = (rng.uniform(-0.02, 0.02, size=(TB, 3)) + [0.0, 0.0, 0.55]).astype(np.float32)
    tem = batch["tem1_pts"]
    sel = rng.integers(0, tem.shape[1], size=(TB, batch["pts"].shape[1]))
    pts = np.einsum("bij,bnj->bni", R, np.take_along_axis(tem, sel[..., None], axis=1)) + tr[:, None]
    batch.update(pts=(pts + 5e-4 * rng.standard_normal(pts.shape)).astype(np.float32), rotation_label=R,
                 translation_label=tr)
    return batch


class _JitInit:
    """The JAX model with a jitted ``init`` (eager init runs the interpret-mode
    kernels op by op), for ``create_train_state``."""

    def __init__(self, model):
        self.model, self.apply = model, model.apply

    def init(self, rngs, inputs, train):
        return jax.jit(lambda r, i: self.model.init(r, i, train=train))(rngs, inputs)


@pytest.fixture(scope="module")
def tiny_step():
    return run_tiny_step()


def run_tiny_step(shift: int = 0, spreads: bool = True):
    """One tiny float32 train step in both packages from the same perturbed
    train state (``create_train_state``), batch and noise draws, every seed
    (the batch's, the state's, the perturbation's, the noise's and the
    step's key) moved by ``shift``. ``spreads``: JAX also on either cloud one
    ulp up and down (its own spread), and the port on its own fine-PE
    channels; else JAX also on the query cloud one ulp up and down with its
    fine PE fed the channels of its first run (its own spread with the
    channels held)."""
    cfg_j = jax_train_config(tiny=True)
    jm = junopose.UNOPose.from_config(cfg_j.model, dtype=jnp.float32, backbone_dtype=jnp.float32)
    batch = surface_batch(7 + shift)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtrain.create_train_state(_JitInit(jm), cfg_j, jb, seed=0 + shift)
    variables = perturb({"params": state.params, "batch_stats": state.batch_stats}, seed=8 + shift)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=jtrain.build_optimizer(cfg_j, variables["params"]).init(variables["params"]))
    noise_key = jax.random.PRNGKey(9 + shift)
    grads = []
    sanitize = jtrain.sanitize_grads

    def spy(g):
        jax.debug.callback(lambda x: grads.append(jax.tree_util.tree_map(np.asarray, x)), g)
        return sanitize(g)

    # the fine PE's channels (B, 6, P, S) of JAX's first run, by call: cloud 1 scale 1, scale 2, cloud 2 ...
    chans_j, traced = {}, []
    pe_train_j = jpt.pe_mlp_bn_pool_train

    def record(chans, *args, **kw):
        i = len(traced)
        traced.append(i)
        jax.debug.callback(lambda x: chans_j.setdefault(i, np.asarray(x)), chans)
        return pe_train_j(chans, *args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "sanitize_grads", spy)
    mp.setattr(junopose, "aug_pose_noise", lambda key, r, tt: jrot.aug_pose_noise(noise_key, r, tt))
    mp.setattr(jpt, "pe_mlp_bn_pool_train", record)
    try:
        step = jax.jit(jtrain.make_train_step(jm, cfg_j))
        runs = [jb] + [{**jb, k: jnp.nextafter(jb[k], d * jnp.inf)} for k in ("pts", "tem1_pts") for d in (1, -1)
                       if spreads]
        out = {"runs": []}
        for b in runs:
            new_state, metrics = step(state, b, jax.random.PRNGKey(0 + shift))
            out["runs"].append((jax.tree_util.tree_map(np.asarray, new_state), {k: float(v) for k, v in metrics.items()}))
            jax.effects_barrier()
            out.setdefault("chans", dict(chans_j))
        if not spreads:
            held = iter(range(len(out["chans"])))
            mp.setattr(jpt, "pe_mlp_bn_pool_train",
                       lambda chans, *args, **kw: pe_train_j(jnp.asarray(out["chans"][next(held)]), *args, **kw))
            step = jax.jit(jtrain.make_train_step(jm, cfg_j))
            for d in (1, -1):
                new_state, metrics = step(state, {**jb, "pts": jnp.nextafter(jb["pts"], d * jnp.inf)},
                                          jax.random.PRNGKey(0 + shift))
                out["runs"].append((jax.tree_util.tree_map(np.asarray, new_state),
                                    {k: float(v) for k, v in metrics.items()}))
                jax.effects_barrier()
            assert next(held, None) is None
    finally:
        mp.undo()
    # make_train_step differentiates the flattened trainable leaves
    out["grads"] = [traverse_util.unflatten_dict(g) for g in grads]

    cfg_t = train_config(tiny=True)

    def port_step(channels=None):
        """One port step; ``channels(own, center, grouped, r)``, if given, makes the fine PE's channels."""
        tm = UNOPose.from_config(cfg_t.model, dtype=torch.float32, backbone_dtype=torch.float32)
        load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
        if channels is not None:
            own = tm.fine_matching.pe.train_channels
            tm.fine_matching.pe.train_channels = lambda *args: channels(own, *args)
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        trainer = Trainer(tm, cfg_t)
        metrics = trainer.step({k: t(v) for k, v in batch.items()}, pose_noise=jax_draws(noise_key, TB))
        return ({k: float(v) for k, v in metrics.items()}, {n: p.grad.clone() for n, p in trainer.params},
                before, {k: v.clone() for k, v in tm.state_dict().items()})

    if spreads:
        out["port"] = port_step()
    # again, with the fine PE fed JAX's channels in place of its own, once each call is known to see the
    # same neighbourhoods as JAX's: the rows' multisets of offsets (the first three channels) equal
    # within 1e-5 (the clouds reach the PE a few ulps apart) on at least 95% of the rows (a point on a
    # ball's boundary may fall in on one side only, which shifts that row's first k)
    calls = iter(range(len(out["chans"])))
    out["rows_alike"] = []

    def jax_channels(own, center, grouped, r, *extra):
        mine, theirs = own(center, grouped, r, *extra).numpy(), out["chans"][next(calls)]
        assert mine.shape == theirs.shape
        alike = np.abs(sorted_offsets(mine) - sorted_offsets(theirs)).max(axis=(2, 3)) <= 1e-5
        out["rows_alike"].append(float(alike.mean()))
        return t(theirs)

    out["port_on_jax_channels"] = port_step(jax_channels)
    assert next(calls, None) is None
    out["variables"], out["cfg"], out["batch"] = variables, cfg_t, batch
    return out


def sorted_offsets(chans):
    """(B, 6, P, S) channels -> each row's slot offsets (B, P, S, 3) in lexicographic order."""
    p = np.moveaxis(chans[:, :3], 1, -1)
    order = np.lexsort((p[..., 2], p[..., 1], p[..., 0]), axis=-1)
    return np.take_along_axis(p, order[..., None], axis=2)


MODULES = ("encoder", "geo_embed", "coarse_matching", "fine_matching")


def module_cosines(a: dict, b: dict):
    """Cosine of two gradient dicts (torch names) per top-level module."""
    out = {}
    for m in MODULES:
        keys = [k for k in a if k.startswith(m + ".")]
        x = np.concatenate([np.ravel(a[k]) for k in keys]).astype(np.float64)
        y = np.concatenate([np.ravel(b[k]) for k in keys]).astype(np.float64)
        out[m] = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    return out


