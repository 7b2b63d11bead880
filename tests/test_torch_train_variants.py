"""The fine PE's train configurations off the six-channel float32 kernel
route, in the PyTorch port against the JAX package (CPU): the subset mode
(the subset groupings with the Pallas kernel's miss-slot fill, the masked
channels, the MLP with batch statistics over every slot and the max over
the valid ones), the PE with ``pe_dtype="bf16"`` and the PE without its LRF
or xyz channels, each as the module against JAX's (its grouping kernel in
interpret mode); the recompute's running update, made once a step; and
one tiny subset-mode train step of ``Trainer`` (``subset_config(tiny=True)``)
against JAX's ``make_train_step``, each package fed the other's fine-PE
groupings and channels, at JAX's own one-ulp spread. Inputs are made with
numpy from seeds; each test states its tolerance and why.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flax import traverse_util

from test_torch_models import perturb
from test_torch_subset import anisotropic_cloud, subset_inputs
from test_torch_train import MODULES, TB, _JitInit, jax_draws, jax_train_config, module_cosines, t
from unopose_tpu.models.matching import FinePositionalEncoding as JaxPE
from unopose_tpu_torch import configs
from unopose_tpu_torch.configs import SUBSET_TINY_NPTS, TINY_SIZES
from unopose_tpu_torch.engine.train import Trainer
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.models import matching
from unopose_tpu_torch.models.matching import FinePositionalEncoding
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jmatching = importlib.import_module("unopose_tpu.models.matching")
jtrain = importlib.import_module("unopose_tpu.engine.train")
jrot = importlib.import_module("unopose_tpu.ops.rotation")
junopose = importlib.import_module("unopose_tpu.models.unopose")

# (name, JAX module keys, port module keys): the subset mode with the Pallas grouping (fused) on both sides; the
# first_k mode in bf16 on JAX's XLA formulation (fused off; the port's float32-only kernel gate sends it there
# with fused on), and without the LRF or the xyz channels (no train kernel takes three channels)
PE_CASES = {
    "subset": (dict(neighbor_mode="subset", fused=True), dict(neighbor_mode="subset", fused=True)),
    "bf16": (dict(compute_dtype=jnp.bfloat16), dict(compute_dtype=torch.bfloat16, fused=True)),
    "no_lrf": (dict(use_lrf=False), dict(use_lrf=False, fused=True)),
    "no_xyz": (dict(use_xyz=False), dict(use_xyz=False, fused=True)),
}
PE_KW = dict(out_dim=32, r1=0.25, r2=0.5, nsample1=64, nsample2=256)


@functools.lru_cache(maxsize=None)
def jax_pe_fns(case: str):
    """(jitted init, jitted value and gradient of sum(output * R) with the
    output and the new batch statistics) of JAX's PE in training."""
    jpe = JaxPE(**PE_CASES[case][0], **PE_KW)

    def loss(params, stats, p, R):
        out, mutated = jpe.apply({"params": params, "batch_stats": stats}, p, train=True, mutable=["batch_stats"])
        return jnp.sum(out * R), (out, mutated["batch_stats"])

    return (jax.jit(lambda p: jpe.init(jax.random.PRNGKey(0), p, train=True)),
            jax.jit(jax.value_and_grad(loss, has_aux=True)))


def jax_pe_run(case: str, pts: np.ndarray, R: np.ndarray, variables=None):
    """JAX's PE in training on ``pts``: (variables, output, gradients of
    sum(output * R) by torch name, new batch statistics by torch name);
    the variables are initialised and perturbed when not given."""
    init, grad = jax_pe_fns(case)
    if variables is None:
        variables = perturb(init(jnp.asarray(pts)))
    (_, (out, stats)), grads = grad(variables["params"], variables["batch_stats"], jnp.asarray(pts), jnp.asarray(R))
    return (variables, np.asarray(out), {k: v.numpy() for k, v in flax_to_torch({"params": grads}).items()},
            {k: v.numpy() for k, v in flax_to_torch({"batch_stats": stats}).items()})


def port_pe_run(case: str, variables, pts: np.ndarray, R: np.ndarray):
    """The port's PE in training on the same variables: (output, gradients, buffers after the update)."""
    kw = dict(PE_CASES[case][1])
    pe = FinePositionalEncoding(PE_KW["out_dim"], PE_KW["r1"], PE_KW["r2"], PE_KW["nsample1"], PE_KW["nsample2"],
                                **kw)
    load_flax_variables(pe, jax.tree_util.tree_map(np.asarray, variables))
    out = pe.forward_train(t(pts))
    (out * t(R)).sum().backward()
    return (out.detach().numpy(), {n: p.grad.numpy() for n, p in pe.named_parameters()},
            {n: b.numpy() for n, b in pe.named_buffers()})


def rel_err(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(PE_CASES))
def test_train_pe_matches_jax(case):
    """The PE module in training, port against JAX on converted perturbed
    weights, B 2 x 512 points of ``anisotropic_cloud`` (neighbourhoods with
    a covariance eigengap), budgets 64 / 256, radii 0.25 / 0.5: the
    output, every parameter's gradient of sum(output * R) and every running
    statistic after the update. The local frames of a few rows are ill
    conditioned, so each tensor is gated at three times JAX's own spread
    (the largest change of JAX's tensor, relative to its max, when the cloud
    moves one ulp up or down) plus 2e-5 relative (float32 reassociation of
    the BatchNorm sums over 262144 slots); and the running statistics must
    have moved from the initial ones in both packages (the update ran)."""
    pts = anisotropic_cloud(512)
    R = np.random.default_rng(12).standard_normal((2, 512, PE_KW["out_dim"])).astype(np.float32)
    variables, j_out, j_grads, j_stats = jax_pe_run(case, pts, R)
    nudged = [jax_pe_run(case, np.nextafter(pts, np.float32(d * np.inf)), R, variables)[1:] for d in (1, -1)]
    out, grads, stats = port_pe_run(case, variables, pts, R)
    start = {k: v.numpy() for k, v in flax_to_torch({"batch_stats": variables["batch_stats"]}).items()}
    assert sorted(grads) == sorted(j_grads) and sorted(stats) == sorted(j_stats) == sorted(start)
    pairs = [("output", out, j_out, [n[0] for n in nudged])]
    pairs += [(k, grads[k], j_grads[k], [n[1][k] for n in nudged]) for k in j_grads]
    pairs += [(k, stats[k], j_stats[k], [n[2][k] for n in nudged]) for k in j_stats]
    for name, got, want, moved in pairs:
        spread = max(rel_err(m, want) for m in moved)
        assert rel_err(got, want) <= 3 * spread + 2e-5, (case, name, rel_err(got, want), spread)
    for k in start:
        assert not np.array_equal(stats[k], start[k]) and not np.array_equal(j_stats[k], start[k]), k


def test_recompute_updates_the_running_statistics_once(monkeypatch):
    """The subset-mode train PE runs its MLP under ``torch.utils.checkpoint``:
    the forward runs again in the backward (the checkpointed body is called
    four times for two scales), yet the running statistics after a forward
    and a backward are bitwise those of a forward alone, and equal
    0.9 * start + 0.1 * the batch statistics of one call, bitwise."""
    calls = []
    body = matching._plain_train_scale

    def counted(*args):
        calls.append(torch.is_grad_enabled())
        return body(*args)

    monkeypatch.setattr(matching, "_plain_train_scale", counted)
    pts = t(anisotropic_cloud(512))
    torch.manual_seed(3)
    pe = FinePositionalEncoding(32, 0.25, 0.5, 64, 256, fused=True, neighbor_mode="subset")
    with torch.no_grad():
        for bn in (m for n, m in pe.named_modules() if "_bn" in n):
            bn.mean.normal_()
            bn.var.uniform_(0.5, 2.0)
    start = {n: b.clone() for n, b in pe.named_buffers()}
    alone = FinePositionalEncoding(32, 0.25, 0.5, 64, 256, fused=True, neighbor_mode="subset")
    alone.load_state_dict(pe.state_dict())
    with torch.no_grad():
        alone.forward_train(pts)
    calls.clear()
    pe.forward_train(pts).square().sum().backward()
    assert len(calls) == 4, calls  # two scales, each forward and its recompute
    assert all(torch.equal(b, dict(alone.named_buffers())[n]) for n, b in pe.named_buffers())
    # the batch statistics of one call, from the body on the same inputs
    center = tuple(pts.unbind(-1))
    for scale, (r, S) in enumerate(((0.25, 64), (0.5, 256)), start=1):
        g, _, valid = importlib.import_module("unopose_tpu_torch.ops.ball_query").ball_group_subset(r, S, pts)
        chans = pe.train_channels(center, g, r, valid, True, True)
        name = f"mlp{scale}"
        Ws = [getattr(pe, f"{name}_fc{i}_kernel") for i in range(3)]
        bns = [getattr(pe, f"{name}_bn{i}") for i in range(3)]
        with torch.no_grad():
            _, mus, vars_ = body(chans, valid, torch.bfloat16, Ws, [b.weight for b in bns], [b.bias for b in bns])
        for i, (mu, var) in enumerate(zip(mus, vars_)):
            assert torch.equal(bns[i].mean, 0.9 * start[f"{name}_bn{i}.mean"] + 0.1 * mu)
            assert torch.equal(bns[i].var, 0.9 * start[f"{name}_bn{i}.var"] + 0.1 * var)


# ------------------------------------------------------------------ the tiny subset-mode train step
def subset_train_configs():
    """(JAX's tiny config, the port's) of the subset-mode train step: the
    tiny subset config (512 points, budgets 64 / 256; ``freeze_vit``) and
    ``get_cfg()``'s train settings; JAX's ``pe_fused=True`` runs its
    Pallas grouping (interpret mode) and, in training, its XLA formulation
    of the masked MLP."""
    from unopose_tpu.configs.main_cfg import get_tiny_cfg

    cfg_j = jax_train_config(tiny=True)
    ref = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=SUBSET_TINY_NPTS, coarse_npoint=16,
                       n_tem=TINY_SIZES["ntem"] * SUBSET_TINY_NPTS // TINY_SIZES["npts"])
    cfg_j.model.fine_npoint = ref.model.fine_npoint
    cfg_j.model.fine_point_matching.pe_neighbor_mode = "subset"
    cfg_t = configs.train_config(tiny=True)
    cfg_t.model = configs.subset_config(tiny=True)
    return cfg_j, cfg_t


def subset_batch(seed=7):
    """``test_torch_subset.subset_inputs`` (512-point surface clouds, a
    768-point template) as a train batch: the query cloud resampled from the
    template under a random label pose, as ``surface_batch`` makes it."""
    rng = np.random.default_rng(seed)
    batch = subset_inputs(seed)
    R = np.stack([configs.random_rotation_np(rng) for _ in range(TB)])
    tr = (rng.uniform(-0.02, 0.02, size=(TB, 3)) + [0.0, 0.0, 0.55]).astype(np.float32)
    tem = batch["tem1_pts"]
    sel = rng.integers(0, tem.shape[1], size=(TB, SUBSET_TINY_NPTS))
    pts = np.einsum("bij,bnj->bni", R, np.take_along_axis(tem, sel[..., None], axis=1)) + tr[:, None]
    batch.update(pts=(pts + 5e-4 * rng.standard_normal(pts.shape)).astype(np.float32), rotation_label=R,
                 translation_label=tr)
    return batch


@pytest.fixture(scope="module")
def subset_step():
    return run_subset_step()


def run_subset_step():
    """One tiny subset-mode train step in both packages from the same
    perturbed train state, batch and noise draws, each package's fine PE fed
    the other's groupings (planes and validity) and channels (offsets and
    local-frame coordinates), by call: cloud 1 scale 1, scale 2, cloud 2 ...

    - ``jax``: JAX's step as it is, recording its PE's groupings and
      local-frame planes (its grouping kernel's and ``batch_lrf_planar``'s
      outputs, through host callbacks that hand them on unchanged, or a
      source's arrays where one is set: one compiled step serves every run);
    - ``port``: the port's step as it is, recording the same;
    - ``port_on_jax``: the port's step fed JAX's;
    - ``jax_on_port``: JAX's step fed the port's (the offsets are JAX's
      from those groupings);
    - ``held``: JAX's step fed its own recorded groupings and channels with
      every float input one ulp up and down (``nudged``), its own spread
      with the PE's inputs held."""
    cfg_j, cfg_t = subset_train_configs()
    jm = junopose.UNOPose.from_config(cfg_j.model, dtype=jnp.float32, backbone_dtype=jnp.float32)
    batch = subset_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtrain.create_train_state(_JitInit(jm), cfg_j, jb, seed=0)
    variables = perturb({"params": state.params, "batch_stats": state.batch_stats}, seed=8)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=jtrain.build_optimizer(cfg_j, variables["params"]).init(variables["params"]))
    noise_key = jax.random.PRNGKey(9)
    grads, recorded, source, calls = [], {}, {}, {"group": [], "lrf": []}
    sanitize, lrf = jtrain.sanitize_grads, jmatching.batch_lrf_planar
    jbq = importlib.import_module("unopose_tpu.ops.ball_query")
    group = jbq.ball_group_subset_pallas

    def spy(g):
        jax.debug.callback(lambda x: grads.append(jax.tree_util.tree_map(np.asarray, x)), g)
        return sanitize(g)

    def pick(kind: str, i: int, own):
        """A source's arrays for call i, where a source is set; else JAX's own, kept from the first run."""
        if source:
            return tuple(source[i][:4] if kind == "group" else source[i][4:])
        recorded.setdefault((kind, i), [np.asarray(x) for x in own])
        return tuple(own)

    # one trace a call (the remat's recompute runs the same call again, and gets the same arrays)
    def group_fed(radius, nsample, pts, p_blk=64, interpret=False):
        (gx, gy, gz), d2, valid = group(radius, nsample, pts, p_blk=p_blk, interpret=interpret)
        k = len(calls["group"])
        calls["group"].append(k)
        shapes = tuple(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in (gx, gy, gz, valid))
        gx, gy, gz, valid = jax.pure_callback(lambda *own: pick("group", k, own), shapes, gx, gy, gz, valid)
        return (gx, gy, gz), d2, valid

    def lrf_fed(center, grouped, r, mask=None):
        out = lrf(center, grouped, r, mask=mask)
        i = len(calls["lrf"])
        calls["lrf"].append(i)
        shapes = tuple(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in out)
        return jax.pure_callback(lambda *own: pick("lrf", i, own), shapes, *out)

    def metrics_of(new_state, metrics):
        jax.effects_barrier()
        return (flax_to_torch({"params": new_state.params, "batch_stats": new_state.batch_stats}),
                {k: float(v) for k, v in metrics.items()}, traverse_util.unflatten_dict(grads.pop()))

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "sanitize_grads", spy)
    mp.setattr(junopose, "aug_pose_noise", lambda key, r, tt: jrot.aug_pose_noise(noise_key, r, tt))
    mp.setattr(jmatching, "batch_lrf_planar", lrf_fed)
    mp.setattr(jbq, "ball_group_subset_pallas", group_fed)
    out = {}
    try:
        step = jax.jit(jtrain.make_train_step(jm, cfg_j))
        out["jax"] = metrics_of(*step(state, jb, jax.random.PRNGKey(0)))
        out["jax_inputs"] = [recorded[("group", i)] + recorded[("lrf", i)] for i in range(len(calls["lrf"]))]
        source.update(enumerate(out["jax_inputs"]))
        out["held"] = [metrics_of(*step(state, nudged(jb, d), jax.random.PRNGKey(0))) for d in (1, -1)]

        def port_step(feed=None):
            """The port's step and its PE's (planes, validity, local-frame planes) by call; ``feed``: those to use."""
            tm = UNOPose.from_config(cfg_t.model, dtype=torch.float32, backbone_dtype=torch.float32)
            load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
            pe, seen, groups = tm.fine_matching.pe, [], []
            group, channels = matching.ball_group_subset, pe.train_channels

            def feed_group(radius, nsample, pts):
                g, d2, valid = group(radius, nsample, pts)
                if feed is not None:
                    g, valid = tuple(t(x) for x in feed[len(groups)][:3]), t(feed[len(groups)][3])
                groups.append((g, valid))
                return g, d2, valid

            def feed_channels(center, grouped, r, mask, *flags):
                chans = channels(center, grouped, r, mask, *flags)
                if feed is not None:
                    i = len(seen)
                    rel = [t(g) - c[..., None] for g, c in zip(feed[i][:3], center)]
                    chans = torch.stack([*rel, *(t(x) for x in feed[i][4:])], dim=1)
                seen.append([x.numpy() for x in (*grouped, mask)] + [x.numpy() for x in chans[:, 3:].unbind(1)])
                return chans

            mp.setattr(matching, "ball_group_subset", feed_group)
            pe.train_channels = feed_channels
            try:
                trainer = Trainer(tm, cfg_t)
                metrics = trainer.step({k: t(v) for k, v in batch.items()}, pose_noise=jax_draws(noise_key, TB))
            finally:
                mp.setattr(matching, "ball_group_subset", group)
            return ({k: v.clone() for k, v in tm.state_dict().items()}, {k: float(v) for k, v in metrics.items()},
                    {n: p.grad.clone() for n, p in trainer.params}), seen

        out["port"], port_inputs = port_step()
        out["port_on_jax"], _ = port_step(out["jax_inputs"])
        source.clear()
        source.update(enumerate(port_inputs))
        out["jax_on_port"] = metrics_of(*step(state, jb, jax.random.PRNGKey(0)))
    finally:
        mp.undo()
    out["port_inputs"], out["start"] = port_inputs, flax_to_torch({"batch_stats": variables["batch_stats"]})
    return out


def nudged(batch, d: int):
    """The batch with every float input (the crops and both clouds) one ulp up (``d`` 1) or down (-1)."""
    return {k: jnp.nextafter(v, d * jnp.inf) if k in ("rgb", "tem1_rgb", "pts", "tem1_pts") else v
            for k, v in batch.items()}


def spread_gates(ref, moved):
    """Per metric, per module and per BatchNorm buffer: the largest change of
    ``ref`` (state, metrics, gradients) over the runs ``moved``."""
    state, metrics, grads = ref
    g = {k: v.numpy() for k, v in flax_to_torch({"params": grads}).items()}
    bn = [k for k in state if ".pe." in k and (k.endswith(".mean") or k.endswith(".var"))]
    return (
        {k: max(abs(m[1][k] - metrics[k]) for m in moved) for k in metrics},
        {m: max(1 - module_cosines({k: v.numpy() for k, v in flax_to_torch({"params": r[2]}).items()}, g)[m]
                for r in moved) for m in MODULES},
        {k: max((r[0][k] - state[k]).abs().max().item() for r in moved) for k in bn},
    )


def assert_step_close(got, want, gates, what):
    """``got`` (state, metrics, gradients: the port's, torch names, or JAX's)
    against ``want`` within three times ``gates`` (JAX's own spread with the
    PE's inputs held) plus float32 rounding: 1e-5 relative on the metrics
    (plus 1% of the rows for the accuracies and foreground counts, which
    count argmax rows), 1e-6 on one minus each module's gradient cosine,
    1e-6 of each BatchNorm buffer's max."""
    as_np = lambda g: {k: v.numpy() for k, v in (g if isinstance(g[next(iter(g))], torch.Tensor)
                                                  else flax_to_torch({"params": g})).items()}
    (gs, gm, gg), (ws, wm, wg) = got, want
    spread_m, spread_c, spread_bn = gates
    assert sorted(gm) == sorted(wm)
    for k in sorted(wm, key=lambda k: k in ("loss", "grad_norm")):
        rows = 0.01 * (1.0 if k.endswith("_acc") else max(abs(wm[k]), 1.0) if k.endswith("_fg_num") else 0.0)
        assert abs(gm[k] - wm[k]) <= 3 * spread_m[k] + 1e-5 * max(abs(wm[k]), 1.0) + rows, (what, k, gm[k], wm[k])
    cos = module_cosines(*(lambda a, b: ({k: a[k] for k in a if k in b}, b))(as_np(gg), as_np(wg)))
    for m in MODULES:
        assert 1 - cos[m] <= 3 * spread_c[m] + 1e-6, (what, m, cos[m], spread_c[m])
    for k, sp in spread_bn.items():
        assert (gs[k] - ws[k]).abs().max().item() <= 3 * sp + 1e-6 * ws[k].abs().max().item(), (what, k)


@pytest.mark.parametrize("direction", ["port_on_jax", "jax_on_port"])
def test_tiny_subset_train_step_matches_jax(subset_step, direction):
    """The tiny subset-mode step (512-point clouds, budgets 64 / 256), each
    package fed the other's PE groupings and channels (the local frames of
    these clouds are ill conditioned: a one-ulp move of the query cloud
    moves JAX's PE output by 10-24% of its max, so the packages are held to
    each other on the same PE inputs): the port on JAX's against JAX, or
    JAX on the port's against the port; every metric of ``process_loss``
    and the gradient norm, each top-level module's gradient cosine and the
    fine PE's running statistics within three times JAX's own spread with
    the PE's inputs held (the crops and clouds one ulp up and down), plus
    float32 rounding (``assert_step_close``; measured within 1-2 times the
    spread)."""
    gates = spread_gates(subset_step["jax"], subset_step["held"])
    got, want = (("port_on_jax", "jax") if direction == "port_on_jax" else ("jax_on_port", "port"))
    assert_step_close(subset_step[got], subset_step[want], gates, direction)


def test_tiny_subset_train_step_groupings_match_jax(subset_step):
    """The groupings the port's subset step made (K15's plain version)
    agree with JAX's (its Pallas kernel's), call for call: validity equal
    and planes within 1e-5 (the clouds reach the PE a few ulps apart) on at
    least 99% of the slots (a point on a ball's boundary may fall in on one
    side only: measured 100% on the query cloud's, 99.7% on the template's,
    whose normalised coordinates carry the radius's rounding)."""
    assert len(subset_step["port_inputs"]) == len(subset_step["jax_inputs"]) == 4
    for mine, theirs in zip(subset_step["port_inputs"], subset_step["jax_inputs"]):
        same = mine[3] == theirs[3]
        for a, b in zip(mine[:3], theirs[:3]):
            same &= np.abs(a - b) <= 1e-5
        assert same.mean() >= 0.99, same.mean()


def test_tiny_subset_train_step_moves_the_running_statistics(subset_step):
    """The port's own subset step moved every one of the fine PE's twelve
    running statistics, once (0.9 of the start plus 0.1 of a finite batch
    statistic), and kept them finite."""
    state, start = subset_step["port"][0], subset_step["start"]
    assert len(start) == 12
    for k, v in start.items():
        assert torch.isfinite(state[k]).all() and not torch.equal(state[k], v), k
