"""The evaluation entry point's two other modes and its config, PyTorch port
against the JAX package (CPU, float32): ``test_coarse_only``, ``fine_only``
(inference and its train loss terms) and ``eval_config``.

The mode tests run the tiny slice config of ``test_torch_models.py`` on its
perturbed weights and inputs with the mode switched on, the JAX model on the
draws captured at its ``jax.random.uniform`` and the port on the same draws
(``uniforms``); each test states its tolerance.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_eval_model import assert_coarse_search_matches, jax_forward
from test_torch_models import B, max_abs, t, tiny_models
from test_torch_package import _assert_subset
from test_torch_slice import rot_err
from unopose_tpu_torch.configs import TINY_SIZES, eval_config, production_config, slice_config
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.models.unopose import compute_train_losses
from unopose_tpu_torch.ops import solver as tsol
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jsol = importlib.import_module("unopose_tpu.ops.solver")
junopose = importlib.import_module("unopose_tpu.models.unopose")

def _mode_models(key: str):
    """The JAX model and the port with ``key`` set, on the slice's weights
    (fine_only's tree: the same without ``coarse_matching``)."""
    from unopose_tpu.models import UNOPose as JaxUNOPose

    cfg, inputs, _, variables, _ = tiny_models()
    cfg = slice_config(tiny=True)
    cfg[key] = True
    jm = JaxUNOPose.from_config(cfg, dtype=jnp.float32, backbone_dtype=jnp.float32)
    if key == "fine_only":
        variables = {**variables, "params": {k: v for k, v in variables["params"].items() if k != "coarse_matching"}}
    tm = UNOPose.from_config(cfg, dtype=torch.float32, backbone_dtype=torch.float32).eval()
    load_flax_variables(tm, variables)
    return inputs, jm, variables, tm


def test_coarse_only_matches_jax():
    """``test_coarse_only``: the coarse pose is the prediction, its
    translation in meters, in both packages (JAX's relations hold on the
    port's outputs exactly). End to end on the same draws, the port's
    prediction against JAX's: rotation 1e-3 rad, translation 5e-4 m, pose
    score 1e-3 (measured 8.3e-5 rad, 4.0e-5 m of 0.32, 6.3e-5 of 5.4: the
    coarse similarity's float32 differences through the hypothesis search).
    Beside it, the port's coarse search on JAX's coarse tensors and draws
    gives JAX's pose (``assert_coarse_search_matches``), and the port's
    outputs equal its full model's coarse outputs."""
    inputs, jm, variables, tm = _mode_models("test_coarse_only")
    out_j, uniforms = jax_forward(jm, variables, {k: jnp.asarray(v) for k, v in inputs.items()})
    out_t = tm({k: t(v) for k, v in inputs.items()}, uniforms=t(uniforms))
    assert set(out_t) == {"radius", "init_R", "init_t", "init_pose_score", "pred_R", "pred_t", "pred_pose_score"}
    assert "fine_scores" not in out_j
    np.testing.assert_array_equal(out_j["pred_R"], out_j["init_R"])
    np.testing.assert_array_equal(out_j["pred_pose_score"], out_j["init_pose_score"])
    np.testing.assert_array_equal(out_j["pred_t"], out_j["init_t"] * (out_j["radius"][:, None] + np.float32(1e-6)))
    assert rot_err(out_j["pred_R"], out_t["pred_R"]) < 1e-3
    assert max_abs(out_j["pred_t"], out_t["pred_t"]) < 5e-4
    assert max_abs(out_j["pred_pose_score"], out_t["pred_pose_score"]) < 1e-3
    assert_coarse_search_matches(out_j, uniforms)
    full = tiny_models()[4]({k: t(v) for k, v in inputs.items()}, uniforms=t(uniforms))
    for k in ("init_R", "init_t", "init_pose_score"):
        assert torch.equal(full[k], out_t[k]), k
    assert torch.equal(out_t["pred_t"], out_t["init_t"] * (out_t["radius"][:, None] + 1e-6))


def test_fine_only_inference_matches_jax():
    """``fine_only`` (no coarse stage, the fine stage from the identity): the
    port holds no coarse module and converts JAX's tree without one, and
    JAX draws nothing; the deterministic taps (relative 1e-6), the identity
    initial pose, and the fine scores at the slice's fine-stage gates
    (median 5e-3, 95th percentile 5e-2) on the same clouds.

    The pose, two ways. The port's fine solver on JAX's fine similarity,
    scores and clouds gives JAX's pose within ten times JAX's own spread
    under one ulp on the similarity, and at least 1e-4 rad / 1e-5 (pose
    score, max weight 1e-5), as ``test_torch_slice``'s fine solver test.
    End to end, from the identity with random weights the soft assignment
    is nearly uniform and the pose chaotic: one ulp on either input cloud
    moves JAX's own pose by up to 0.35 rad, 0.17 m and 0.11 in pose score
    (measured). The port's prediction is gated at three times that spread
    plus 1e-4 (``test_torch_train``'s rule; measured 0.69 rad, 0.37 m,
    0.047), and is finite and orthonormal (1e-4)."""
    inputs, jm, variables, tm = _mode_models("fine_only")
    assert tm.coarse_matching is None
    assert set(flax_to_torch(variables)) == set(tm.state_dict())
    drawn = []
    real_uniform = jax.random.uniform
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda *a, **k: drawn.append(1) or real_uniform(*a, **k))
        fwd = jax.jit(lambda v, i: jm.apply(v, i, train=False, rngs={"sample": jax.random.PRNGKey(5)},
                                            return_intermediates=True))
        ji = {k: jnp.asarray(v) for k, v in inputs.items()}
        out_j = jax.tree_util.tree_map(np.asarray, fwd(variables, ji))
    assert not drawn
    nudged = [jax.tree_util.tree_map(np.asarray, fwd(variables, {**ji, k: jnp.nextafter(ji[k], d * jnp.inf)}))
              for k in ("pts", "tem1_pts") for d in (1, -1)]
    out_t = tm({k: t(v) for k, v in inputs.items()}, return_intermediates=True)
    assert "init_pose_score" not in out_t and "coarse_atten" not in out_t
    for k in ("dense_pm", "dense_po", "radius"):
        assert max_abs(out_j[k], out_t[k]) < 1e-6 * np.abs(out_j[k]).max(), k
    np.testing.assert_array_equal(out_t["init_R"].numpy(), np.broadcast_to(np.eye(3), (B, 3, 3)))
    np.testing.assert_array_equal(out_j["init_R"], out_t["init_R"].numpy())
    assert not out_t["init_t"].any()
    err = np.abs(out_t["fine_score"].numpy() - out_j["fine_scores"][-1])
    assert np.median(err) < 5e-3 and np.percentile(err, 95) < 5e-2

    args = (out_j["fine_attens"][-1], out_j["fine_scores"][-1], out_j["dense_pm"], out_j["dense_po"])
    solve = jax.jit(lambda *a: jsol.compute_fine_Rt_overlap(*a, None, return_aux=True))
    Rj, tj, sj, wj = solve(*map(jnp.asarray, args))
    Rn, tn, _, _ = solve(jnp.asarray(np.nextafter(args[0], np.float32(np.inf))), *map(jnp.asarray, args[1:]))
    R, tr, score, max_w = tsol.compute_fine_Rt_overlap(*map(t, args))
    assert rot_err(Rj, R) < max(1e-4, 10 * rot_err(Rj, Rn))
    assert max_abs(tj, tr) < max(1e-5, 10 * max_abs(tj, tn))
    assert max_abs(sj, score) < 1e-5 and max_abs(wj, max_w) < 1e-5

    spread = {k: max(max_abs(out_j[k], n[k]) if k != "pred_R" else rot_err(out_j[k], n[k]) for n in nudged)
              for k in ("pred_R", "pred_t", "pred_pose_score")}
    assert rot_err(out_j["pred_R"], out_t["pred_R"]) <= 3 * spread["pred_R"] + 1e-4
    assert max_abs(out_j["pred_t"], out_t["pred_t"]) <= 3 * spread["pred_t"] + 1e-4
    assert max_abs(out_j["pred_pose_score"], out_t["pred_pose_score"]) <= 3 * spread["pred_pose_score"] + 1e-4
    R = out_t["pred_R"].double()
    assert torch.isfinite(R).all() and (R @ R.transpose(1, 2) - torch.eye(3, dtype=torch.float64)).abs().max() < 1e-4


def test_fine_only_train_loss_terms_match_jax():
    """``fine_only`` in training (the production config's train path, as
    ``train_config``): no coarse terms, and each fine loss term against
    JAX's ``compute_train_losses`` within three times JAX's own spread under
    a one-ulp move of either cloud up or down, plus 1e-5 relative (the
    fine PE's ill-conditioned frames, ``test_torch_train``'s rule; the
    accuracies and foreground counts, which count argmax rows, plus 1% of
    the rows)."""
    from test_torch_train import jax_train_config, surface_batch
    from unopose_tpu_torch.configs import train_config

    cfg_j = jax_train_config(tiny=True).model
    cfg_j.fine_only = True
    jm = junopose.UNOPose.from_config(cfg_j, dtype=jnp.float32, backbone_dtype=jnp.float32)
    _, _, _, variables, _ = tiny_models()
    variables = {**variables, "params": {k: v for k, v in variables["params"].items() if k != "coarse_matching"}}
    batch = surface_batch(7)

    @jax.jit
    def terms_j(v, b):
        out, _ = jm.apply(v, b, train=True, rngs={"sample": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return {k: jnp.mean(x) for k, x in junopose.compute_train_losses(out, b, cfg_j).items()}

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    runs = [{k: float(v) for k, v in terms_j(variables, b).items()}
            for b in [jb] + [{**jb, k: jnp.nextafter(jb[k], d * jnp.inf)} for k in ("pts", "tem1_pts") for d in (1, -1)]]
    jt, nudged = runs[0], runs[1:]

    cfg_t = train_config(tiny=True).model
    cfg_t.fine_only = True
    tm = UNOPose.from_config(cfg_t, dtype=torch.float32, backbone_dtype=torch.float32)
    load_flax_variables(tm, variables)
    tm.train()
    out = tm({k: t(v) for k, v in batch.items()}, train=True)
    assert "coarse_attens" not in out and torch.equal(out["init_R"], torch.eye(3).expand(B, 3, 3))
    pt = {k: float(v.detach().mean()) for k, v in compute_train_losses(out, {k: t(v) for k, v in batch.items()}, cfg_t).items()}
    assert sorted(pt) == sorted(jt) and pt and all(k.startswith("fine") for k in pt)
    for k in jt:
        spread = max(abs(m[k] - jt[k]) for m in nudged)
        rows = 0.01 * (1.0 if k.endswith("_acc") else max(abs(jt[k]), 1.0) if k.endswith("_fg_num") else 0.0)
        assert abs(pt[k] - jt[k]) <= 3 * spread + 1e-5 * max(abs(jt[k]), 1.0) + rows, (k, pt[k], jt[k], spread)


def test_coarse_only_and_fine_only_together_are_refused():
    cfg = slice_config(tiny=True)
    cfg.update(test_coarse_only=True, fine_only=True)
    with pytest.raises(ValueError):
        UNOPose.from_config(cfg)


# ------------------------------------------------------------------ the config
@pytest.mark.parametrize("tiny", [False, True])
def test_eval_config_is_get_cfg(tiny):
    """``eval_config``'s model is ``production_config``, and every key it keeps
    of the misc, test, test loader and BOP sections equals ``get_cfg()``'s,
    the tiny form's loader sizes ``get_tiny_cfg``'s train loader sizes."""
    from unopose_tpu.configs.main_cfg import get_cfg, get_tiny_cfg

    cfg = eval_config(tiny)
    assert cfg.model == production_config(tiny)
    assert set(cfg) == {"model", "misc", "test", "dataloader", "bop_eval"}
    ref = get_cfg()
    if tiny:
        train = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=TINY_SIZES["npts"], coarse_npoint=16,
                             n_tem=TINY_SIZES["ntem"]).dataloader.train
        ref.dataloader.test.merge({k: train[k] for k in ("img_size", "n_sample_observed_point",
                                                           "n_sample_template_point")})
    for section in ("misc", "test", "bop_eval"):
        _assert_subset(cfg[section], ref[section], f"{section}.")
    assert set(cfg.dataloader) == {"test"}
    _assert_subset(cfg.dataloader.test, ref.dataloader.test, "dataloader.test.")
    over = eval_config().apply_overrides(["test.instance_batch_size=2", "misc.exp_name='x'", "train.matcher_dtype=bf"])
    assert over.test.instance_batch_size == 2 and over.misc.exp_name == "x" and over.train.matcher_dtype == "bf"
    assert over.flatten()["dataloader.test.img_size"] == 224
