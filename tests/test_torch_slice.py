"""The whole inference slice, JAX package vs PyTorch port (CPU, float32).

Tiny config (28 px ViT, 256-point clouds, 16 coarse nodes) with the
production PE budgets 64/256, so the packed first_k path engages, plus the
slice's four switches. B = 2.

The pose solvers sample hypotheses by inverse CDF, so ulp-level differences
upstream can move a draw; and the fine PE's local frames are ill conditioned
on a few neighbourhoods (see ``test_torch_models.test_fine_positional_
encoding``). So the test gates, each with identical inputs on both sides:
the deterministic taps up to the coarse scores; each solver fed the JAX
tensors and the uniforms JAX drew (captured at ``solver.py``'s
``jax.random.uniform``); the fine stage fed the JAX coarse pose; and the
finite, orthonormal end-to-end output of the port.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import B, max_abs, pe_envelope, pe_pair, t, tiny_models
from unopose_tpu_torch.ops.solver import compute_coarse_Rt_overlap, compute_fine_Rt_overlap

jax_solver = importlib.import_module("unopose_tpu.ops.solver")


def rot_err(Ra, Rb):
    """Rotation angle between two batches of rotations, in radians (the
    Frobenius form, accurate for small angles)."""
    d = np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)
    return float((np.linalg.norm(d, axis=(-2, -1)) / np.sqrt(2.0)).max())


@pytest.fixture(scope="module")
def slice_run():
    cfg, inputs, jm, variables, tm = tiny_models()

    drawn = []
    real_uniform = jax.random.uniform

    def spy(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = real_uniform(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda x: drawn.append(np.array(x)), out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", spy)
    try:
        out_j = jax.jit(
            lambda v, i: jm.apply(v, i, train=False, rngs={"sample": jax.random.PRNGKey(5)}, return_intermediates=True)
        )(variables, {k: jnp.asarray(v) for k, v in inputs.items()})
        out_j = jax.tree_util.tree_map(np.asarray, out_j)
    finally:
        mp.undo()
    assert len(drawn) == 1 and drawn[0].shape == (B, 3 * cfg.coarse_point_matching.nproposal1)
    uniforms = drawn[0]
    out_t = tm({k: t(v) for k, v in inputs.items()}, uniforms=t(uniforms), return_intermediates=True)
    return cfg, inputs, tm, out_j, out_t, uniforms, variables


def test_slice_deterministic_taps(slice_run):
    """Encoder clouds and radius (relative 1e-6, FPS indices equal), coarse
    similarity (relative 1e-3) and coarse overlap scores (1e-4)."""
    _, _, _, oj, ot, _, _ = slice_run
    for k in ("dense_pm", "dense_po", "sparse_pm", "sparse_po", "radius"):
        assert max_abs(oj[k], ot[k]) < 1e-6 * np.abs(oj[k]).max(), k
    atten = oj["coarse_attens"][-1]
    assert max_abs(atten, ot["coarse_atten"]) < 1e-3 * np.abs(atten).max()
    assert max_abs(oj["coarse_scores"][-1], ot["coarse_score"]) < 1e-4


def test_slice_coarse_solver_same_uniforms(slice_run):
    """The coarse search on the JAX coarse tensors and the JAX draws, against
    the JAX solver on the same: rotation within 1e-4 rad, translation 1e-5.
    (With random weights the search is ill conditioned: the JAX model's own
    in-jit result differs from its eager solver by ~3e-4 rad here.)"""
    cfg, _, _, oj, _, uniforms, _ = slice_run
    cm = cfg.coarse_point_matching
    assert (oj["init_pose_score"] > 0).all()  # the seeds give every pair foreground labels
    args = (oj["coarse_attens"][-1], oj["coarse_scores"][-1], oj["sparse_pm"], oj["sparse_po"])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(uniforms))
    try:
        Rj, tj, sj = jax_solver.compute_coarse_Rt_overlap(
            jax.random.PRNGKey(0), *map(jnp.asarray, args), None, cm.nproposal1, cm.nproposal2
        )
    finally:
        mp.undo()
    R, tr, score = compute_coarse_Rt_overlap(
        *map(t, args), cm.nproposal1, cm.nproposal2, uniforms=t(uniforms)
    )
    assert rot_err(Rj, R) < 1e-4
    assert max_abs(tj, tr) < 1e-5
    assert max_abs(sj, score) < 1e-4 * np.abs(np.asarray(sj)).max()  # 1/mean distance: sensitive


def _fine_stage(tm, ot, oj):
    with torch.no_grad():
        return tm.fine_matching(
            ot["dense_pm"], ot["dense_fm"], ot["geo"][:B], ot["fps_idx_m"],
            ot["dense_po"], ot["dense_fo"], ot["geo"][B:], ot["fps_idx_o"],
            t(oj["init_R"]), t(oj["init_t"]),
        )


def _pe_cloud(ot, oj):
    p1 = np.matmul(ot["dense_pm"].numpy() - oj["init_t"][:, None, :], oj["init_R"])
    return np.concatenate([p1, ot["dense_po"].numpy()], 0).astype(np.float32)


def test_slice_fine_pe_within_jax_envelope(slice_run):
    """The PE on the slice's own fine input (JAX coarse pose): median row
    error 1e-4, and no more ill-conditioned rows (error > 1e-3) than twice
    JAX's own count under a 1-ulp input change."""
    _, _, _, oj, ot, _, _ = slice_run
    err, ulp = pe_envelope(_pe_cloud(ot, oj))
    assert np.median(err) < 1e-4
    assert (err > 1e-3).sum() <= max(3, 2 * (ulp > 1e-3).sum())


def test_slice_fine_stage_given_jax_pe(slice_run, monkeypatch):
    """The fine stage fed the JAX coarse pose and the JAX PE features: fine
    scores agree to 1e-4 at the median; the tail is the JAX PE itself, whose
    ill-conditioned rows differ between its standalone and in-model runs."""
    _, _, tm, oj, ot, _, _ = slice_run
    apply, pv, tpe = pe_pair()
    pe_j = np.asarray(apply(pv, jnp.asarray(_pe_cloud(ot, oj))))
    monkeypatch.setattr(tpe, "forward", lambda pts: t(pe_j))
    _, score = _fine_stage(tm, ot, oj)
    err = np.abs(score.numpy() - oj["fine_scores"][-1])
    assert np.median(err) < 1e-4


def test_slice_fine_stage_given_coarse_pose(slice_run):
    """The port's whole fine stage fed the JAX coarse pose. The PE's
    ill-conditioned rows (previous tests) spread through the attention, so
    this gates the distribution: median score error 5e-3, 95th percentile
    5e-2 (measured 1.9e-3 and 1.5e-2)."""
    _, _, tm, oj, ot, _, _ = slice_run
    _, score = _fine_stage(tm, ot, oj)
    err = np.abs(score.numpy() - oj["fine_scores"][-1])
    assert tm.fine_matching.pe.last_branch == "packed"
    assert np.median(err) < 5e-3
    assert np.percentile(err, 95) < 5e-2


def test_slice_fine_solver_same_inputs(slice_run):
    """The fine weighted-SVD solve on the JAX fine tensors, against the JAX
    solver on the same. With random weights the soft assignment is nearly
    uniform and the solve ill conditioned: one ulp on the similarity moves
    JAX's own pose by ~5e-5 rad. The gate is ten times JAX's own 1-ulp
    spread, and at least 1e-4 rad / 1e-5; scores and max weights 1e-5."""
    _, _, _, oj, _, _, _ = slice_run
    args = (oj["fine_attens"][-1], oj["fine_scores"][-1], oj["dense_pm"], oj["dense_po"])
    Rj, tj, sj, wj = jax_solver.compute_fine_Rt_overlap(*map(jnp.asarray, args), None, return_aux=True)
    nudged = (np.nextafter(args[0], np.float32(np.inf)),) + args[1:]
    Rn, tn, _, _ = jax_solver.compute_fine_Rt_overlap(*map(jnp.asarray, nudged), None, return_aux=True)
    R, tr, score, max_w = compute_fine_Rt_overlap(*map(t, args))
    assert rot_err(Rj, R) < max(1e-4, 10 * rot_err(Rj, Rn))
    assert max_abs(tj, tr) < max(1e-5, 10 * max_abs(tj, np.asarray(tn)))
    assert max_abs(sj, score) < 1e-5
    assert max_abs(wj, max_w) < 1e-5


def test_slice_outputs_are_poses(slice_run):
    """End to end, the port returns finite, orthonormal, right-handed poses
    and every pose key."""
    _, _, _, _, ot, _, _ = slice_run
    R = ot["pred_R"].double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    assert torch.isfinite(R).all() and torch.isfinite(ot["pred_t"]).all()
    assert (R @ R.transpose(1, 2) - eye).abs().max() < 1e-4
    assert (torch.linalg.det(R) - 1).abs().max() < 1e-4
    assert torch.isfinite(ot["pred_pose_score"]).all()
    for k in ("radius", "init_R", "init_t", "init_pose_score", "pred_R", "pred_t", "pred_pose_score", "fine_wsvd_max_w"):
        assert k in ot
