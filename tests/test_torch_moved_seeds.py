"""Two CPU parity results at seeds other than their files' own, where the
port misses a gate of those files, and what the miss is (the CPU: JAX and
PyTorch side by side, as in ``test_torch_production.py`` and
``test_torch_train.py``).

- The tiny production slice's fused solver with every seed moved by one:
  the port's pose misses JAX's by more than
  ``test_production_slice_fused_solver_same_inputs``'s gate. The weighted
  Procrustes is ill conditioned there, and the packages' few-ulp
  differences in the soft targets and weights move its solution by that
  much: each package's Procrustes is as close to a float64 one as the
  other's on the same inputs.
- The tiny train step with every seed moved by two, the port's fine PE fed
  JAX's channels: the fine matcher's gradient misses JAX's by more than
  ``test_tiny_train_step_on_jax_pe_channels_matches_jax``'s fixed gate.
  JAX's own step moves twice as much when the query cloud moves by one ulp
  with its channels held.
"""

import importlib

import numpy as np

import jax.numpy as jnp

from test_torch_models import max_abs, t
from test_torch_production import run_production_slice
from test_torch_slice import rot_err
from test_torch_train import module_cosines, run_tiny_step
from unopose_tpu_torch.ops import assignment_fused as taf
from unopose_tpu_torch.ops.procrustes import weighted_procrustes
from unopose_tpu_torch.utils.convert import flax_to_torch

jaf = importlib.import_module("unopose_tpu.ops.assignment_fused")
jpr = importlib.import_module("unopose_tpu.ops.procrustes")


def procrustes64(src, ref, w, weight_thresh=0.001, eps=1e-5):
    """``weighted_procrustes`` in float64 by an SVD with the determinant fix:
    (R, t, the float64 centroids of src and ref)."""
    src, ref, w = (np.asarray(x, np.float64) for x in (src, ref, w))
    w = np.where(w < weight_thresh, 0.0, w)
    w = w / (w.sum(-1, keepdims=True) + eps)
    sc, rc = (src * w[..., None]).sum(-2), (ref * w[..., None]).sum(-2)
    H = np.einsum("bni,bnj->bij", src - sc[:, None], w[..., None] * (ref - rc[:, None]))
    U, _, Vt = np.linalg.svd(H)
    V, Ut = np.transpose(Vt, (0, 2, 1)), np.transpose(U, (0, 2, 1))
    fix = np.tile(np.eye(3), (len(H), 1, 1))
    fix[:, 2, 2] = np.sign(np.linalg.det(V @ Ut))
    R = V @ fix @ Ut
    return R, rc - np.einsum("bij,bj->bi", R, sc), sc, rc


def test_fused_solver_at_moved_seeds_is_the_procrustes_conditioning():
    """The tiny production slice, every seed moved by one (the slice's inputs,
    init keys and perturbation, the sampling key), the port's fused solver
    fed JAX's projections, scores and clouds: labels equal to JAX's kernel's,
    weights and soft targets within 1e-4 of their max, as at the file's
    seeds. The pose misses JAX's by 4.4e-5 rad and 1.8e-4 in the translation
    (over the file's gate), because the solve is ill conditioned (its
    smallest singular value ~5e-6) and the weights and targets differ by a
    few ulps:
    - on the same inputs (JAX's) each package's Procrustes is within float32
      rounding of a float64 Procrustes: the port no further from it than
      twice JAX's own distance plus 2e-6 (measured 9.7e-7 rad and 3.7e-6
      against JAX's 1.05e-6 and 4.1e-6);
    - the float64 Procrustes on the port's inputs and on JAX's are as far
      apart as the packages' poses, within 10% plus 5e-6 (measured 4.49e-5
      rad and 1.835e-4 against 4.45e-5 and 1.829e-4);
    - the port's translation is the float64 centroids of its own inputs
      moved by its own rotation, within 1e-5 (measured 1.4e-6): a rotation
      that far apart moves the centroid, ~5.9 radii out, by the gap."""
    _, _, oj, _, (feat1, feat2, score, pts1, pts2) = run_production_slice(shift=1, port=False)
    pj, wj, lj = (np.asarray(x) for x in jaf.fine_assignment_fused(
        *map(jnp.asarray, (feat1, feat2, score, pts2)), temp=0.1, interpret=True))
    pt, wt, lt = taf.fine_assignment_fused(*map(t, (feat1, feat2, score, pts2)), temp=0.1)
    np.testing.assert_array_equal(lt.numpy(), lj)
    assert max_abs(wj, wt) <= 1e-4 * np.abs(wj).max() and max_abs(pj, pt) <= 1e-4 * np.abs(pj).max()

    R64, t64, _, _ = procrustes64(pj, pts1, wj)
    Rj, tj = (np.asarray(x) for x in jpr.weighted_procrustes(*map(jnp.asarray, (pj, pts1, wj)), weight_thresh=0.001))
    Rp, tp = (x.numpy() for x in weighted_procrustes(t(pj), t(pts1), t(wj), weight_thresh=0.001))
    assert rot_err(Rp, R64) <= 2 * rot_err(Rj, R64) + 2e-6
    assert max_abs(tp, t64) <= 2 * max_abs(tj, t64) + 2e-6

    R, tr, _, _ = taf.compute_fine_Rt_overlap_fused(*map(t, (feat1, feat2, score, pts1, pts2)), temp=0.1)
    R, tr = R.numpy(), tr.numpy()
    Rp64, tp64, sc, rc = procrustes64(pt.numpy(), pts1, wt.numpy())
    tm = oj["pred_t"] / (oj["radius"][:, None] + 1e-6)
    gap_R, gap64_R = rot_err(oj["pred_R"], R), rot_err(R64, Rp64)
    gap_t, gap64_t = max_abs(tm, tr), max_abs(t64, tp64)
    assert abs(gap_R - gap64_R) <= 0.1 * gap64_R + 5e-6, (gap_R, gap64_R)
    assert abs(gap_t - gap64_t) <= 0.1 * gap64_t + 5e-6, (gap_t, gap64_t)
    assert max_abs(tr, rc - np.einsum("bij,bj->bi", R, sc)) <= 1e-5


def test_tiny_train_step_on_jax_pe_channels_at_moved_seeds():
    """The tiny train step with every seed moved by two, the port's fine PE fed
    JAX's channels, as ``test_tiny_train_step_on_jax_pe_channels_matches_jax``
    does at the file's seeds: every call saw JAX's neighbourhoods (at least
    95% of the rows alike). The fine matcher's gradient is 1 - 2.5e-4 from
    JAX's, over that test's fixed 1e-4: at these seeds JAX's own step is that
    sensitive. The yardstick is JAX's spread with the channels held, the
    largest change of JAX's step when the query cloud moves one ulp up or
    down and its fine PE is fed the channels of its first run: one minus
    each top-level module's gradient cosine within three times that spread
    plus 1e-6 (measured: the fine matcher's spread 4.9e-4, the gap 0.17 of
    the gate), and every metric within three times its spread plus 1e-5
    relative, the accuracies and foreground counts plus 1% of the rows, as
    in ``test_tiny_train_step_matches_jax`` (measured: the largest share of
    a gate 0.27, the gradient norm's). The fine PE's
    BatchNorm running statistics come from the held channels alone (JAX's
    spread is none there) and stay within the file's 1e-5 of each buffer's
    max."""
    run = run_tiny_step(shift=2, spreads=False)
    assert len(run["rows_alike"]) == 4 and min(run["rows_alike"]) >= 0.95, run["rows_alike"]
    (state_j, jm), *held = run["runs"]
    pm, pg, _, after = run["port_on_jax_channels"]
    assert sorted(pm) == sorted(jm) and len(held) == 2
    for k in jm:
        spread = max(abs(m[k] - jm[k]) for _, m in held)
        rows = 0.01 * (1.0 if k.endswith("_acc") else max(abs(jm[k]), 1.0) if k.endswith("_fg_num") else 0.0)
        assert abs(pm[k] - jm[k]) <= 3 * spread + 1e-5 * max(abs(jm[k]), 1.0) + rows, (k, pm[k], jm[k], spread)
    jg, *ng = ({k: v.numpy() for k, v in flax_to_torch({"params": g}).items()} for g in run["grads"])
    pg = {k: v.numpy() for k, v in pg.items()}
    for m, c in module_cosines(pg, jg).items():
        spread = max(1 - module_cosines(g, jg)[m] for g in ng)
        assert 1 - c <= 3 * spread + 1e-6, (m, c, spread)
    new_j = flax_to_torch({"params": state_j.params, "batch_stats": state_j.batch_stats})
    bn_keys = [k for k in after if ".pe." in k and (k.endswith(".mean") or k.endswith(".var"))]
    assert len(bn_keys) == 12
    for k in bn_keys:
        assert (after[k] - new_j[k]).abs().max().item() <= 1e-5 * new_j[k].abs().max().item(), k
