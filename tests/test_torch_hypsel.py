"""The fused coarse hypothesis selection of the PyTorch port against the JAX
package (CPU): the plain twins of ``ops/hyp_select.py`` (the selection
kernel K17's two modes) against the JAX package's Pallas kernels in
interpret mode, and the coarse solver with its ``model_pts`` and
``selection_chunks`` arguments and under ``UNOPOSE_HYPSEL_V2=1`` against the
JAX solver on the same uniforms. Inputs are made with numpy from a seed.
Each test states its tolerance and why.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_ops import _matching, rot_err
from unopose_tpu_torch.kernels import LAUNCHES, build
from unopose_tpu_torch.ops import hyp_select as ths
from unopose_tpu_torch.ops import solver as tsol

jhs = importlib.import_module("unopose_tpu.ops.hyp_select")
jhs2 = importlib.import_module("unopose_tpu.ops.hyp_select2")
jsol = importlib.import_module("unopose_tpu.ops.solver")


def t(x):
    return torch.from_numpy(np.array(x))


def selection_inputs(seed=0, B=2, N1=196, N2=196, P2=300):
    """The JAX kernel tests' shapes and draws (``tests/test_solver.py``):
    clouds in a unit cube, rotations from normalised Gaussian quaternions,
    translations within 0.2, 70% inliers."""
    from unopose_tpu.ops.pose_utils import quat2mat

    rng = np.random.default_rng(seed)
    pts1 = rng.uniform(-0.5, 0.5, (B, N1, 3)).astype(np.float32)
    model = rng.uniform(-0.5, 0.5, (B, N2, 3)).astype(np.float32)
    q = rng.standard_normal((B, P2, 4))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    rs = np.asarray(quat2mat(jnp.asarray(q.astype(np.float32))))
    ts = rng.uniform(-0.2, 0.2, (B, P2, 3)).astype(np.float32)
    w1 = (rng.random((B, N1)) < 0.7).astype(np.float32)
    return pts1, model, rs, ts, w1


@pytest.mark.parametrize("row", [18, 19])
def test_hypsel_twin_matches_jax_kernel(row):
    """Each twin against its JAX kernel in interpret mode, B 2, N 196, P2
    300. Row 18's TP (bf16 operands, float32 sums) equals the JAX kernel's
    bit for bit; row 19 takes the float32 product on both sides. The JAX
    kernels form d^2 as |x|^2 - 2 x.y + |y|^2 with a bf16x3 cross term, the
    twins as the direct difference, so the scores differ by that expansion's
    rounding alone (measured max 3.2e-5 relative, median 4.8e-6): gated at
    2e-4 max and 2e-5 median, a hundred times tighter than the JAX test of
    row 18 against XLA (3e-3 median, 2e-2 max), and the same argmax."""
    inputs = selection_inputs()
    jfn, tfn = ((jhs.hypothesis_select_scores, ths.hypothesis_select_scores) if row == 18 else
                (jhs2.hypothesis_select_scores_v2, ths.hypothesis_select_scores_v2))
    want = np.asarray(jfn(*map(jnp.asarray, inputs), interpret=True))
    got = tfn(*map(t, inputs)).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 2e-4 and np.median(rel) < 2e-5, (rel.max(), np.median(rel))
    assert np.array_equal(got.argmax(1), want.argmax(1))
    if row == 18:
        pts1, _, rs, ts, _ = inputs
        a = (jnp.asarray(pts1)[:, None] - jnp.asarray(ts)[:, :, None, :]).astype(jnp.bfloat16)
        tp = jnp.matmul(a, jnp.asarray(rs).astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        assert np.array_equal(ths.transform_bf16(t(pts1), t(rs), t(ts)).numpy(), np.asarray(tp))


def test_hypsel_lane_order_sum():
    """The twins' weighted sum adds the rows in the kernel's order (lane r %
    32, rows in order per lane, then the xor butterfly): on rows whose sum
    rounds differently in another order it differs from ``torch.sum`` but
    equals a float64 sum within float32 reassociation (1e-6 relative), and
    on 0/1 rows (exact in any order) it equals the count."""
    rng = np.random.default_rng(1)
    x = t(rng.uniform(0, 1, size=(3, 5, 197)).astype(np.float32))
    got = ths._lane_sum(x)
    np.testing.assert_allclose(got.numpy(), x.double().sum(-1).numpy(), rtol=1e-6)
    ones = (x > 0.3).float()
    assert torch.equal(ths._lane_sum(ones), ones.sum(-1))


def test_hypsel_dispatch_and_refusal(monkeypatch):
    """CPU tensors take the plain twins without touching the kernel loader
    or counting a launch; the CUDA wrappers refuse CPU tensors."""
    inputs = tuple(map(t, selection_inputs(B=1, N1=40, N2=50, P2=9)))
    with pytest.raises(ValueError):
        ths.hypothesis_select_scores_cuda(*inputs)
    with pytest.raises(ValueError):
        ths.hypothesis_select_scores_v2_cuda(*inputs)

    def no_loader():
        raise AssertionError("the kernel loader was called for a CPU tensor")

    monkeypatch.setattr(build, "load", no_loader)
    before = dict(LAUNCHES)
    assert torch.equal(ths.hypothesis_select_scores(*inputs), ths.hypothesis_select_scores_plain(*inputs))
    assert torch.equal(ths.hypothesis_select_scores_v2(*inputs), ths.hypothesis_select_scores_v2_plain(*inputs))
    assert dict(LAUNCHES) == before


def _solver_case(seed, n_model):
    """A well-conditioned matching (``test_torch_ops._matching``), 196 points
    a cloud, and a model cloud of ``n_model`` points near the reference
    cloud (its points repeated with 2 mm noise), unlike ``pts2``."""
    rng = np.random.default_rng(seed)
    atten, score, pts1, pts2, R, tr = _matching(rng, 2, 196, sharp=12.0)
    model = np.take(pts2, rng.integers(0, 196, size=n_model), axis=1)
    model = (model + rng.normal(size=model.shape) * 2e-3).astype(np.float32)
    return atten, score, pts1, pts2, model, R


def _jax_solver(monkeypatch, uniforms, args, model, n1, n2):
    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(uniforms))
        return jsol.compute_coarse_Rt_overlap(jax.random.PRNGKey(0), *map(jnp.asarray, args), jnp.asarray(model),
                                              n1, n2)


def test_coarse_solver_model_pts_and_chunks_match_jax(monkeypatch):
    """A ``model_pts`` of 2600 points unlike ``pts2``, so that B P2 N1 M =
    3.06e8 passes the 3e8 threshold and both solvers split the 300
    hypotheses into ``selection_chunks`` = 10 (the port's ten chunked
    distance passes counted): the JAX pose within 1e-4 rad and 1e-5, the
    score within 1e-4 relative (the expansion-form d^2 of both packages,
    the existing solver test's gates); and the same pose and score, bit for
    bit, with the chunking off."""
    atten, score, pts1, pts2, model, R = _solver_case(2, 2600)
    uniforms = np.random.default_rng(3).uniform(size=(2, 3 * 400)).astype(np.float32)
    Rj, tj, sj = _jax_solver(monkeypatch, uniforms, (atten, score, pts1, pts2), model, 400, 300)
    calls = []
    own = tsol.pairwise_sqdist
    monkeypatch.setattr(tsol, "pairwise_sqdist", lambda x, y: calls.append(x.shape[1]) or own(x, y))
    args = tuple(map(t, (atten, score, pts1, pts2)))
    Rt, tt, st = tsol.compute_coarse_Rt_overlap(*args, 400, 300, uniforms=t(uniforms), model_pts=t(model))
    assert calls == [30] * 10
    assert rot_err(Rj, Rt) < 1e-4
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4)
    whole = tsol.compute_coarse_Rt_overlap(*args, 400, 300, uniforms=t(uniforms), model_pts=t(model),
                                           selection_chunks=1)
    assert calls[10:] == [300]
    assert all(torch.equal(a, b) for a, b in zip((Rt, tt, st), whole))
    assert rot_err(R, Rt) < 0.05


def test_coarse_solver_hypsel_v2_on_cpu_matches_jax(monkeypatch):
    """``UNOPOSE_HYPSEL_V2=1`` routes the selection through the kernel only
    on a CUDA tensor (where the JAX package needs the TPU): on the CPU the
    port takes the plain selection and matches JAX's XLA selection, both
    with the switch set, on the same uniforms and a ``model_pts`` unlike
    ``pts2``: pose within 1e-4 rad and 1e-5, score within 1e-4 relative; and
    the fused twin scores the chosen pose as the plain selection does,
    within 1e-4 relative (the expansion form's rounding)."""
    atten, score, pts1, pts2, model, _ = _solver_case(4, 300)
    uniforms = np.random.default_rng(5).uniform(size=(2, 3 * 600)).astype(np.float32)
    monkeypatch.setenv("UNOPOSE_HYPSEL_V2", "1")
    Rj, tj, sj = _jax_solver(monkeypatch, uniforms, (atten, score, pts1, pts2), model, 600, 300)
    before = dict(LAUNCHES)
    Rt, tt, st = tsol.compute_coarse_Rt_overlap(*map(t, (atten, score, pts1, pts2)), 600, 300, uniforms=t(uniforms),
                                                model_pts=t(model))
    assert dict(LAUNCHES) == before
    assert rot_err(Rj, Rt) < 1e-4
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4)
    # the fused twin's score of the chosen pose
    fused = ths.hypothesis_select_scores_v2_plain(t(pts1), t(model), Rt[:, None], tt[:, None], t(_w1(atten, score)))
    np.testing.assert_allclose(fused[:, 0].numpy(), st.numpy(), rtol=1e-4)


def _w1(atten, score):
    """The solver's inlier weights of the matching."""
    n1 = atten.shape[1] - 1
    return tsol.dual_softmax_assignment(t(atten), t(score), n1, atten.shape[2] - 1)[1].numpy()
