"""The production configuration of the PyTorch port against the JAX package (CPU).

``configs.production_config()`` is ``get_cfg()``'s model section with no
switch: the ViT runs the fused attention with the W8A8 ``DenseQ`` GEMMs and
tanh-GELU, and the fine solver the fused assignment. Here the port's plain
twins (``ops/vit_attn.py:mha_fused_plain``,
``ops/assignment_fused.py:fine_assignment_fused_plain``) run against the JAX
package's Pallas kernels in interpret mode, as its own tests run them. The
JAX ViT turns those modes on only for TPU inference, so the tests force
``fused_attn=True`` and hand ``mha_fused`` ``interpret=True`` by replacing
``unopose_tpu.ops.vit_attn.mha_fused`` (``ViTBlock`` imports it when
called). Inputs are made with numpy from a seed and handed to both. Each
test states its tolerance and why.
"""

import functools
import importlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import B, max_abs, perturb, t, tiny_models
from test_torch_package import PORT, _assert_subset
from test_torch_slice import rot_err
from unopose_tpu_torch.configs import TINY_SIZES, production_config
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.models.vit import DenseQ, make_vit, quantize_rows
from unopose_tpu_torch.ops import assignment_fused as taf
from unopose_tpu_torch.ops.vit_attn import mha_fused_plain
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jva = importlib.import_module("unopose_tpu.ops.vit_attn")
jaf = importlib.import_module("unopose_tpu.ops.assignment_fused")
jvit = importlib.import_module("unopose_tpu.models.vit")


def as_np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.fixture
def interpret_mha(monkeypatch):
    """The JAX ViT's fused attention in interpret mode."""
    monkeypatch.setattr(jva, "mha_fused", functools.partial(jva.mha_fused, interpret=True))


def bf16_ulp(x):
    """One bf16 step at |x| (float32 array): 2^(e - 8) for |x| in [2^(e-1), 2^e)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


# ------------------------------------------------------------------ the config
def jax_production_config(tiny: bool):
    from unopose_tpu.configs.main_cfg import get_cfg, get_tiny_cfg

    if tiny:
        ref = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=TINY_SIZES["npts"], coarse_npoint=16,
                           n_tem=TINY_SIZES["ntem"]).model
        ref.fine_point_matching.merge(dict(nsample1=64, nsample2=256))
    else:
        ref = get_cfg().model
    ref.use_ref_rad = False
    return ref


@pytest.mark.parametrize("tiny", [False, True])
def test_production_config_is_get_cfg_without_a_switch(tiny):
    """Every value of ``production_config`` equals ``get_cfg()`` (or the tests'
    ``get_tiny_cfg`` with the PE budgets 64/256), which sets none of
    ``fused_attn``, ``pe_fused`` and ``fused_assignment`` and carries
    ``int8_gemm=True``; every key the port's model reads is set; the model
    builds with the ViT's production mode and the fused assignment on."""
    ref = jax_production_config(tiny)
    assert ref.feature_extraction.int8_gemm is True
    assert "fused_attn" not in ref.feature_extraction and "fused_assignment" not in ref
    assert "pe_fused" not in ref.fine_point_matching
    ours = production_config(tiny)
    _assert_subset(ours, ref)
    read = re.findall(r"\b(fe|ge|cm|fm)\.get\(\"(\w+)\"", (PORT / "models" / "unopose.py").read_text())
    sections = dict(fe="feature_extraction", ge="geo_embedding", cm="coarse_point_matching", fm="fine_point_matching")
    missing = {(sections[s], k) for s, k in read if k in ref[sections[s]] and k not in ours[sections[s]]}
    assert not missing, missing
    model = UNOPose.from_config(production_config(tiny=True))
    blk = model.encoder.rgb_net.vit.blocks0[0]
    assert model.fused_assignment and model.fine_matching.pe.fused
    assert blk.fused_attn and blk.qkv.int8 and blk.mlp.fc2.int8 and blk.mlp.approximate == "tanh"


# ------------------------------------------------------------------ K7: mha_fused
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_fused_plain_matches_jax(dtype):
    """Plain twin vs ``mha_fused(interpret=True)`` at the ViT-B width (2, 261,
    768), 12 heads: float32 within 1e-5 of the output's max (float32
    reassociation). bf16: both round p / l and the output to bf16 at the same
    points and differ only in the float32 summation order, so at least 99.9%
    of the outputs are bitwise equal (measured 99.95%), and a p that rounds
    the other way moves an output by less than one bf16 ulp of its row's
    largest output. Not of the output itself: where the weighted sum cancels
    to a small value, that step is many of its own ulps (measured: at most
    46, at 1.2e-3)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 261, 768)).astype(np.float32) for _ in range(3))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = as_np(jva.mha_fused(*(jnp.asarray(x, jdt) for x in (q, k, v)), 12, interpret=True))
    got = mha_fused_plain(*(t(x).to(tdt) for x in (q, k, v)), 12)
    assert got.dtype == tdt and got.shape == (2, 261, 768)
    got = got.float().numpy()
    if dtype == "float32":
        assert max_abs(want, got) <= 1e-5 * np.abs(want).max()
    else:
        assert (got == want).mean() >= 0.999
        assert (np.abs(got - want) <= bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))).all()


# ------------------------------------------------------------------ DenseQ
@pytest.mark.parametrize("k_in,n_out", [(768, 2304), (3072, 768)])
def test_denseq_matches_jax(monkeypatch, k_in, n_out):
    """W8A8 ``DenseQ`` at the ViT-B widths (qkv 768 -> 2304, fc2 3072 -> 768)
    on the same weights: the activation and weight int8 codes equal the JAX
    package's (captured at its int8 ``dot_general``), and the float32 outputs
    agree within 1e-6 of their max (the int32 product is exact; what remains
    is float32 rounding of the rescale)."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 261, k_in)) * rng.uniform(0.2, 3.0, size=(2, 261, 1))).astype(np.float32)
    jm = jvit.DenseQ(n_out, dtype=jnp.float32, int8=True)
    variables = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    captured = []
    real = jax.lax.dot_general

    def spy(a, b, *args, **kwargs):
        captured.append((np.asarray(a), np.asarray(b)))
        return real(a, b, *args, **kwargs)

    monkeypatch.setattr(jax.lax, "dot_general", spy)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    monkeypatch.undo()
    (xq_j, wq_j), = captured
    tm = DenseQ(k_in, n_out, torch.float32, int8=True)
    load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(t(x)).numpy()
        xq_t, _ = quantize_rows(t(x))
        wq_t, _ = tm.quantized_weight()
    np.testing.assert_array_equal(xq_t.numpy(), xq_j)
    np.testing.assert_array_equal(wq_t.numpy(), wq_j)
    assert max_abs(want, got) <= 1e-6 * np.abs(want).max()


def test_denseq_codes_are_cached_per_weight_set():
    """The weight codes are made once; an in-place change of the weight or a
    move with ``.to()`` makes them anew; the leaves are Dense's."""
    dq = DenseQ(32, 16, torch.float32, int8=True)
    assert set(dq.state_dict()) == {"weight", "bias"}
    first = dq.quantized_weight()
    assert dq.quantized_weight() is first
    with torch.no_grad():
        dq.weight.mul_(2.0)
    assert dq.quantized_weight() is not first
    dq.to(torch.float64)
    assert dq._quant is None


# ------------------------------------------------------------------ the production ViT
def test_production_vit_matches_jax(interpret_mha):
    """The tiny ViT with ``fused_attn`` and ``int8_gemm`` (fused attention,
    W8A8 GEMMs, tanh-GELU) on the tiny slice's perturbed weights, against the
    JAX ViT forced into the same mode: the four pyramid taps within 1e-3 of
    each tap's max. A float32 difference upstream of a ``round`` flips an
    int8 code by one step (1/127 of the token's max) on a few entries, which
    moves the next GEMM's output by up to ~1e-4 of its scale per flip
    (measured: 1.5e-4 at most over the four taps)."""
    _, inputs, _, variables, _ = tiny_models()
    vit_vars = {"params": variables["params"]["encoder"]["rgb_net"]["vit"]}
    x = np.concatenate([inputs["rgb"], inputs["tem1_rgb"]], 0)
    jv = jvit.make_vit("vit_tiny_test", img_size=TINY_SIZES["img"], dtype=jnp.float32, fused_attn=True,
                       int8_gemm=True)
    want, _ = jv.apply(vit_vars, jnp.asarray(x))
    tv = make_vit("vit_tiny_test", img_size=TINY_SIZES["img"], dtype=torch.float32, fused_attn=True, int8_gemm=True)
    load_flax_variables(tv, vit_vars)
    with torch.no_grad():
        got, _ = tv(t(x))
    for w, g in zip(want, got):
        assert w.shape == tuple(g.shape)
        assert max_abs(w, g) <= 1e-3 * np.abs(np.asarray(w)).max()


# ------------------------------------------------------------------ K8-K10: the fused assignment
def assignment_case(rng, batch: int, m: int, c: int):
    """Projected features of a synthetic match (bg token first): three
    quarters of the query rows are a reference row's feature plus noise, the
    rest random, so the soft assignment has peaked and flat rows; overlap
    scores in (0, 1); a reference cloud (B, m - 1, 3)."""
    f2 = rng.normal(size=(batch, m, c)).astype(np.float32)
    f1 = rng.normal(size=(batch, m, c)).astype(np.float32)
    match = rng.permutation(m)[: 3 * m // 4]
    f1[:, : len(match)] = f2[:, match] + 0.5 * rng.normal(size=(batch, len(match), c))
    score = rng.uniform(0.0, 1.0, size=(batch, 2 * (m - 1))).astype(np.float32)
    pts2 = rng.uniform(-1.0, 1.0, size=(batch, m - 1, 3)).astype(np.float32)
    return f1, f2, score, pts2


@pytest.mark.parametrize("batch,m,c", [(2, 300, 32), (1, 2049, 256)])
def test_fine_assignment_fused_plain_matches_jax(batch, m, c):
    """Plain twin vs ``fine_assignment_fused(interpret=True)``: at M = 300, C =
    32 (neither a multiple of the TPU's 256-row or 128-column tiles, so its
    pads are exercised) and at one full-width pair, M = 2049, C = 256. Labels
    equal; weights and soft targets within 1e-4 of their max on the rows
    whose labels agree (float32 sums in another order; the TPU kernel keeps
    online column statistics over 256-row tiles, the twin takes them whole)."""
    f1, f2, score, pts2 = assignment_case(np.random.default_rng(2), batch, m, c)
    pj, wj, lj = (np.asarray(x) for x in jaf.fine_assignment_fused(
        *map(jnp.asarray, (f1, f2, score, pts2)), temp=0.1, interpret=True))
    pt, wt, lt = (x.numpy() for x in taf.fine_assignment_fused(*map(t, (f1, f2, score, pts2)), temp=0.1))
    assert pt.shape == pj.shape == (batch, m - 1, 3) and lt.dtype == np.int32
    np.testing.assert_array_equal(lt, lj)
    assert (lj > 0).mean() > 0.2  # foreground rows carry weight
    assert max_abs(wj, wt) <= 1e-4 * np.abs(wj).max()
    assert max_abs(pj, pt) <= 1e-4 * np.abs(pj).max()


def test_fine_assignment_stages_match_the_materialised_solver():
    """The three plain stages compose to the materialised fine solver's
    quantities (``ops/solver.py:compute_fine_Rt_overlap`` on the bf16-operand
    logits): same labels, row weights within 1e-5 of their max, and the
    fused solve's pose equal to the materialised one within 1e-5 rad."""
    from unopose_tpu_torch.ops.solver import compute_fine_Rt_overlap

    f1, f2, score, pts2 = assignment_case(np.random.default_rng(3), 2, 300, 32)
    pts1 = np.random.default_rng(4).uniform(-1.0, 1.0, size=(2, 299, 3)).astype(np.float32)
    f1n, f2n, _, _ = taf.operands(t(f1), t(f2), t(score), 0.1)
    atten = torch.matmul(f1n.float(), f2n.float().transpose(1, 2))
    R, tr, s, w = compute_fine_Rt_overlap(atten, t(score), t(pts1), t(pts2))
    Rf, tf, sf, wf = taf.compute_fine_Rt_overlap_fused(t(f1), t(f2), t(score), t(pts1), t(pts2), temp=0.1)
    assert rot_err(R, Rf) < 1e-5 and max_abs(tr, tf) < 1e-5
    assert max_abs(s, sf) < 1e-6 and max_abs(w, wf) <= 1e-5 * float(w.abs().max())


# ------------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def production_slice():
    return run_production_slice()


def run_production_slice(shift: int = 0, port: bool = True):
    """The tiny production config in float32 in both packages on the tiny
    slice's perturbed weights (the production tree has the same leaves), the
    JAX model forced into its TPU-inference modes with every kernel in
    interpret mode; the JAX draws and the fused solver's inputs captured and
    the draws injected into the port. ``shift`` moves every seed (the
    slice's and the sampling key's); with ``port=False`` only JAX runs (the
    model and its outputs are then None)."""
    from unopose_tpu.models import UNOPose as JaxUNOPose

    _, inputs, _, variables, _ = tiny_models(shift)
    jcfg = production_config(tiny=True)
    jcfg.feature_extraction.fused_attn = True
    jcfg.fine_point_matching.pe_fused = True
    jcfg.fused_assignment = True
    jcfg.geo_embedding.fused_interpret = True
    jm = JaxUNOPose.from_config(jcfg, dtype=jnp.float32, backbone_dtype=jnp.float32)
    tm = UNOPose.from_config(production_config(tiny=True), dtype=torch.float32, backbone_dtype=torch.float32).eval()

    drawn, solver_in = [], []
    real_uniform, real_solve = jax.random.uniform, jaf.compute_fine_Rt_overlap_fused

    def spy_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = real_uniform(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda x: drawn.append(np.array(x)), out)
        return out

    def spy_solve(feat1, feat2, score, pts1, pts2, model_pts=None, **kwargs):
        jax.debug.callback(lambda *xs: solver_in.append([np.array(x) for x in xs]), feat1, feat2, score, pts1, pts2)
        return real_solve(feat1, feat2, score, pts1, pts2, model_pts, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", spy_uniform)
    mp.setattr(jaf, "compute_fine_Rt_overlap_fused", spy_solve)
    mp.setattr(jva, "mha_fused", functools.partial(jva.mha_fused, interpret=True))
    try:
        out_j = jax.jit(
            lambda v, i: jm.apply(v, i, train=False, rngs={"sample": jax.random.PRNGKey(5 + shift)},
                                  return_intermediates=True)
        )(variables, {k: jnp.asarray(v) for k, v in inputs.items()})
        out_j = jax.tree_util.tree_map(np.asarray, out_j)
    finally:
        mp.undo()
    assert len(drawn) == 1 and len(solver_in) == 1
    if not port:
        return variables, None, out_j, None, solver_in[0]
    load_flax_variables(tm, variables)
    out_t = tm({k: t(v) for k, v in inputs.items()}, uniforms=t(drawn[0]), return_intermediates=True)
    return variables, tm, out_j, out_t, solver_in[0]


def test_production_slice_weights_convert(production_slice):
    """The converter maps every leaf of the tree onto the production model:
    ``DenseQ`` takes ``Dense``'s leaves."""
    variables, tm, _, _, _ = production_slice
    assert set(flax_to_torch(variables)) == set(tm.state_dict())


def test_production_slice_deterministic_taps(production_slice):
    """Clouds (relative 1e-6), coarse similarity (relative 1e-3) and coarse
    scores (1e-4), as for the other two configs: the W8A8 ViT's one-step code
    flips (``test_production_vit_matches_jax``) stay below these gates."""
    _, _, oj, ot, _ = production_slice
    for k in ("dense_pm", "dense_po", "sparse_pm", "sparse_po"):
        assert max_abs(oj[k], ot[k]) < 1e-6 * np.abs(oj[k]).max(), k
    atten = oj["coarse_attens"][-1]
    assert max_abs(atten, ot["coarse_atten"]) < 1e-3 * np.abs(atten).max()
    assert max_abs(oj["coarse_scores"][-1], ot["coarse_score"]) < 1e-4


def test_production_slice_fine_stage_given_coarse_pose(production_slice):
    """The port's fine stage fed the JAX coarse pose: fine scores gated as for
    the other configs, median 5e-3 and 95th percentile 5e-2 (the PE's
    ill-conditioned rows spread through the attention)."""
    _, tm, oj, ot, _ = production_slice
    with torch.no_grad():
        e, esc = ot["geo"]
        e = e.float()
        proj, score = tm.fine_matching(
            ot["dense_pm"], ot["dense_fm"], (e[:B], esc), ot["fps_idx_m"],
            ot["dense_po"], ot["dense_fo"], (e[B:], esc), ot["fps_idx_o"],
            t(oj["init_R"]), t(oj["init_t"]), return_proj=True,
        )
    assert proj[0].shape == (B, TINY_SIZES["npts"] + 1, 32) and proj[0].dtype == torch.float32
    err = np.abs(score.numpy() - oj["fine_scores"][-1])
    assert np.median(err) < 5e-3
    assert np.percentile(err, 95) < 5e-2


def test_production_slice_fused_solver_same_inputs(production_slice):
    """The port's fused solver fed JAX's own projections, fine scores and
    clouds: labels equal to the JAX kernel's, weights and soft targets within
    1e-4 of their max. With random weights the Procrustes is ill conditioned
    (row weights near its 0.001 threshold): one ulp on the features moves
    JAX's own pose by 1.5e-4 rad. So, as for the materialised solver
    (``test_torch_slice.py``), ``pred_R`` and ``pred_t`` are gated at three
    times JAX's own 1-ulp spread, and at least 1e-4 rad / 1e-5 (measured
    2.4e-4 rad against a spread of 1.5e-4, translation 1.07e-3 against
    6.7e-4); the pose score within 1e-5."""
    _, _, oj, _, (feat1, feat2, score, pts1, pts2) = production_slice
    pj, wj, lj = jaf.fine_assignment_fused(*map(jnp.asarray, (feat1, feat2, score, pts2)), temp=0.1, interpret=True)
    pt, wt, lt = taf.fine_assignment_fused(*map(t, (feat1, feat2, score, pts2)), temp=0.1)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert max_abs(wj, wt) <= 1e-4 * np.abs(np.asarray(wj)).max()
    assert max_abs(pj, pt) <= 1e-4 * np.abs(np.asarray(pj)).max()
    nudged = np.nextafter(feat1, np.float32(np.inf))
    Rn, tn, _, _ = jaf.compute_fine_Rt_overlap_fused(*map(jnp.asarray, (nudged, feat2, score, pts1, pts2)), temp=0.1,
                                                     interpret=True)
    R, tr, s, _ = taf.compute_fine_Rt_overlap_fused(*map(t, (feat1, feat2, score, pts1, pts2)), temp=0.1)
    radius = oj["radius"][:, None] + 1e-6
    tj = oj["pred_t"] / radius
    assert rot_err(oj["pred_R"], R) < max(1e-4, 3 * rot_err(oj["pred_R"], Rn))
    assert max_abs(tj, tr) < max(1e-5, 3 * max_abs(tj, np.asarray(tn)))
    assert max_abs(oj["pred_pose_score"], s) < 1e-5


def test_production_slice_outputs_are_poses(production_slice):
    _, _, _, ot, _ = production_slice
    R = ot["pred_R"].double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    assert torch.isfinite(R).all() and torch.isfinite(ot["pred_t"]).all()
    assert torch.isfinite(ot["pred_pose_score"]).all() and "fine_proj" in ot and "fine_atten" not in ot
    assert (R @ R.transpose(1, 2) - eye).abs().max() < 1e-4
    assert (torch.linalg.det(R) - 1).abs().max() < 1e-4
