"""The subset-mode and unpacked first_k fine PE of the PyTorch port against the
JAX package (CPU).

The subset grouping (``ops/ball_query.py:ball_group_subset``, kernel
``ball_group_subset``) and the masked PE (``ops/pe_fused.py:
pe_fused_masked``, kernel ``pe_masked``) run here as their plain PyTorch
twins; the JAX package runs its Pallas kernels (``ball_group_subset_pallas``,
``pe_fused``) in interpret mode and its XLA paths as they are. Inputs are
made with numpy from a seed and handed to both. The tiny subset tests use
512-point clouds, so that a slot has more than one candidate at the budgets
64/256 (G = 8 and 2). Each test states its tolerance and why.

This file holds the masked PE and the tiny subset model; the grouping, the
module in each mode and the configs are in ``test_torch_subset_pe.py``
(their own file, so that ``--dist loadfile`` spreads the two).
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import B, max_abs, surface, t, tiny_models
from unopose_tpu_torch.configs import (
    SUBSET_TINY_NPTS, TINY_SIZES, subset_config, surface_clouds,
)
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.ops import pe_fused as tpf
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jpf = importlib.import_module("unopose_tpu.ops.pe_fused")
tbq = importlib.import_module("unopose_tpu_torch.ops.ball_query")  # the package exports ball_query, the function
jeig = importlib.import_module("unopose_tpu.ops.eig3")
jva = importlib.import_module("unopose_tpu.ops.vit_attn")

MLP_SHAPES = ((6, 32), (32, 64), (64, 128))


def as_np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@functools.lru_cache(maxsize=None)
def anisotropic_cloud(n: int = 512):
    """(2, n, 3) points uniform in a flattened box, as the JAX package's own
    fused-PE test draws them: its neighbourhoods have a covariance eigengap."""
    rng = np.random.default_rng(11)
    return (rng.uniform(-1, 1, size=(2, n, 3)) * np.array([1.0, 0.75, 0.3])).astype(np.float32)


# ------------------------------------------------------------------ K15: the subset grouping


# ------------------------------------------------------------------ K16: the masked PE
def _mlps(seed=4):
    rng = np.random.default_rng(seed)
    return [([(rng.normal(size=s) * 0.3).astype(np.float32) for s in MLP_SHAPES],
             [(rng.normal(size=s[1]) * 0.1).astype(np.float32) for s in MLP_SHAPES]) for _ in range(2)]


def eigengap(pts, grouped, mask):
    """Per-row relative gap between the two smallest eigenvalues of the masked
    neighbourhood covariance (the LRF's z axis is well defined where it is
    large), as ``tests/test_model.py::test_fine_pe_fused_matches_xla``."""
    m = np.asarray(mask, np.float32)
    rx, ry, rz = (np.asarray(g) - pts[..., i][..., None] for i, g in enumerate(grouped))
    cnt = np.maximum(m.sum(-1), 1.0)
    mean = lambda v: (v * m).sum(-1) / cnt
    cov = np.zeros(rx.shape[:2] + (3, 3), np.float32)
    cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2] = mean(rx * rx), mean(ry * ry), mean(rz * rz)
    cov[..., 0, 1] = cov[..., 1, 0] = mean(rx * ry)
    cov[..., 0, 2] = cov[..., 2, 0] = mean(rx * rz)
    cov[..., 1, 2] = cov[..., 2, 1] = mean(ry * rz)
    lams = np.asarray(jeig.eigvals_sym3(jnp.asarray(cov)))
    return (lams[..., 1] - lams[..., 2]) / np.maximum(lams.sum(-1), 1e-12)


# (cloud, radii): a 512-point flattened box and four 512-point spheres (``configs.surface_clouds``)
MASKED_CASES = {"anisotropic": ("box", 0.25, 0.5), "surface": ("spheres", 0.1, 0.2)}


@pytest.mark.parametrize("case", sorted(MASKED_CASES))
def test_pe_fused_masked_plain_matches_jax(case):
    """The plain twin against ``pe_fused(interpret=True)`` on the same subset
    groupings, masks and folded weights (S1 64, S2 256). Where the two
    scales' neighbourhood covariances have an eigengap over 0.05 (the
    selection of ``tests/test_model.py::test_fine_pe_fused_matches_xla``,
    whose gates are 5e-2 there and 2e-2 for the median) the frames are well
    defined: every such row within 4.7e-2, three times the measured 1.56e-2
    (one bf16 ulp of the outputs' 2-4, from a hidden activation that rounds
    the other way; JAX's own one-ulp spread there is 7.8e-3 to 1.56e-2).
    Over all rows the median error under 1e-6 (measured 0: most rows are
    bitwise equal). Ill-conditioned rows may flip their frame."""
    kind, r1, r2 = MASKED_CASES[case]
    if kind == "box":
        pts = anisotropic_cloud()
    else:
        perm, _ = tbq.permutation(2048, "cpu")
        pts = surface_clouds(np.random.default_rng(5), 1, perm.numpy())
    g1, _, v1 = tbq.ball_group_subset_plain(r1, 64, t(pts))
    g2, _, v2 = tbq.ball_group_subset_plain(r2, 256, t(pts))
    center = tuple(t(pts[..., i]) for i in range(3))
    mlps = _mlps()
    jx = lambda xs: tuple(jnp.asarray(x.numpy()) for x in xs)
    want = np.asarray(jpf.pe_fused(jx(g1), jnp.asarray(v1.numpy()), jx(g2), jnp.asarray(v2.numpy()), jx(center),
                                   *[[jnp.asarray(x) for x in part] for mlp in mlps for part in mlp], r1, r2,
                                   interpret=True))
    torch_mlps = [([t(W) for W in Ws], [t(b) for b in bs]) for Ws, bs in mlps]
    got = tpf.pe_fused_masked_plain(g1, v1, g2, v2, center, *torch_mlps, r1, r2).numpy()
    assert got.shape == want.shape == pts.shape[:2] + (256,)
    err = np.abs(got - want).max(-1)
    well = (eigengap(pts, g1, v1) > 0.05) & (eigengap(pts, g2, v2) > 0.05)
    assert well.mean() > 0.3, well.mean()  # the comparison covers something
    assert err[well].max() < 4.7e-2, err[well].max()
    assert np.median(err) < 1e-6, np.median(err)


# ------------------------------------------------------------------ the tiny subset model end to end
def subset_inputs(seed=0):
    """512-point surface clouds (a query and a template of 768 points, 48 far
    points of which set its radius) plus random crops, built as
    ``test_torch_models.slice_inputs`` builds the 256-point ones."""
    rng = np.random.default_rng(seed)
    img, n = TINY_SIZES["img"], SUBSET_TINY_NPTS
    ntem = TINY_SIZES["ntem"] * n // TINY_SIZES["npts"]
    ctr = np.array([0.0, 0.0, 0.6])
    tem = surface(rng, ntem, ctr, 0.03)
    far = rng.normal(size=(B, ntem // 16, 3))
    tem[:, ::16] = ctr + 0.1 * far / np.linalg.norm(far, axis=-1, keepdims=True)
    d = dict(
        rgb=rng.uniform(-1, 1, size=(B, img, img, 3)),
        rgb_choose=rng.integers(0, img * img, size=(B, n)).astype(np.int32),
        pts=surface(rng, n, ctr + 0.005, 0.03),
        tem1_rgb=rng.uniform(-1, 1, size=(B, img, img, 3)),
        tem1_choose=rng.integers(0, img * img, size=(B, ntem)).astype(np.int32),
        tem1_pts=tem,
    )
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in d.items()}


@pytest.fixture(scope="module")
def subset_slice():
    """The tiny subset config in float32 in both packages on the tiny slice's
    perturbed weights (the tree does not depend on the PE's mode), the JAX
    model forced into its TPU-inference modes with every kernel in interpret
    mode; the JAX draws injected into the port."""
    from unopose_tpu.models import UNOPose as JaxUNOPose

    _, _, _, variables, _ = tiny_models()
    inputs = subset_inputs()
    jcfg = subset_config(tiny=True)
    jcfg.feature_extraction.fused_attn = True
    jcfg.fine_point_matching.pe_fused = True
    jcfg.fused_assignment = True
    jcfg.geo_embedding.fused_interpret = True
    jm = JaxUNOPose.from_config(jcfg, dtype=jnp.float32, backbone_dtype=jnp.float32)
    tm = UNOPose.from_config(subset_config(tiny=True), dtype=torch.float32, backbone_dtype=torch.float32).eval()
    drawn = []
    real_uniform = jax.random.uniform

    def spy_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = real_uniform(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda x: drawn.append(np.array(x)), out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", spy_uniform)
    mp.setattr(jva, "mha_fused", functools.partial(jva.mha_fused, interpret=True))
    try:
        out_j = jax.jit(
            lambda v, i: jm.apply(v, i, train=False, rngs={"sample": jax.random.PRNGKey(5)}, return_intermediates=True)
        )(variables, {k: jnp.asarray(v) for k, v in inputs.items()})
        out_j = jax.tree_util.tree_map(np.asarray, out_j)
    finally:
        mp.undo()
    assert len(drawn) == 1
    load_flax_variables(tm, variables)
    out_t = tm({k: t(v) for k, v in inputs.items()}, uniforms=t(drawn[0]), return_intermediates=True)
    return variables, tm, out_j, out_t


def test_subset_slice_weights_convert(subset_slice):
    variables, tm, _, _ = subset_slice
    assert set(flax_to_torch(variables)) == set(tm.state_dict())


def test_subset_slice_deterministic_taps(subset_slice):
    """Clouds (relative 1e-6), coarse similarity (relative 1e-3) and coarse
    scores (1e-4), as for the other configs (``tests/test_torch_slice.py``):
    the subset mode changes only the fine PE."""
    _, _, oj, ot = subset_slice
    for k in ("dense_pm", "dense_po", "sparse_pm", "sparse_po"):
        assert max_abs(oj[k], ot[k]) < 1e-6 * np.abs(oj[k]).max(), k
    assert ot["dense_pm"].shape == (B, SUBSET_TINY_NPTS, 3)
    atten = oj["coarse_attens"][-1]
    assert max_abs(atten, ot["coarse_atten"]) < 1e-3 * np.abs(atten).max()
    assert max_abs(oj["coarse_scores"][-1], ot["coarse_score"]) < 1e-4


def test_subset_slice_fine_stage_given_coarse_pose(subset_slice):
    """The port's fine stage (the subset grouping and masked PE twins) fed the
    JAX coarse pose: fine scores median error under 5e-3 and 95th percentile
    under 5e-2, the gates of the other configs (the PE's ill-conditioned rows
    spread through the attention; measured 1.6e-3 and 9.7e-3)."""
    _, tm, oj, ot = subset_slice
    with torch.no_grad():
        e, esc = ot["geo"]
        e = e.float()
        _, score = tm.fine_matching(
            ot["dense_pm"], ot["dense_fm"], (e[:B], esc), ot["fps_idx_m"],
            ot["dense_po"], ot["dense_fo"], (e[B:], esc), ot["fps_idx_o"],
            t(oj["init_R"]), t(oj["init_t"]), return_proj=True,
        )
    assert tm.fine_matching.pe.last_branch == "subset"
    err = np.abs(score.numpy() - oj["fine_scores"][-1])
    assert np.median(err) < 5e-3, np.median(err)
    assert np.percentile(err, 95) < 5e-2, np.percentile(err, 95)


def test_subset_slice_outputs_are_poses(subset_slice):
    _, _, _, ot = subset_slice
    R = ot["pred_R"].double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    assert torch.isfinite(R).all() and torch.isfinite(ot["pred_t"]).all()
    assert torch.isfinite(ot["pred_pose_score"]).all()
    assert (R @ R.transpose(1, 2) - eye).abs().max() < 1e-4
    assert (torch.linalg.det(R) - 1).abs().max() < 1e-4
