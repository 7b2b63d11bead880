"""The evaluation entry point's model pieces, PyTorch port against the JAX
package (CPU, float32): the geometry ops, the ``deconv`` upscaler, the fine
solvers' ``model_pts``, and ``encode_template`` and the forward on its
cached inputs (the two other modes and ``eval_config``:
``test_torch_eval_modes.py``).

The model tests run the tiny slice config of ``test_torch_models.py`` on its
perturbed weights and inputs, the JAX model on the draws captured at its
``jax.random.uniform`` and the port on the same draws (``uniforms``). As in
``test_torch_slice.py``, ulp-level differences upstream reach the PE's
ill-conditioned frames, so the gates are the deterministic taps, the fine
scores' distribution and the port's own cached-versus-uncached agreement;
each test states its tolerance.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import B, NPTS, max_abs, t, tiny_models
from test_torch_slice import rot_err
from unopose_tpu_torch.configs import TINY_SIZES, slice_config
from unopose_tpu_torch.ops import assignment_fused as taf
from unopose_tpu_torch.ops import geometry as tgeo
from unopose_tpu_torch.ops import solver as tsol
from unopose_tpu_torch.utils.convert import load_flax_variables

jgeo = importlib.import_module("unopose_tpu.ops.geometry")
jsol = importlib.import_module("unopose_tpu.ops.solver")
jaf = importlib.import_module("unopose_tpu.ops.assignment_fused")
CACHE_KEYS = ("dense_po", "dense_fo", "dense_po_lrf", "tem1_radius")


# ------------------------------------------------------------------ geometry, upscaler, solvers
def test_geometry_ops_match_jax():
    """backproject, transform_pts and inverse_transform_pts on seeded inputs:
    within 1e-6 relative (float32 products, one rounding each)."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 1.5, size=(6, 8)).astype(np.float32)
    K = np.array([[572.4, 0, 3.5], [0, 573.6, 2.5], [0, 0, 1]], np.float32)
    got, want = tgeo.backproject(t(depth), t(K)), jgeo.backproject(jnp.asarray(depth), jnp.asarray(K))
    assert got.shape == want.shape == (6, 8, 3)
    assert max_abs(want, got) <= 1e-6 * np.abs(np.asarray(want)).max()
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3, 3)))[0].astype(np.float32)
    tr = rng.normal(size=(3, 3)).astype(np.float32)
    for tf, jf in ((tgeo.transform_pts, jgeo.transform_pts), (tgeo.inverse_transform_pts, jgeo.inverse_transform_pts)):
        want = jf(*map(jnp.asarray, (pts, R, tr)))
        assert max_abs(want, tf(t(pts), t(R), t(tr))) <= 1e-6 * np.abs(np.asarray(want)).max()
    back = tgeo.inverse_transform_pts(tgeo.transform_pts(t(pts), t(R), t(tr)), t(R), t(tr))
    assert max_abs(pts, back) < 1e-5


def test_deconv_upscaler_matches_jax():
    """The ``deconv`` upscaler (two 2x2 stride-2 transposed convolutions,
    float32 LayerNorm, exact GELU) on the tiny ViT, converted from seeded
    flax variables: the same (B, 4g, 4g, out) map (flax's SAME padding at
    stride 2 is torch's output size), within 1e-5 of its max in float32
    (measured 2.4e-6 of 3.6), its kernel taps flipped in both spatial
    axes. In bfloat16 the port's map stays within 2^-5 of its max of the
    float32 one (a few bf16 roundings of the ViT and the two products;
    measured 0.031 of 3.6)."""
    from unopose_tpu.models.feature_extraction import ViTAE as JaxViTAE
    from unopose_tpu_torch.models.feature_extraction import ViTAE

    x = np.random.default_rng(3).uniform(-1, 1, (B, 28, 28, 3)).astype(np.float32)
    jm = JaxViTAE(vit_type="vit_tiny_test", up_type="deconv", embed_dim=32, out_dim=32, img_size=28,
                  fused_attn=False)
    # seeded values in the init's shapes (no init run): LayerNorm scales near 1, every other leaf N(0, 0.2)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v, upsample=False), jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0)
                         + 0.2 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    want = np.asarray(jax.jit(lambda v, i: jm.apply(v, i, upsample=False)[0])(variables, jnp.asarray(x)))
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        tm = ViTAE("vit_tiny_test", "deconv", 32, 32, True, 28, dtype)
        load_flax_variables(tm, variables)
        with torch.no_grad():
            got[dtype] = tm(t(x)).float().numpy()
    assert sorted(k for k in tm.state_dict() if "deconv" in k or k.startswith("ln.")) == [
        "deconv1.bias", "deconv1.weight", "deconv2.bias", "deconv2.weight", "ln.bias", "ln.weight"]
    k1 = variables["params"]["deconv1"]["kernel"]
    np.testing.assert_array_equal(tm.deconv1.weight.detach().numpy()[:, :, 0, 1], np.asarray(k1)[1, 0])
    assert got[torch.float32].shape == want.shape == (B, 8, 8, 32)
    assert max_abs(want, got[torch.float32]) <= 1e-5 * np.abs(want).max()
    assert max_abs(want, got[torch.bfloat16]) <= 2 ** -5 * np.abs(want).max()


def _solver_case(rng, n=64):
    """A soft match of two clouds (pts1 = R pts2 + t plus noise) with peaked
    similarities, and a model cloud that differs from pts2."""
    pts2 = rng.uniform(-1, 1, size=(B, n, 3)).astype(np.float32)
    R = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0]
    R *= np.linalg.det(R)[:, None, None]
    pts1 = (np.einsum("bij,bnj->bni", R, pts2) + 0.1 + rng.normal(size=pts2.shape) * 0.01).astype(np.float32)
    atten = (rng.normal(size=(B, n + 1, n + 1)) + 30.0 * np.pad(np.eye(n), ((1, 0), (1, 0)))[None]).astype(np.float32)
    score = rng.uniform(0.3, 1.0, size=(B, 2 * n)).astype(np.float32)
    model_pts = (pts2[:, ::2] + rng.normal(size=(B, n // 2, 3)) * 0.2).astype(np.float32)
    return atten, score, pts1, pts2, model_pts


def test_fine_solvers_take_model_pts():
    """Both fine solvers with ``model_pts``: the materialised one against
    JAX's (rotation 1e-4 rad, the rest 1e-5, as ``test_torch_ops``), the
    fused one against JAX's in interpret mode on ``assignment_case``'s
    features (same gates; pose score 1e-5); ``None`` is ``pts2``, and
    another model cloud moves the pose score as in JAX."""
    from test_torch_production import assignment_case

    rng = np.random.default_rng(11)
    atten, score, pts1, pts2, model_pts = _solver_case(rng)
    args = (atten, score, pts1, pts2, model_pts)
    out_j = jax.jit(functools.partial(jsol.compute_fine_Rt_overlap, return_aux=True))(*map(jnp.asarray, args))
    out_t = tsol.compute_fine_Rt_overlap(*map(t, args))
    assert rot_err(out_j[0], out_t[0]) < 1e-4
    for a, b in zip(out_j[1:], out_t[1:]):
        assert max_abs(a, b) < 1e-5
    same = tsol.compute_fine_Rt_overlap(*map(t, (atten, score, pts1, pts2)), t(pts2))
    base = tsol.compute_fine_Rt_overlap(*map(t, (atten, score, pts1, pts2)))
    moved = tsol.compute_fine_Rt_overlap(*map(t, (atten, score, pts1, pts2)), t(model_pts))
    assert all(torch.equal(a, b) for a, b in zip(same, base))
    assert not torch.equal(moved[2], base[2])

    f1, f2, sc, p2 = assignment_case(rng, B, 65, 32)
    p1 = (p2 + 0.05).astype(np.float32)
    mp = (p2[:, ::3] * 1.5).astype(np.float32)
    out_j = jax.jit(functools.partial(jaf.compute_fine_Rt_overlap_fused, temp=0.1, interpret=True))(
        *map(jnp.asarray, (f1, f2, sc, p1, p2, mp)))
    out_t = taf.compute_fine_Rt_overlap_fused(*map(t, (f1, f2, sc, p1, p2, mp)), temp=0.1)
    assert rot_err(out_j[0], out_t[0]) < 1e-4
    for a, b in zip(out_j[1:], out_t[1:]):
        assert max_abs(a, b) < 1e-5
    base = taf.compute_fine_Rt_overlap_fused(*map(t, (f1, f2, sc, p1, p2)), temp=0.1)
    same = taf.compute_fine_Rt_overlap_fused(*map(t, (f1, f2, sc, p1, p2, p2)), temp=0.1)
    assert all(torch.equal(a, b) for a, b in zip(same, base))
    assert not torch.equal(out_t[2], base[2])


# ------------------------------------------------------------------ the template cache
def jax_forward(jm, variables, inputs, key=5):
    """The JAX model's inference forward with every intermediate, and the
    coarse search's draws (None where it draws none)."""
    drawn = []
    real_uniform = jax.random.uniform

    def spy(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = real_uniform(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda x: drawn.append(np.array(x)), out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", spy)
    try:
        out = jax.jit(lambda v, i: jm.apply(v, i, train=False, rngs={"sample": jax.random.PRNGKey(key)},
                                            return_intermediates=True))(variables, inputs)
        out = jax.tree_util.tree_map(np.asarray, out)
        jax.effects_barrier()
    finally:
        mp.undo()
    return out, (drawn[0] if drawn else None)


@pytest.fixture(scope="module")
def cache_run():
    """JAX: encode_template and the forward on its outputs; the port: the
    same, and its forward on the crops, on JAX's draws."""
    cfg, inputs, jm, variables, tm = tiny_models()
    tem_j = jax.jit(lambda v, a, b, c: jm.apply(v, a, b, c, method=jm.encode_template))(
        variables, *(jnp.asarray(inputs[k]) for k in ("tem1_rgb", "tem1_choose", "tem1_pts")))
    tem_j = {k: np.asarray(v) for k, v in tem_j.items()}
    query = {k: inputs[k] for k in ("rgb", "rgb_choose", "pts")}
    out_j, uniforms = jax_forward(jm, variables, {**{k: jnp.asarray(v) for k, v in query.items()},
                                                  **{k: jnp.asarray(v) for k, v in tem_j.items()}})
    tem_t = tm.encode_template(*(t(inputs[k]) for k in ("tem1_rgb", "tem1_choose", "tem1_pts")))
    cached = tm({**{k: t(v) for k, v in query.items()}, **tem_t}, uniforms=t(uniforms), return_intermediates=True)
    plain = tm({k: t(v) for k, v in inputs.items()}, uniforms=t(uniforms), return_intermediates=True)
    return tem_j, tem_t, out_j, cached, plain, uniforms


def assert_coarse_search_matches(oj, uniforms):
    """The port's coarse search on JAX's coarse similarity, scores and nodes
    and JAX's draws against JAX's solver on the same (eager): rotation 1e-4
    rad, translation 1e-5 (``test_torch_slice``'s solver gates; the search
    is ill conditioned with random weights, and JAX's own in-jit pose
    differs from its eager one by ~3e-4 rad on these inputs)."""
    cm = slice_config(tiny=True).coarse_point_matching
    args = (oj["coarse_attens"][-1], oj["coarse_scores"][-1], oj["sparse_pm"], oj["sparse_po"])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(uniforms))
    try:
        Rj, tj, _ = jsol.compute_coarse_Rt_overlap(jax.random.PRNGKey(0), *map(jnp.asarray, args), None,
                                                   cm.nproposal1, cm.nproposal2)
    finally:
        mp.undo()
    R, tr, _ = tsol.compute_coarse_Rt_overlap(*map(t, args), cm.nproposal1, cm.nproposal2, uniforms=t(uniforms))
    assert rot_err(Rj, R) < 1e-4
    assert max_abs(tj, tr) < 1e-5


def global_lrf64(pts: np.ndarray) -> np.ndarray:
    """``ops/lrf.py:global_lrf`` in float64 numpy, its z axis by ``eigh``: the
    exact frame both packages' float32 versions approximate."""
    rel = pts.astype(np.float64) - pts.astype(np.float64).mean(axis=1, keepdims=True)
    r = np.linalg.norm(rel, axis=-1).max(axis=-1)
    out = []
    for b in range(len(rel)):
        z = np.linalg.eigh(rel[b].T @ rel[b] / len(rel[b]))[1][:, 0]
        proj = -rel[b] @ z
        z = -z if (proj > 1e-3).sum() - (proj < -1e-3).sum() < 0 else z
        norm = rel[b] @ z
        vi = rel[b] - norm[:, None] * z[None]
        w = (r[b] - np.linalg.norm(rel[b], axis=-1)) ** 2 * norm * norm
        x = (w[:, None] * vi).sum(0)
        x /= np.linalg.norm(x) + 1e-10
        out.append(rel[b] @ np.stack([x, np.cross(x, z), z]).T / r[b])
    return np.stack(out)


def test_encode_template_matches_jax(cache_run):
    """``encode_template``: the radius and the FPS subsample in meters within
    1e-6 relative (the FPS indices equal) and the subsample's features
    within 1e-4 (the ViT's taps). The LRF rows come from a 3x3 eigensolve
    and a weighted sum over the whole template, whose near-isotropic
    surface leaves the frame ill conditioned: they are gated against the
    float64 frame, at three times JAX's own distance from it plus 1e-5
    (``test_torch_ops``'s global LRF gate)."""
    tem_j, tem_t, _, _, _, _ = cache_run
    assert set(tem_t) == set(tem_j) == set(CACHE_KEYS)
    assert tem_t["dense_po"].shape == (B, NPTS, 3) and tem_t["dense_fo"].dtype == torch.float32
    for k in ("tem1_radius", "dense_po"):
        assert max_abs(tem_j[k], tem_t[k]) <= 1e-6 * np.abs(tem_j[k]).max(), k
    exact = global_lrf64(tiny_models()[1]["tem1_pts"])[:, :NPTS]
    assert max_abs(exact, tem_t["dense_po_lrf"]) <= 3 * max_abs(exact, tem_j["dense_po_lrf"]) + 1e-5
    assert max_abs(tem_j["dense_fo"], tem_t["dense_fo"]) < 1e-4


def test_cached_forward_matches_jax(cache_run):
    """The forward on the cached inputs, both packages on the same draws: the
    deterministic taps as ``test_torch_slice.test_slice_deterministic_taps``
    (clouds and radius relative 1e-6, coarse similarity relative 1e-3,
    coarse scores 1e-4), the port's coarse search on JAX's coarse tensors as
    its solver test (1e-4 rad, 1e-5), and the fine scores at the slice's
    fine-stage gates (median 5e-3, 95th percentile 5e-2)."""
    _, _, oj, ot, _, uniforms = cache_run
    for k in ("dense_pm", "dense_po", "sparse_pm", "sparse_po", "radius"):
        assert max_abs(oj[k], ot[k]) < 1e-6 * np.abs(oj[k]).max(), k
    atten = oj["coarse_attens"][-1]
    assert max_abs(atten, ot["coarse_atten"]) < 1e-3 * np.abs(atten).max()
    assert max_abs(oj["coarse_scores"][-1], ot["coarse_score"]) < 1e-4
    assert_coarse_search_matches(oj, uniforms)
    err = np.abs(ot["fine_score"].numpy() - oj["fine_scores"][-1])
    assert np.median(err) < 5e-3 and np.percentile(err, 95) < 5e-2


def test_cached_forward_matches_uncached(cache_run):
    """The port's forward on ``encode_template``'s outputs against its forward
    on the crops, same draws: the radius bitwise, the clouds bitwise (the
    gather and the division commute), and every pose output within 1e-4
    (JAX's own gate for its cache, ``tests/test_model.py``)."""
    _, _, _, cached, plain, _ = cache_run
    for k in ("radius", "dense_pm", "dense_po", "sparse_po", "fps_idx_o"):
        assert torch.equal(cached[k], plain[k]), k
    for k in ("pred_R", "pred_t", "pred_pose_score", "init_R", "init_t"):
        assert max_abs(plain[k], cached[k]) <= 1e-4, k


def test_cached_forward_radius_from_the_subsample():
    """Without ``tem1_radius`` the encoder takes the radius of the cached
    subsample, as JAX's (relative 1e-6)."""
    from unopose_tpu.models.feature_extraction import ViTEncoderOneRef as JaxEncoder

    cfg, inputs, jm, variables, tm = tiny_models()
    rng = np.random.default_rng(4)
    po = rng.normal(size=(B, NPTS, 3)).astype(np.float32)
    fo = rng.normal(size=(B, NPTS, 32)).astype(np.float32)
    args = (inputs["rgb"], inputs["rgb_choose"], inputs["pts"])
    je = JaxEncoder(npoint=NPTS, vit_type="vit_tiny_test", embed_dim=32, out_dim=32, img_size=TINY_SIZES["img"],
                    fused_attn=False)
    want = je.apply({"params": variables["params"]["encoder"]}, *map(jnp.asarray, args), dense_po=jnp.asarray(po),
                    dense_fo=jnp.asarray(fo))
    with torch.no_grad():
        got = tm.encoder(*map(t, args), dense_po=t(po), dense_fo=t(fo))
    for w, g in zip(want, got):
        assert max_abs(w, g) <= 1e-5 * max(np.abs(np.asarray(w)).max(), 1.0)
