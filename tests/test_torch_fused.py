"""The fused matchers of the PyTorch port against the JAX package (CPU).

The fused geometric embedding (``ops/geo_fused.py``, kernel ``geo_rpe``)
and the fused PE-v5 (``ops/pe_fused.py``, kernels ``pe_channels`` and
``pe_mlp_pool``) run here as their plain PyTorch twins; the JAX package runs
its Pallas kernels in interpret mode. Inputs are made with numpy from a seed
and handed to both. Each test states its tolerance and why.

The fine PE's local frames are ill conditioned on some neighbourhoods: a
1-ulp change of the input moves JAX's own channels on ~1.5% of entries of
the mixed-tier cloud, so the channel and PE gates hold the port against
that spread, as ``test_torch_models.py`` does for the unfused PE.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import B, max_abs, perturb, t, tiny_models
from unopose_tpu.models.attention import RPEMultiHeadAttention as JaxRPE
from unopose_tpu.models.matching import FinePositionalEncoding as JaxPE
from unopose_tpu_torch.configs import TINY_SIZES, fused_matcher_config
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.models.attention import RPEMultiHeadAttention
from unopose_tpu_torch.models.embedding import knn_anchor_vectors
from unopose_tpu_torch.models.matching import FinePositionalEncoding
from unopose_tpu_torch.ops import eig3 as teig
from unopose_tpu_torch.ops import geo_fused as tgf
from unopose_tpu_torch.ops import pe_fused as tpf
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jbq = importlib.import_module("unopose_tpu.ops.ball_query")
tbq = importlib.import_module("unopose_tpu_torch.ops.ball_query")  # the package exports ball_query, the function
jeig = importlib.import_module("unopose_tpu.ops.eig3")
jgf = importlib.import_module("unopose_tpu.ops.geo_fused")
jpf = importlib.import_module("unopose_tpu.ops.pe_fused")

R1, R2 = 0.12, 0.24  # the JAX package's mixed-tier PE test radii
MLP_SHAPES = ((6, 32), (32, 64), (64, 128))


def as_np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


# ------------------------------------------------------------------ numeric pieces
def test_atan2_pos_sin_and_taylor_table_match_jax():
    """Branchless atan2 and the pre-projected table: 1e-6 relative (float32
    rounding of the same polynomial / the same float32 GEMM)."""
    rng = np.random.default_rng(0)
    s = np.abs(rng.normal(size=4096)).astype(np.float32)
    c = rng.normal(size=4096).astype(np.float32)
    s[:8] = 0.0  # exact zeros on either side of the quadrant tests
    want = np.asarray(jgf.atan2_pos_sin(jnp.asarray(s), jnp.asarray(c)))
    got = tgf.atan2_pos_sin(t(s), t(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, np.arctan2(s, c), atol=1e-6)  # and it is an atan2

    W = (rng.normal(size=(64, 48)) * 0.2).astype(np.float32)
    b = (rng.normal(size=48) * 0.1).astype(np.float32)
    x_max = float(2.1 * np.sqrt(3.0) / 0.2)
    tj, sj = jgf.build_taylor_table(jnp.asarray(W), jnp.asarray(b), x_max, 128)
    tt, st = tgf.build_taylor_table(t(W), t(b), x_max, 128)
    assert st == sj
    assert max_abs(tj, tt) <= 1e-6 * np.abs(np.asarray(tj)).max()


def test_newton_smallest_eigvec_matches_jax():
    """Acos-free smallest eigenvector on covariances with eigengaps of at
    least a third of the largest eigenvalue: 1e-6 (unit vectors; both run
    the same six Newton steps in float32, and the gaps keep the ulp-level
    differences of the two float32 evaluations from being amplified)."""
    rng = np.random.default_rng(1)
    n = 2048
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = rng.uniform(0.5, 2.0, size=(n, 1)) * (np.array([1.0, 0.6, 0.2]) + rng.uniform(0, 0.05, size=(n, 3)))
    A = np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)
    planar = [A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]]
    want = jeig.smallest_eigvec_sym3_planar(*map(jnp.asarray, planar), use_newton=True)
    got = teig.smallest_eigvec_sym3_planar(*map(t, planar), use_newton=True)
    for a, g in zip(want, got):
        assert max_abs(a, g) < 1e-6
    for a, g in zip(jeig.cos_phi_pair(jnp.asarray(planar[1]), use_newton=True),
                    teig.cos_phi_pair(t(planar[1]), use_newton=True)):
        assert max_abs(a, g) < 1e-6


# ------------------------------------------------------------------ K4: geo_rpe
@functools.lru_cache(maxsize=None)
def geo_case():
    """B = 2, N = 37 points near the unit sphere with the (1, 1, 1) bg point,
    D = 64, k = 3, T = 128: the JAX package's own geo_fused test case, with
    the tables built once in JAX and handed to both."""
    rng = np.random.default_rng(2)
    v = rng.normal(size=(2, 37, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (0.7 * v + rng.normal(size=(2, 37, 3)) * 0.02).astype(np.float32)
    pts[:, 0] = 1.0
    _, ref_vec = knn_anchor_vectors(t(pts), 3)
    D, sigma_d, sigma_a = 64, 0.2, 15.0
    factor_a = 180.0 / (sigma_a * np.pi)
    Wd, Wa = ((rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for _ in range(2))
    bd, ba = ((rng.normal(size=D) * 0.1).astype(np.float32) for _ in range(2))
    tab_d, scale_d = jgf.build_taylor_table(jnp.asarray(Wd), jnp.asarray(bd), float(2.1 * np.sqrt(3.0) / sigma_d), 128)
    tab_a, scale_a = jgf.build_taylor_table(jnp.asarray(Wa), jnp.asarray(ba), float(np.pi * factor_a), 128)
    return pts, ref_vec.numpy(), np.asarray(tab_d), np.asarray(tab_a), (scale_d, scale_a, sigma_d, factor_a)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_geo_rpe_fused_plain_matches_jax(mode):
    """Plain twin vs ``geo_rpe_fused(interpret=True)``: float32 output within
    1e-5 (float32 rounding of the same 3-term stencils); bf16 output within
    one bf16 ulp of the output (2^-7 relative at most) plus one bf16 step of
    the bf16 stencil weights (2^-8 of the channel's exact bound 1.25 (max|T_d|
    + max|T_a|): a 1-ulp change of a grid position can flip a weight's
    rounding); the production int8 output
    (bf16 contraction) equal but for one step on at most 0.1% of entries
    (float32 rounding at a .5 boundary), its scale within 1e-6 relative."""
    pts, ref_vec, tab_d, tab_a, consts = geo_case()
    out_j = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.bfloat16}[mode]
    out_t = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.bfloat16}[mode]
    quant = mode == "int8"
    want = jgf.geo_rpe_fused(*map(jnp.asarray, (pts, ref_vec, tab_d, tab_a)), *consts, out_dtype=out_j,
                             quantize=quant, interpret=True)
    got = tgf.geo_rpe_fused(*map(t, (pts, ref_vec, tab_d, tab_a)), *consts, out_dtype=out_t, quantize=quant)
    if quant:
        (e8j, scj), (e8t, sct) = want, got
        assert e8t.dtype == torch.int8 and e8t.shape == e8j.shape
        steps = np.abs(np.asarray(e8j, np.int32) - e8t.numpy().astype(np.int32))
        assert steps.max() <= 1 and (steps > 0).mean() <= 1e-3, ((steps > 0).mean(), steps.max())
        assert max_abs(scj, sct) <= 1e-6 * np.abs(np.asarray(scj)).max()
        return
    w = as_np(want)
    g = got.float().numpy()
    if mode == "float32":
        assert max_abs(w, g) < 1e-5
    else:
        bound = 1.25 * (np.abs(tab_d).max(0) + np.abs(tab_a).max(0))
        assert (np.abs(w - g) <= 2.0**-7 * np.abs(w) + 2.0**-8 * bound).all()


def test_geo_embedding_module_fused_int8_matches_jax():
    """``GeometricStructureEmbedding`` with ``fused_table=128, quant_int8``
    on converted weights (float32 model: float32 contraction), against the
    JAX module in interpret mode: same int8 codes but for one step on at most
    0.1% of entries, scales within 1e-6 relative."""
    from unopose_tpu.models.embedding import GeometricStructureEmbedding as JaxGeo
    from unopose_tpu_torch.models.embedding import GeometricStructureEmbedding

    pts = geo_case()[0]
    dmax = float(2.1 * np.sqrt(3.0) / 0.2)
    kw = dict(hidden_dim=64, sigma_d=0.2, sigma_a=15.0, angle_k=3, reduction_a="max", d_index_max=dmax)
    jge = JaxGeo(fused_table=128, quant_int8=True, fused_interpret=True, **kw)
    variables = perturb(jge.init(jax.random.PRNGKey(0), jnp.asarray(pts)))
    e8j, scj = jge.apply(variables, jnp.asarray(pts))
    tge = GeometricStructureEmbedding(fused_table=128, quant_int8=True, **kw)
    load_flax_variables(tge, variables)
    with torch.no_grad():
        e8t, sct = tge(t(pts))
    steps = np.abs(np.asarray(e8j, np.int32) - e8t.numpy().astype(np.int32))
    assert steps.max() <= 1 and (steps > 0).mean() <= 1e-3
    assert max_abs(scj, sct) <= 1e-6 * np.abs(np.asarray(scj)).max()


def test_rpe_attention_on_int8_embedding_matches_jax():
    """RPE attention handed the (codes, scale) pair: the scale folded into
    q-tilde, the codes read in the model dtype. float32, 1e-5 relative."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 17, 32)).astype(np.float32)
    e8 = rng.integers(-127, 128, size=(2, 17, 17, 32)).astype(np.int8)
    esc = rng.uniform(1e-3, 1e-2, size=32).astype(np.float32)
    jm = JaxRPE(32, 4)
    variables = perturb(jm.init(jax.random.PRNGKey(1), *(jnp.asarray(x),) * 3, (jnp.asarray(e8), jnp.asarray(esc))))
    want, _ = jm.apply(variables, *(jnp.asarray(x),) * 3, (jnp.asarray(e8), jnp.asarray(esc)))
    tm = RPEMultiHeadAttention(32, 4, torch.float32)
    load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(*(t(x),) * 3, (t(e8).float(), t(esc)))
    assert max_abs(want, got) < 1e-5 * np.abs(np.asarray(want)).max()


# ------------------------------------------------------------------ grouping, K5, K6
@functools.lru_cache(maxsize=None)
def mixed_tier_cloud():
    """The JAX package's PE-v5 test cloud (``tests/test_model.py``): a noisy
    0.5 shell of 352 points plus a dense 160-point ring, so 128-point blocks
    sit on both the 1-chunk and the 3+-chunk tiers."""
    rng = np.random.default_rng(0)
    N = 512
    v = rng.normal(size=(1, N, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    base = 0.5 * v + rng.normal(size=(1, N, 3)) * 2e-3
    th = np.linspace(0, 2 * np.pi, 160, endpoint=False)
    ring = np.stack([0.115 * np.cos(th), 0.115 * np.sin(th), np.zeros_like(th)], -1)
    base[:, :160] = np.array([2.0, 2.0, 2.0]) + ring + rng.normal(size=ring.shape) * 3e-3
    return base.astype(np.float32)


def test_two_scale_group_first_k_packed_idx_matches_jax():
    """The index grouping (no slot gather): every output equal to the JAX
    package's (permuted planes, slot indices, both weight sets, hit counts,
    overflow flag); the cloud has blocks on both tiers."""
    pts = mixed_tier_cloud()
    want = jbq.two_scale_group_first_k_packed_idx(R1, 64, R2, 256, jnp.asarray(pts))
    got = tbq.two_scale_group_first_k_packed_idx(R1, 64, R2, 256, t(pts))
    (jp, ji, jw1, jw2, jt2, jov), (tp, ti, tw1, tw2, tt2, tov) = want, got
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(as_np(a), b.numpy())
    np.testing.assert_array_equal(as_np(ji), ti.numpy())
    np.testing.assert_array_equal(as_np(jw1), tw1.float().numpy())
    np.testing.assert_array_equal(as_np(jw2), tw2.float().numpy())
    np.testing.assert_array_equal(as_np(jt2), tt2.numpy())
    assert bool(jov) == bool(tov) is False
    t2 = as_np(jt2).reshape(-1, 128).max(-1)
    assert (t2 > 128).any() and (t2 <= 64).any(), t2


def _folded_mlps(seed=4):
    rng = np.random.default_rng(seed)
    return [([(rng.normal(size=s) * 0.3).astype(np.float32) for s in MLP_SHAPES],
             [(rng.normal(size=s[1]) * 0.1).astype(np.float32) for s in MLP_SHAPES]) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def v5_case():
    """JAX PE-v5 (interpret) on the mixed-tier cloud and, for its own spread,
    on the same slots with every coordinate one ulp up. Returns the inputs and
    JAX's channels (B, P, S2, 12) and pooled rows for both."""
    pts = mixed_tier_cloud()
    planes, idx, w1, w2, t2, _ = jbq.two_scale_group_first_k_packed_idx(R1, 64, R2, 256, jnp.asarray(pts))
    center = tuple(jnp.asarray(pts[..., i]) for i in range(3))
    mlps = _folded_mlps()
    captured = []
    real = jpf.pl.pallas_call

    def spy(*args, **kwargs):  # record kernel A's channels on the way through
        call = real(*args, **kwargs)

        def run(*xs):
            out = call(*xs)
            captured.append(out)
            return out

        return run

    def run_v5(planes, center):
        captured.clear()
        mp = pytest.MonkeyPatch()
        mp.setattr(jpf.pl, "pallas_call", spy)
        try:
            pooled = jpf.pe_fused_v5(planes, idx, w1, w2, t2, center,
                                     *[[jnp.asarray(x) for x in part] for mlp in mlps for part in mlp],
                                     R1, R2, interpret=True)
        finally:
            mp.undo()
        return np.transpose(as_np(captured[0]), (0, 3, 2, 1)), np.asarray(pooled)

    up = lambda x: jnp.asarray(np.nextafter(np.asarray(x), np.float32(np.inf)))
    chans, pooled = run_v5(planes, center)
    chans_up, pooled_up = run_v5(tuple(map(up, planes)), tuple(map(up, center)))
    inputs = (tuple(t(as_np(p)) for p in planes), t(as_np(idx)).to(torch.int16),
              t(as_np(w1)).to(torch.bfloat16), t(as_np(w2)).to(torch.bfloat16), t(as_np(t2)),
              tuple(t(pts[..., i]) for i in range(3)))
    return inputs, mlps, chans, pooled, chans_up, pooled_up


def test_pe_channels_plain_matches_jax():
    """Kernel A's channels on the slots a point needs (64 * ceil(total2 / 64)),
    same slots and weights on both sides. The rel xyz channels are bitwise
    equal; the LRF channels follow ill-conditioned frames, so the gates are:
    at least 99% of entries within 1e-2 (about one bf16 ulp at the
    channels' O(1) scale), and no more unequal entries than twice JAX's own
    count under a 1-ulp input change (measured: 99.5% within 1e-2; 1.6%
    unequal against JAX's own 1.5%)."""
    inputs, _, chans_j, _, chans_up, _ = v5_case()
    got = tpf.pe_channels_plain(*inputs, R1, R2).float().numpy()
    need = np.arange(256)[None, None, :] < (tpf.chunks_needed(inputs[4], 256) * 64).numpy()[..., None]
    g, w, u = got[need], chans_j[need], chans_up[need]
    np.testing.assert_array_equal(g[:, [0, 1, 2, 6, 7, 8]], w[:, [0, 1, 2, 6, 7, 8]])
    assert (np.abs(g - w) <= 1e-2).mean() >= 0.99
    assert (g != w).sum() <= 2 * (u != w).sum()


def test_pe_fused_v5_plain_matches_jax():
    """The whole PE-v5 (channels, chunked bf16 MLP, masked max) against JAX
    on the same slots: pooled rows gated as a distribution, the median row
    error 1e-3 and the 95th percentile 2e-2 (bf16 activations: one bf16 ulp
    at the output's ~2.5 scale is 1.6e-2; measured 0 and 7.8e-3), and no
    more rows off by 0.05 than max(3, twice JAX's own 1-ulp count)
    (measured 18 rows against JAX's 12)."""
    inputs, mlps, _, pooled_j, _, pooled_up = v5_case()
    torch_mlps = [([t(W) for W in Ws], [t(b) for b in bs]) for Ws, bs in mlps]
    got = tpf.pe_fused_v5(*inputs, *torch_mlps[0], *torch_mlps[1], R1, R2, None).numpy()
    assert got.shape == pooled_j.shape == (1, 512, 256)
    err = np.abs(got - pooled_j).max(-1)
    ulp = np.abs(pooled_up - pooled_j).max(-1)
    assert np.median(err) <= 1e-3
    assert np.percentile(err, 95) <= 2e-2
    assert (err > 0.05).sum() <= max(3, 2 * (ulp > 0.05).sum())


def test_pe_mlp_pool_skips_only_zero_weight_chunks():
    """The pool over each point's own chunks equals the pool over all four
    chunks bit for bit (slots past total2 have weight 0 and ReLU outputs are
    >= 0), the property the kernels' per-point tiers rest on."""
    inputs, mlps, _, _, _, _ = v5_case()
    torch_mlps = [([t(W) for W in Ws], [t(b) for b in bs]) for Ws, bs in mlps]
    chans = tpf.pe_channels_plain(*inputs, R1, R2)
    _, _, w1, w2, total2, _ = inputs
    pooled = tpf.pe_mlp_pool_plain(chans, w1, w2, total2, *torch_mlps)
    full = tpf.pe_mlp_pool_plain(chans, w1, w2, torch.full_like(total2, 256), *torch_mlps)
    assert torch.equal(pooled, full)


def test_fine_positional_encoding_fused_matches_jax():
    """``FinePositionalEncoding(fused=True)`` on converted weights against the
    JAX module with ``fused=True`` (PE-v5, interpret) on the mixed-tier
    cloud. The converter consumes every leaf of the fused PE's tree. Rows are
    gated against JAX's own 1-ulp spread as the unfused PE is: median row
    error 1e-3 (bf16 activations), and no more rows off by 0.05 than
    max(3, twice JAX's count) (measured: median 3.6e-7, 15 rows against
    JAX's 10)."""
    pts = mixed_tier_cloud()
    kw = dict(out_dim=32, r1=R1, r2=R2, nsample1=64, nsample2=256)
    jpe = JaxPE(neighbor_mode="first_k", fused=True, **kw)
    variables = perturb(jpe.init(jax.random.PRNGKey(0), jnp.asarray(pts), train=False))
    apply = jax.jit(jpe.apply)
    want = np.asarray(apply(variables, jnp.asarray(pts)))
    ulp = np.abs(np.asarray(apply(variables, jnp.asarray(np.nextafter(pts, np.float32(np.inf))))) - want).max(-1)
    tpe = FinePositionalEncoding(32, R1, R2, 64, 256, fused=True)
    state = flax_to_torch(variables)
    n_flax = sum(np.prod(np.shape(x)) for x in jax.tree_util.tree_leaves(variables))
    assert sum(np.prod(v.shape) for v in state.values()) == n_flax
    assert set(state) == set(tpe.state_dict())
    load_flax_variables(tpe, variables)
    with torch.no_grad():
        got = tpe(t(pts)).numpy()
    assert tpe.last_branch == "v5"
    err = np.abs(got - want).max(-1)
    assert np.median(err) <= 1e-3
    assert (err > 0.05).sum() <= max(3, 2 * (ulp > 0.05).sum())


# ------------------------------------------------------------------ the config and the slice
def jax_fused_config(tiny: bool):
    from unopose_tpu.configs.main_cfg import get_cfg, get_tiny_cfg

    if tiny:
        ref = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=TINY_SIZES["npts"], coarse_npoint=16,
                           n_tem=TINY_SIZES["ntem"]).model
        ref.fine_point_matching.merge(dict(nsample1=64, nsample2=256))
    else:
        ref = get_cfg().model
    ref.feature_extraction.fused_attn = False
    ref.fine_point_matching.pe_fused = True
    ref.fused_assignment = False
    ref.use_ref_rad = False
    return ref


@pytest.mark.parametrize("tiny", [False, True])
def test_fused_matcher_config_is_the_reference_config_with_the_switches(tiny):
    """Every value of ``fused_matcher_config`` equals ``get_cfg()`` (or the
    tests' ``get_tiny_cfg``) with only ``fused_attn=False`` and
    ``fused_assignment=False`` (plus ``pe_fused=True``, which production
    leaves to the backend, and ``use_ref_rad=False``)."""
    from test_torch_package import _assert_subset

    ref = jax_fused_config(tiny)
    assert ref.geo_embedding.fused_table == 128 and ref.geo_embedding.quant_int8 is True
    _assert_subset(fused_matcher_config(tiny), ref)


@pytest.fixture(scope="module")
def fused_slice():
    """The tiny fused-matcher slice in float32 in both packages, on the tiny
    slice's perturbed weights (the fused config declares the same tree), with
    the JAX draws injected into the port."""
    _, inputs, _, variables, _ = tiny_models()
    cfg = fused_matcher_config(tiny=True)
    jcfg = fused_matcher_config(tiny=True)
    jcfg.geo_embedding.fused_interpret = True
    from unopose_tpu.models import UNOPose as JaxUNOPose

    jm = JaxUNOPose.from_config(jcfg, dtype=jnp.float32, backbone_dtype=jnp.float32)
    ji = {k: jnp.asarray(v) for k, v in inputs.items()}
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda i: jm.init(keys, i, train=False), ji)
    tm = UNOPose.from_config(cfg, dtype=torch.float32, backbone_dtype=torch.float32).eval()

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
        )(variables, ji)
        out_j = jax.tree_util.tree_map(np.asarray, out_j)
    finally:
        mp.undo()
    load_flax_variables(tm, variables)
    out_t = tm({k: t(v) for k, v in inputs.items()}, uniforms=t(drawn[0]), return_intermediates=True)
    return shapes, variables, tm, out_j, out_t


def test_fused_slice_weights_convert(fused_slice):
    """The fused config's JAX variables tree has the slice's leaves (names and
    shapes), and the converter maps every leaf onto the port's fused model."""
    shapes, variables, tm, _, _ = fused_slice
    same = jax.tree_util.tree_map(lambda s, v: tuple(s.shape) == np.shape(v), shapes, variables)
    assert all(jax.tree_util.tree_leaves(same))
    assert set(flax_to_torch(variables)) == set(tm.state_dict())


def test_fused_slice_deterministic_taps(fused_slice):
    """Clouds (relative 1e-6), coarse similarity through the int8 embedding
    (relative 1e-3) and coarse scores (1e-4), as for the unfused slice; the
    port keeps the embedding as an (int8 codes, scale) pair."""
    _, _, _, oj, ot = fused_slice
    for k in ("dense_pm", "dense_po", "sparse_pm", "sparse_po"):
        assert max_abs(oj[k], ot[k]) < 1e-6 * np.abs(oj[k]).max(), k
    e8, esc = ot["geo"]
    assert e8.dtype == torch.int8 and e8.shape == (2 * B, 17, 17, 32) and esc.shape == (32,)
    atten = oj["coarse_attens"][-1]
    assert max_abs(atten, ot["coarse_atten"]) < 1e-3 * np.abs(atten).max()
    assert max_abs(oj["coarse_scores"][-1], ot["coarse_score"]) < 1e-4


def test_fused_slice_fine_stage_given_coarse_pose(fused_slice):
    """The port's fine stage (PE-v5 plain twins) fed the JAX coarse pose and
    the port's own embedding: fine scores gated as for the unfused slice,
    median 5e-3 and 95th percentile 5e-2, since the PE's ill-conditioned rows
    spread through the attention."""
    _, _, tm, oj, ot = fused_slice
    with torch.no_grad():
        e, esc = ot["geo"]
        e = e.float()
        _, score = tm.fine_matching(
            ot["dense_pm"], ot["dense_fm"], (e[:B], esc), ot["fps_idx_m"],
            ot["dense_po"], ot["dense_fo"], (e[B:], esc), ot["fps_idx_o"],
            t(oj["init_R"]), t(oj["init_t"]),
        )
    assert tm.fine_matching.pe.last_branch == "v5"
    err = np.abs(score.numpy() - oj["fine_scores"][-1])
    assert np.median(err) < 5e-3
    assert np.percentile(err, 95) < 5e-2


def test_fused_slice_outputs_are_poses(fused_slice):
    _, _, _, _, ot = fused_slice
    R = ot["pred_R"].double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    assert torch.isfinite(R).all() and torch.isfinite(ot["pred_t"]).all()
    assert (R @ R.transpose(1, 2) - eye).abs().max() < 1e-4
    assert (torch.linalg.det(R) - 1).abs().max() < 1e-4
