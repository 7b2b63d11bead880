"""Parity of the PyTorch port's modules against the JAX package (CPU, float32).

One tiny UNOPose is initialised in JAX, every leaf of its variables is
perturbed with seeded noise (so that biases, norms and BatchNorm statistics
are not at their trivial init values), and the tree is converted into the
torch port. Each module then runs on the same numpy-seeded inputs in both
packages. Tolerances are float32 reassociation levels unless stated.

The helpers at the top are shared with ``test_torch_slice.py``.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unopose_tpu.models import UNOPose as JaxUNOPose
from unopose_tpu.models.matching import FinePositionalEncoding as JaxPE
from unopose_tpu_torch.configs import TINY_SIZES, slice_config
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.models.matching import FinePositionalEncoding
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

B = 2
IMG, NPTS, NTEM = TINY_SIZES["img"], TINY_SIZES["npts"], TINY_SIZES["ntem"]


def surface(rng, n, center, radius):
    """Points on a bumpy closed surface: neighbourhoods are surface patches,
    so the PE's local frames are mostly well conditioned."""
    dirs = rng.normal(size=(B, n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    bump = 1.0 + 0.25 * np.sin(3.0 * dirs[..., 0] + 1.0) * np.cos(2.0 * dirs[..., 1])
    return center + radius * bump[..., None] * dirs + rng.normal(size=(B, n, 3)) * 5e-4


def slice_inputs(seed=0):
    """A query cloud and a template (24 far points set its radius, so the
    remaining surface stays dense after normalisation) plus random crops."""
    rng = np.random.default_rng(seed)
    ctr = np.array([0.0, 0.0, 0.6])
    tem = surface(rng, NTEM, ctr, 0.03)
    far = rng.normal(size=(B, NTEM // 16, 3))
    far /= np.linalg.norm(far, axis=-1, keepdims=True)
    tem[:, ::16] = ctr + 0.1 * far
    d = dict(
        rgb=rng.uniform(-1, 1, size=(B, IMG, IMG, 3)),
        rgb_choose=rng.integers(0, IMG * IMG, size=(B, NPTS)).astype(np.int32),
        pts=surface(rng, NPTS, ctr + 0.005, 0.03),
        tem1_rgb=rng.uniform(-1, 1, size=(B, IMG, IMG, 3)),
        tem1_choose=rng.integers(0, IMG * IMG, size=(B, NTEM)).astype(np.int32),
        tem1_pts=tem,
    )
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in d.items()}


def perturb(variables, seed=1):
    """Seeded noise on every leaf; BatchNorm variances are scaled instead."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x)
        if "var" in jax.tree_util.keystr(path):
            return (x * rng.uniform(0.5, 2.0, size=x.shape)).astype(np.float32)
        return (x + rng.normal(size=x.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


@functools.lru_cache(maxsize=None)
def tiny_models(shift: int = 0):
    """(config, inputs, jax model, perturbed numpy variables, torch model with
    them loaded), both models built from the port's tiny slice config, every
    seed (the inputs', the init keys', the perturbation's) moved by ``shift``.
    Built once per process: this file and ``test_torch_slice.py`` share it."""
    cfg = slice_config(tiny=True)
    inputs = slice_inputs(shift)
    jm = JaxUNOPose.from_config(cfg, dtype=jnp.float32, backbone_dtype=jnp.float32)
    ji = {k: jnp.asarray(v) for k, v in inputs.items()}
    keys = {"params": jax.random.PRNGKey(0 + shift), "sample": jax.random.PRNGKey(1 + shift)}
    variables = perturb(jax.jit(lambda i: jm.init(keys, i, train=False))(ji), seed=1 + shift)
    tm = UNOPose.from_config(cfg, dtype=torch.float32, backbone_dtype=torch.float32)
    load_flax_variables(tm, variables)
    return cfg, inputs, jm, variables, tm.eval()


def t(x):
    return torch.from_numpy(np.array(x))


def max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b.detach() if torch.is_tensor(b) else b, np.float64)).max())


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def test_converter_consumes_every_leaf(models):
    """Every flax leaf lands in exactly one torch key (stacked blocks once per
    layer) and the strict load leaves no torch parameter uncovered."""
    _, _, _, variables, tm = models
    state = flax_to_torch(variables)
    n_torch = sum(np.prod(v.shape) for v in state.values())
    n_flax = sum(np.prod(np.shape(x)) for x in jax.tree_util.tree_leaves(variables))
    assert n_torch == n_flax
    assert set(state) == set(tm.state_dict())
    # a stacked Dense kernel (layers, in, out) -> per layer (out, in)
    k = variables["params"]["coarse_matching"]["blocks"]["score_head"]["kernel"]
    np.testing.assert_array_equal(state["coarse_matching.blocks.2.score_head.weight"].numpy(), k[2].T)
    with pytest.raises(ValueError):
        flax_to_torch({"params": {}, "cache": {}})


def test_vit_pyramid_and_upscaler(models):
    """ViT taps (exact erf GELU, fp32 LN) and the linear upscaler: <= 1e-4."""
    _, inputs, jm, variables, tm = models
    x = np.concatenate([inputs["rgb"], inputs["tem1_rgb"]], 0)
    low_j = jm.apply(variables, jnp.asarray(x), method=lambda m, x: m.encoder.rgb_net(x, upsample=False)[0])
    with torch.no_grad():
        low_t = tm.encoder.rgb_net(t(x))
    assert low_t.shape == low_j.shape
    assert max_abs(low_j, low_t) < 1e-4


def test_encoder(models):
    """Radius normalisation, bilinear pixel features and template FPS 384 -> 256:
    FPS indices equal, so clouds and radius agree to float32 rounding
    (relative 1e-6), features to 1e-4."""
    _, inputs, jm, variables, tm = models
    names = ("rgb", "rgb_choose", "pts", "tem1_rgb", "tem1_choose", "tem1_pts")
    out_j = jm.apply(variables, *(jnp.asarray(inputs[k]) for k in names), method=lambda m, *a: m.encoder(*a))
    with torch.no_grad():
        out_t = tm.encoder(*(t(inputs[k]) for k in names))
    for a, b, rtol in zip(out_j, out_t, (1e-6, 1e-4, 1e-6, 1e-4, 1e-6)):
        assert a.shape == b.shape
        assert max_abs(a, b) < rtol * max(1.0, float(np.abs(np.asarray(a)).max()))


def test_geometric_embedding(models):
    """Distance and k-NN angle sinusoids (bounded polynomial sin/cos) and
    both projections, on LRF-like points plus the (1, 1, 1) bg point."""
    _, _, jm, variables, tm = models
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2 * B, 17, 3)).astype(np.float32)
    pts /= np.maximum(1.0, np.linalg.norm(pts, axis=-1, keepdims=True))
    pts[:, 0] = 1.0
    e_j = jm.apply(variables, jnp.asarray(pts), method=lambda m, p: m.geo_embed(p))
    with torch.no_grad():
        e_t = tm.geo_embed(t(pts))
    assert max_abs(e_j, e_t) < 2e-4 * (np.abs(np.asarray(e_j)).max() + 1)


def test_coarse_point_matching(models):
    """RPE self / vanilla cross blocks, score head and cosine similarity."""
    _, _, jm, variables, tm = models
    rng = np.random.default_rng(4)
    f1, f2 = (rng.normal(size=(B, 16, 32)).astype(np.float32) for _ in range(2))
    g1, g2 = (rng.normal(size=(B, 17, 17, 32)).astype(np.float32) for _ in range(2))
    a_j, s_j, _ = jm.apply(
        variables, *map(jnp.asarray, (f1, g1, f2, g2)), method=lambda m, *a: m.coarse_matching(*a)
    )
    with torch.no_grad():
        a_t, s_t = tm.coarse_matching(*map(t, (f1, g1, f2, g2)))
    assert max_abs(a_j[-1], a_t) < 1e-3 * np.abs(np.asarray(a_j[-1])).max()
    assert max_abs(s_j[-1], s_t) < 1e-4


@functools.lru_cache(maxsize=None)
def pe_pair():
    """(jitted JAX PE apply, its variables, the port's PE) of the tiny models."""
    cfg, _, _, variables, tm = tiny_models()
    fm = cfg.fine_point_matching
    jpe = JaxPE(out_dim=32, r1=fm.pe_radius1, r2=fm.pe_radius2, nsample1=64, nsample2=256,
                neighbor_mode="first_k", fused=False)
    pv = {"params": variables["params"]["fine_matching"]["pe"],
          "batch_stats": variables["batch_stats"]["fine_matching"]["pe"]}
    return jax.jit(jpe.apply), pv, tm.fine_matching.pe


def pe_envelope(cloud):
    """(port-vs-JAX per-row max error, JAX-vs-JAX error for a 1-ulp input change)."""
    apply, pv, tpe = pe_pair()
    j0 = np.asarray(apply(pv, jnp.asarray(cloud)))
    j1 = np.asarray(apply(pv, jnp.asarray(np.nextafter(cloud, np.float32(np.inf)))))
    with torch.no_grad():
        p = tpe(t(cloud)).numpy()
    return np.abs(p - j0).max(-1), np.abs(j1 - j0).max(-1)


def test_fine_positional_encoding(models):
    """Packed first_k PE with folded BN. Its local frames are ill conditioned
    on a few neighbourhoods (near-equal covariance eigenvalues or a near-zero
    x-axis sum): there JAX itself moves by O(0.1) under a 1-ulp input change.
    The gate: the port's rows stay within float32 noise except where JAX's
    own 1-ulp spread is as large, and no more rows move than under that."""
    _, inputs, _, _, _ = models
    tpe = pe_pair()[2]
    cloud = (inputs["pts"] - inputs["pts"].mean(1, keepdims=True)) / 0.1
    err, ulp = pe_envelope(cloud.astype(np.float32))
    assert tpe.last_branch == "packed"
    assert np.median(err) < 1e-4
    assert (err > 1e-3).sum() <= max(3, 2 * (ulp > 1e-3).sum())
    assert np.mean(err > 1e-3) < 0.05


def test_fine_positional_encoding_overflow_branch(models):
    """A cloud whose balls hold more than 64 r1 hits takes the exact
    fallback in both packages."""
    tpe = pe_pair()[2]
    rng = np.random.default_rng(5)
    cloud = rng.uniform(-0.05, 0.05, size=(B, 256, 3)).astype(np.float32)
    cloud[:, :, 2] *= 0.05  # a thin slab: planar neighbourhoods
    err, _ = pe_envelope(cloud)
    assert tpe.last_branch == "exact"
    assert np.median(err) < 1e-4
    assert np.mean(err > 1e-3) < 0.05


def test_fine_point_matching_given_pe(models, monkeypatch):
    """Fine blocks (sparse-to-dense, focused linear attention), similarity and
    score head, with both packages handed the same pooled PE features ahead
    of the PE's output Dense, so only deterministic layers are compared."""
    import unopose_tpu.models.matching as jax_matching

    _, _, jm, variables, tm = models
    rng = np.random.default_rng(6)
    n = 256
    p1, p2 = (rng.normal(size=(B, n, 3)).astype(np.float32) * 0.3 for _ in range(2))
    f1, f2 = (rng.normal(size=(B, n, 32)).astype(np.float32) for _ in range(2))
    g1, g2 = (rng.normal(size=(B, 17, 17, 32)).astype(np.float32) for _ in range(2))
    i1, i2 = (np.stack([rng.permutation(n)[:16] for _ in range(B)]).astype(np.int32) for _ in range(2))
    R = np.stack([np.eye(3, dtype=np.float32)] * B)
    tr = np.zeros((B, 3), np.float32)
    pooled = rng.normal(size=(2 * B, n, 256)).astype(np.float32)
    monkeypatch.setattr(jax_matching, "pe_packed_firstk_path", lambda *a, **k: jnp.asarray(pooled))
    pe = tm.fine_matching.pe
    monkeypatch.setattr(pe, "forward", lambda pts: pe.mlp3(t(pooled)))
    args = (p1, f1, g1, i1, p2, f2, g2, i2, R, tr)
    a_j, s_j, _, _ = jm.apply(variables, *map(jnp.asarray, args), method=lambda m, *a: m.fine_matching(*a))
    with torch.no_grad():
        a_t, s_t = tm.fine_matching(*map(t, args))
    assert max_abs(a_j[-1], a_t) < 1e-3 * np.abs(np.asarray(a_j[-1])).max()
    assert max_abs(s_j[-1], s_t) < 1e-4
