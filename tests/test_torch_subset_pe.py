"""The subset grouping, the subset-mode and unpacked first_k fine PE module
and the subset and unpacked configs of the PyTorch port against the JAX
package (CPU): the grouping's plain twin against ``ball_group_subset_pallas``
(interpret mode) and JAX's XLA paths, ``FinePositionalEncoding`` in each
mode against JAX's on converted weights, and the configs against
``get_cfg()`` with the switch. Split from ``test_torch_subset.py`` (the
masked PE and the tiny subset model, and the helpers both use, stay there)
so that ``--dist loadfile`` spreads the two files; each test states its
tolerance and why.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import max_abs, perturb, t
from test_torch_package import _assert_subset
from test_torch_subset import anisotropic_cloud, as_np
from unopose_tpu.models.matching import FinePositionalEncoding as JaxPE
from unopose_tpu_torch.configs import SUBSET_TINY_NPTS, TINY_SIZES, firstk_unpacked_config, subset_config
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.models.matching import FinePositionalEncoding
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jbq = importlib.import_module("unopose_tpu.ops.ball_query")
tbq = importlib.import_module("unopose_tpu_torch.ops.ball_query")  # the package exports ball_query, the function


def bits(x):
    return np.ascontiguousarray(as_np(x).astype(np.float32)).view(np.int32)


# ------------------------------------------------------------------ the module
# (neighbour mode, packed, points, budgets, fused): subset; the unpacked first_k path forced; and the
# configurations the packed path cannot take: N % 64 != 0 (the JAX package's fused PE needs 64 | N, so
# plain only), and a scale-2 budget that is no multiple of 256
PE_CASES = [("subset", None, 512, (64, 256), True), ("subset", None, 512, (64, 256), False),
            ("first_k", False, 512, (64, 256), True), ("first_k", False, 512, (64, 256), False),
            ("first_k", None, 480, (64, 256), False), ("first_k", None, 512, (32, 128), True)]


# ------------------------------------------------------------------ the configs
def jax_config(name: str, tiny: bool):
    from unopose_tpu.configs.main_cfg import get_cfg, get_tiny_cfg

    if tiny:
        n = SUBSET_TINY_NPTS if name == "subset" else TINY_SIZES["npts"]
        ref = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=n, coarse_npoint=16,
                           n_tem=TINY_SIZES["ntem"] * n // TINY_SIZES["npts"]).model
        ref.fine_point_matching.merge(dict(nsample1=64, nsample2=256))
    else:
        ref = get_cfg().model
    ref.use_ref_rad = False
    if name == "subset":
        ref.fine_point_matching.pe_neighbor_mode = "subset"
    else:
        ref.fine_point_matching.pe_packed = False
    return ref


@pytest.mark.parametrize("S, radius", [(16, 0.2), (64, 0.3), (256, 0.6)])
def test_ball_group_subset_plain_matches_jax(S, radius):
    """The plain twin against ``ball_group_subset_pallas(interpret=True)``:
    validity equal, the three planes and the distances bitwise equal on
    every slot, miss slots included (both fill a miss with candidate 0 and a
    distance of 0). The radii leave between a quarter and a half of the
    slots valid, so both fills are exercised."""
    pts = anisotropic_cloud()
    (jx, jy, jz), jd, jv = jbq.ball_group_subset_pallas(radius, S, jnp.asarray(pts), interpret=True)
    (tx, ty, tz), td, tv = tbq.ball_group_subset_plain(radius, S, t(pts))
    assert tv.dtype == torch.bool and tv.shape == (2, 512, S)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert 0.2 < tv.float().mean().item() < 0.8
    for a, b in ((jx, tx), (jy, ty), (jz, tz), (jd, td)):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("mode, n, S", [("subset", 512, 64), ("subset", 512, 256), ("subset", 500, 64),
                                        ("first_k", 512, 64)])
def test_ball_group_planar_matches_jax(mode, n, S):
    """The plain ``ball_group_planar`` (the XLA path) against JAX's, the
    ``N % S != 0`` cloud taking the first-k-in-radius branch: validity equal
    and, on valid slots, the planes equal and the distances within 1e-6 (the
    same neighbours; ``pairwise_sqdist``'s expansion and the selected
    distances round differently). The XLA path fills a subset miss with
    candidate G - 1, the kernels with candidate 0; consumers mask them."""
    pts = anisotropic_cloud()[:, :n]
    (jx, jy, jz), jd, jv = jbq.ball_group_planar(0.3, S, jnp.asarray(pts), mode=mode)
    (tx, ty, tz), td, tv = tbq.ball_group_planar(0.3, S, t(pts), mode=mode)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(jv, tv.numpy())
    assert jv.any() and not jv.all()
    for a, b in ((jx, tx), (jy, ty), (jz, tz)):
        np.testing.assert_array_equal(np.asarray(a)[jv], b.numpy()[jv])
    assert max_abs(np.asarray(jd)[jv], td.numpy()[jv]) < 1e-6


def test_first_k_in_radius_pads_past_n():
    """A budget larger than the cloud pads the slots past N with the first
    hit, as the reference's ball query does."""
    mask = torch.tensor([[False, True, True], [False, False, False]])
    idx = tbq.first_k_in_radius(mask, 5)
    assert idx.tolist() == [[1, 2, 1, 1, 1], [0, 0, 0, 0, 0]]


@pytest.mark.parametrize("mode, packed, n, budgets, fused", PE_CASES)
def test_fine_positional_encoding_matches_jax(mode, packed, n, budgets, fused):
    """``FinePositionalEncoding`` on converted weights against the JAX module
    (``fused`` True: the Pallas kernels in interpret mode; False: the XLA
    path, whose activations are bf16 in subset mode and float32 in first_k
    mode). The parameter tree is the same in every mode and the converter
    maps each leaf. Rows are gated against JAX's own spread under a one-ulp
    input change, as the other PE tests: the median row error within 1e-4
    (measured 5e-7 to 3.7e-6), and no more rows off by over 1e-3 on the
    float32 first_k path, 0.05 on the bf16 paths (a hidden activation that
    rounds the other way moves a row by ~1e-3), than max(3, twice JAX's own
    count) (measured: over 1e-3, 2 and 5 rows against 1 and 4; over 0.05,
    none)."""
    pts = anisotropic_cloud(512)[:, :n]
    kw = dict(out_dim=32, r1=0.25, r2=0.5, nsample1=budgets[0], nsample2=budgets[1])
    jpe = JaxPE(neighbor_mode=mode, fused=fused, packed=packed, **kw)
    variables = perturb(jpe.init(jax.random.PRNGKey(0), jnp.asarray(pts), train=False))
    first_k = JaxPE(neighbor_mode="first_k", **kw).init(jax.random.PRNGKey(0), jnp.asarray(pts), train=False)
    same = jax.tree_util.tree_map(lambda a, b: np.shape(a) == np.shape(b), variables, first_k)
    assert all(jax.tree_util.tree_leaves(same))  # one tree for every mode
    apply = jax.jit(jpe.apply)
    want = np.asarray(apply(variables, jnp.asarray(pts)))
    ulp = np.abs(np.asarray(apply(variables, jnp.asarray(np.nextafter(pts, np.float32(np.inf))))) - want).max(-1)
    tpe = FinePositionalEncoding(32, 0.25, 0.5, *budgets, fused=fused, neighbor_mode=mode, packed=packed)
    assert set(flax_to_torch(variables)) == set(tpe.state_dict())
    load_flax_variables(tpe, variables)
    with torch.no_grad():
        got = tpe(t(pts)).numpy()
    assert tpe.last_branch == ("subset" if mode == "subset" else "unpacked")
    err = np.abs(got - want).max(-1)
    far = 1e-3 if mode == "first_k" and not fused else 0.05
    assert np.median(err) < 1e-4, np.median(err)
    assert (err > far).sum() <= max(3, 2 * (ulp > far).sum()), ((err > far).sum(), (ulp > far).sum())


def test_unknown_neighbor_mode_raises():
    """An unknown neighbour mode raises ``ValueError`` (as the JAX grouping
    does), from the grouping, the module and the model config."""
    with pytest.raises(ValueError):
        tbq.ball_group_planar(0.2, 16, torch.rand(1, 64, 3), mode="ball")
    with pytest.raises(ValueError):
        FinePositionalEncoding(32, neighbor_mode="ball")
    cfg = subset_config(tiny=True)
    cfg.fine_point_matching.pe_neighbor_mode = "ball"
    with pytest.raises(ValueError):
        UNOPose.from_config(cfg)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", ["subset", "firstk_unpacked"])
def test_configs_are_get_cfg_with_the_switch(name, tiny):
    """Every value of ``subset_config`` / ``firstk_unpacked_config`` equals
    ``get_cfg()`` (or the tests' ``get_tiny_cfg`` with the PE budgets 64/256,
    at 512 points for subset) with ``pe_neighbor_mode="subset"`` or
    ``pe_packed=False``, and the model builds with that PE."""
    ours = {"subset": subset_config, "firstk_unpacked": firstk_unpacked_config}[name](tiny)
    _assert_subset(ours, jax_config(name, tiny))
    pe = UNOPose.from_config(ours).fine_matching.pe
    assert pe.fused and (pe.neighbor_mode, pe.packed) == (("subset", None) if name == "subset" else ("first_k", False))
