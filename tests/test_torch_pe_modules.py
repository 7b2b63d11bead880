"""The port's fused fine PE module against the JAX package's (CPU), on
weights converted from the JAX module, under each fine-PE switch and at N
576 (row 10) and 272 (the plain float32 MLP). The clouds and switches are
``test_torch_pe_variants.py``'s; the gates are stated in each test.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_fused import R1, R2
from test_torch_models import perturb, t
from test_torch_pe_variants import ALL_SWITCHES, SWITCHES, cloud
from unopose_tpu.models.matching import FinePositionalEncoding as JaxPE
from unopose_tpu_torch.models.matching import FinePositionalEncoding
from unopose_tpu_torch.utils.convert import load_flax_variables


# ------------------------------------------------------------------ the module
@functools.lru_cache(maxsize=None)
def jax_module(n: int, switch: str):
    """The JAX fused module under ``switch`` on ``cloud(n)``: its perturbed
    variables, its output and its output on the cloud one ulp up."""
    pts = cloud(n)
    mp = pytest.MonkeyPatch()
    for name in ALL_SWITCHES:
        mp.delenv(name, raising=False)
    for name, value in SWITCHES[switch].items():
        mp.setenv(name, value)
    try:
        jpe = JaxPE(neighbor_mode="first_k", fused=True, out_dim=32, r1=R1, r2=R2, nsample1=64, nsample2=256)
        variables = perturb(jpe.init(jax.random.PRNGKey(0), jnp.asarray(pts), train=False))
        apply = jax.jit(jpe.apply)
        want = np.asarray(apply(variables, jnp.asarray(pts)))
        nudged = np.asarray(apply(variables, jnp.asarray(np.nextafter(pts, np.float32(np.inf)))))
    finally:
        mp.undo()
    return variables, want, nudged


@pytest.mark.parametrize("n, switch, branch", [(576, "none", "packed"), (512, "v5_off", "packed"), (512, "v3", "v3"),
                                               (512, "v4", "gather_t"), (512, "slot_major", "packed_t")])
def test_fine_positional_encoding_variants_match_jax(n, switch, branch, monkeypatch):
    """``FinePositionalEncoding(fused=True)`` on weights converted from the
    JAX module, against it under each switch, and at N 576 with none (row
    10, which PE-v5 cannot take): the module gates of
    ``test_fine_positional_encoding_fused_matches_jax``, median row error
    1e-3 and no more rows off by 0.05 than max(3, twice JAX's own count)."""
    for name in ALL_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in SWITCHES[switch].items():
        monkeypatch.setenv(name, value)
    variables, want, nudged = jax_module(n, switch)
    tpe = FinePositionalEncoding(32, R1, R2, 64, 256, fused=True)
    load_flax_variables(tpe, variables)
    with torch.no_grad():
        got = tpe(t(cloud(n))).numpy()
    assert tpe.last_branch == branch
    err = np.abs(got - want).max(-1)
    ulp = np.abs(nudged - want).max(-1)
    assert np.median(err) <= 1e-3, np.median(err)
    assert (err > 0.05).sum() <= max(3, 2 * (ulp > 0.05).sum()), ((err > 0.05).sum(), (ulp > 0.05).sum())


def test_fine_positional_encoding_n272_matches_jax_xla_path(monkeypatch):
    """At N 272 (N % 64 and N % 32 nonzero) both fused modules run the
    unpacked grouping through the plain float32 MLP: the unfused PE's gates
    of ``test_torch_subset.py``, the median row error within 1e-4 and no
    more rows off by 1e-3 than max(3, twice JAX's own count)."""
    for name in ALL_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    pts = cloud(272)
    jpe = JaxPE(neighbor_mode="first_k", fused=True, out_dim=32, r1=R1, r2=R2, nsample1=64, nsample2=256)
    variables = perturb(jpe.init(jax.random.PRNGKey(0), jnp.asarray(pts), train=False))
    apply = jax.jit(jpe.apply)
    want = np.asarray(apply(variables, jnp.asarray(pts)))
    ulp = np.abs(np.asarray(apply(variables, jnp.asarray(np.nextafter(pts, np.float32(np.inf))))) - want).max(-1)
    tpe = FinePositionalEncoding(32, R1, R2, 64, 256, fused=True)
    load_flax_variables(tpe, variables)
    with torch.no_grad():
        got = tpe(t(pts)).numpy()
    assert tpe.last_branch == "unpacked_plain"
    err = np.abs(got - want).max(-1)
    assert np.median(err) < 1e-4, np.median(err)
    assert (err > 1e-3).sum() <= max(3, 2 * (ulp > 1e-3).sum()), ((err > 1e-3).sum(), (ulp > 1e-3).sum())
