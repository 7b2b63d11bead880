"""The first_k routing of the port's fused fine PE against the JAX package
(CPU): ``FinePositionalEncoding`` takes the branch JAX's module takes for
every (N, nsample2, switch) of the routing table. JAX's branch is the fused
PE function it calls, spied on while its module is traced. The clouds and
switches are ``test_torch_pe_variants.py``'s.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_fused import R1, R2
from test_torch_models import t
from test_torch_pe_variants import ALL_SWITCHES, SWITCHES, cloud
from unopose_tpu.models.matching import FinePositionalEncoding as JaxPE
from unopose_tpu_torch.models.matching import FinePositionalEncoding

jpf = importlib.import_module("unopose_tpu.ops.pe_fused")


# ------------------------------------------------------------------ the routing
def jax_branch(pts: np.ndarray, k2: int) -> str:
    """The branch JAX's fused module takes on ``pts``: the fused PE function
    it calls while its init is traced (``jax.eval_shape``: nothing runs),
    each replaced by a stub returning zeros; "unpacked_plain" when none."""
    calls = []

    def stub(name, shape_of):
        def fn(*args, **kwargs):
            calls.append(name)
            B, P = shape_of(args)
            return jnp.zeros((B, P, 256), jnp.float32)
        return fn

    stubs = {
        "pe_fused_v5": stub("v5", lambda a: a[1].shape[:2]),
        "pe_fused_gather_t": stub("gather_t", lambda a: a[1].shape[:2]),
        "pe_fused_packed": stub("packed", lambda a: a[0][0].shape[:2]),
        "pe_fused_packed_t": stub("packed_t", lambda a: a[3].shape),
        "pe_mlp_pool_packed": stub("v3", lambda a: a[1].shape),
        "pe_fused": stub("unpacked", lambda a: a[4][0].shape),
    }
    mp = pytest.MonkeyPatch()
    for name, fn in stubs.items():
        mp.setattr(jpf, name, fn)
    try:
        jpe = JaxPE(neighbor_mode="first_k", fused=True, out_dim=32, r1=R1, r2=R2, nsample1=64, nsample2=k2)
        jax.eval_shape(lambda x: jpe.init(jax.random.PRNGKey(0), x, train=False), jnp.asarray(pts))
    finally:
        mp.undo()
    assert len(calls) <= 1, calls
    return calls[0] if calls else "unpacked_plain"


ROUTES = [(n, k2, sw) for n in (512, 576, 272) for k2 in (256, 512) if k2 <= n for sw in SWITCHES]
ROUTES += [(768, 768, sw) for sw in SWITCHES]  # nsample2 768: JAX's gates admit any multiple of 256 up to N


@pytest.mark.parametrize("n, k2, switch", ROUTES)
def test_fine_pe_routing_follows_jax(n, k2, switch, monkeypatch):
    """``FinePositionalEncoding(fused=True)`` takes JAX's branch for every
    cloud size (N % 128 == 0, N % 128 == 64, N % 64 != 0), scale-2 budget
    (256, 512, and 768 at N 768) and switch, and its features are finite."""
    for name in ALL_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in SWITCHES[switch].items():
        monkeypatch.setenv(name, value)
    pts = cloud(n)
    want = jax_branch(pts, k2)
    torch.manual_seed(0)
    tpe = FinePositionalEncoding(32, R1, R2, 64, k2, fused=True)
    with torch.no_grad():
        out = tpe(t(pts))
    assert tpe.last_branch == want, (tpe.last_branch, want)
    assert out.shape == (1, n, 32) and torch.isfinite(out).all()
