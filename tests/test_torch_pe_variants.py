"""The packed fine PE's other layouts and the first_k routing of the PyTorch
port against the JAX package (CPU).

The JAX package computes the packed first_k PE in four more layouts, each a
Pallas kernel: ``pe_fused_packed`` (point-major; reached with no switch
where PE-v5 cannot take the cloud), ``pe_mlp_pool_packed`` on the XLA
channels of ``pe_channels_packed`` (``UNOPOSE_PE_V3``),
``pe_fused_gather_t`` (``UNOPOSE_PE_V4``) and ``pe_fused_packed_t``
(``UNOPOSE_PE_SLOT_MAJOR``). The port's plain twins (``ops/pe_fused.py``)
run here; JAX runs its kernels in interpret mode, on the same slots and
weights, made with numpy from a seed. The local frames are ill conditioned
on a few neighbourhoods, so the pooled rows are gated against JAX's own
spread under a one-ulp input change, as ``test_torch_fused.py`` gates
PE-v5: the median row error 1e-3, the 95th percentile 2e-2, and no more
rows off by 0.05 than max(3, twice JAX's own count).

The routing of ``FinePositionalEncoding`` against JAX's module is in
``test_torch_pe_routes.py``, the module against JAX's under each switch in
``test_torch_pe_modules.py``: their own files, so that ``--dist loadfile``
spreads the three over workers. Both take this file's clouds and switches.
"""

import functools
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_fused import R1, R2, _folded_mlps, as_np, mixed_tier_cloud
from test_torch_models import t
from unopose_tpu_torch.ops import pe_fused as tpf

jbq = importlib.import_module("unopose_tpu.ops.ball_query")
jpf = importlib.import_module("unopose_tpu.ops.pe_fused")

SWITCHES = {
    "none": {},
    "v5_off": {"UNOPOSE_PE_V5": "0"},
    "v3": {"UNOPOSE_PE_V5": "0", "UNOPOSE_PE_V3": "1"},
    "v4": {"UNOPOSE_PE_V5": "0", "UNOPOSE_PE_V4": "1"},
    "slot_major": {"UNOPOSE_PE_V5": "0", "UNOPOSE_PE_SLOT_MAJOR": "1"},
}
ALL_SWITCHES = ("UNOPOSE_PE_V5", "UNOPOSE_PE_V3", "UNOPOSE_PE_V4", "UNOPOSE_PE_SLOT_MAJOR")


def cloud(n: int) -> np.ndarray:
    """The mixed-tier cloud (its 160-point ring holds 64-point blocks whose
    hits fill more than half of 256 slots, its shell blocks under 64 hits),
    cut to n points, or grown by a copy of the ring's first 64 points 0.3
    away."""
    pts = mixed_tier_cloud()
    if n <= pts.shape[1]:
        return np.ascontiguousarray(pts[:, :n])
    return np.concatenate([pts, pts[:, : n - pts.shape[1]] + np.float32(0.3)], axis=1)


def dense_cloud(n: int = 512) -> np.ndarray:
    """n - 64 points in a dense cube, and 64 in a flat 0.3 x 0.16 x 0.06 box
    2 away, whose 64-point block has few hits (row 10's fast path).

    n 512: 448 points uniform in a 0.408 cube: at S2 512 each of the cube's
    seven 64-point blocks holds a point with over 256 hits at R2 (row 10's
    full path; rows 11 and 12's 512-slot tier), and no point has over 60
    hits at R1. n 768: 704 points of a 9 x 9 x 9 lattice of step 0.052,
    jittered by a tenth of a step and shuffled: a uniform cloud dense enough
    for over 384 hits at R2 holds over 64 at R1 somewhere (the grouping's
    overflow), a lattice does not. At S2 768 eight of its eleven blocks hold
    a point with over 384 hits (row 10's full path, past one 512-slot window
    on the card), three do not, every 128-point block holds one with over 128
    (rows 11 and 12's 768-slot tier), and no point has over 57 hits at R1."""
    rng = np.random.default_rng(2 if n == 512 else 3)
    if n == 512:
        pts = rng.uniform(-0.204, 0.204, size=(1, 512, 3))
    else:
        grid = np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"), -1).reshape(-1, 3)[: n - 64] * 0.052
        grid = grid - grid.mean(0) + rng.uniform(-0.1, 0.1, size=grid.shape) * 0.052
        pts = np.concatenate([grid[rng.permutation(n - 64)], np.zeros((64, 3))])[None]
    pts[:, n - 64:] = rng.uniform(-1.0, 1.0, size=(1, 64, 3)) * np.array([0.15, 0.08, 0.03]) + 2.0
    return pts.astype(np.float32)


def up(x):
    return jnp.asarray(np.nextafter(np.asarray(x), np.float32(np.inf)))


def jmlps():
    return [[jnp.asarray(x) for x in part] for mlp in _folded_mlps() for part in mlp]


def tmlps():
    return [([t(W) for W in Ws], [t(b) for b in bs]) for Ws, bs in _folded_mlps()]


@functools.lru_cache(maxsize=None)
def grouping(n: int, k2: int, dense: bool = False):
    """JAX's packed grouping (materialised and index) of ``cloud(n)`` (with
    ``dense``, of ``dense_cloud(n)``), the centres, and the port's copies."""
    pts = dense_cloud(n) if dense else cloud(n)
    g2, w1, w2, t2, ov = jbq.two_scale_group_first_k_packed(R1, 64, R2, k2, jnp.asarray(pts))
    planes, idx, iw1, iw2, it2, iov = jbq.two_scale_group_first_k_packed_idx(R1, 64, R2, k2, jnp.asarray(pts))
    assert not bool(ov) and not bool(iov)
    center = tuple(jnp.asarray(pts[..., i]) for i in range(3))
    port = dict(g2=tuple(t(as_np(g)) for g in g2), w1=t(as_np(w1)).to(torch.bfloat16),
                w2=t(as_np(w2)).to(torch.bfloat16), total2=t(as_np(t2)), center=tuple(t(pts[..., i]) for i in range(3)),
                planes=tuple(t(as_np(p)) for p in planes), idx=t(as_np(idx)).to(torch.int16))
    return dict(g2=g2, w1=w1, w2=w2, total2=t2, center=center, planes=planes, idx=idx), port


@functools.lru_cache(maxsize=None)
def jax_row(row: str, n: int, k2: int, nudged: bool = False, dense: bool = False) -> np.ndarray:
    """JAX's kernel of one row in interpret mode on ``grouping(n, k2,
    dense)``; with ``nudged`` every coordinate (slots, planes, centres) one
    ulp up."""
    j, _ = grouping(n, k2, dense)
    g2, center, planes = j["g2"], j["center"], j["planes"]
    if nudged:
        g2, center, planes = tuple(map(up, g2)), tuple(map(up, center)), tuple(map(up, planes))
    w1, w2, t2 = j["w1"], j["w2"], j["total2"]
    if row == "packed":
        out = jpf.pe_fused_packed(g2, w1, w2, t2, center, *jmlps(), R1, R2, interpret=True)
    elif row == "packed_t":
        sw = lambda x: jnp.swapaxes(x, 1, 2)
        out = jpf.pe_fused_packed_t(tuple(map(sw, g2)), sw(w1), sw(w2), t2, center, *jmlps(), R1, R2, interpret=True)
    elif row == "gather_t":
        out = jpf.pe_fused_gather_t(planes, j["idx"], w1, w2, t2, center, *jmlps(), R1, R2, interpret=True)
    else:  # "v3": the XLA channels, then the MLP/pool kernel
        chunks, _ = jpf.pe_channels_packed(g2, w1, w2, center, R1, R2)
        return np.asarray(jpf.pe_mlp_pool_packed(chunks, t2, *jmlps(), interpret=True)), [as_np(c) for c in chunks]
    return np.asarray(out)


def assert_rows_within_jax_spread(got, want, nudged):
    """The PE-v5 gates of ``test_torch_fused.py`` on pooled (B, P, 256) rows."""
    assert got.shape == want.shape
    err = np.abs(got - want).max(-1)
    ulp = np.abs(nudged - want).max(-1)
    assert np.median(err) <= 1e-3, np.median(err)
    assert np.percentile(err, 95) <= 2e-2, np.percentile(err, 95)
    assert (err > 0.05).sum() <= max(3, 2 * (ulp > 0.05).sum()), ((err > 0.05).sum(), (ulp > 0.05).sum())


# ------------------------------------------------------------------ the four twins
@pytest.mark.parametrize("n, k2", [(512, 256), (576, 256), (512, 512)])
def test_pe_fused_packed_plain_matches_jax(n, k2):
    """Row 10's twin against ``pe_fused_packed(interpret=True)``. At S2 256
    the cloud has 64-point blocks on both the fast (half-budget) and the
    full path; at S2 512 every block is fast (measured: 18 rows over 0.05
    at every case, against JAX's own 12)."""
    _, p = grouping(n, k2)
    got = tpf.pe_fused_packed_plain(p["g2"], p["w1"], p["w2"], p["total2"], p["center"], *tmlps(), R1, R2).numpy()
    fast = (tpf.block_max(p["total2"], 64) <= k2 // 2).numpy()
    if k2 == 256:
        assert fast.any() and (~fast).any()
    assert_rows_within_jax_spread(got, jax_row("packed", n, k2), jax_row("packed", n, k2, True))


def test_pe_channels_packed_matches_jax():
    """Row 13's channels (plain PyTorch in the port, XLA in JAX), chunk by
    chunk: rel xyz (scale 1's zeroed off its hits) bitwise equal; the LRF
    channels at PE-v5's channel gates, at least 99% within 1e-2 and no more
    unequal entries than twice JAX's own count under a one-ulp input change
    (measured: 99.4% equal)."""
    j, p = grouping(512, 256)
    chunks, w = tpf.pe_channels_packed(p["g2"], p["w1"], p["w2"], p["center"], R1, R2)
    _, want = jax_row("v3", 512, 256)
    _, moved = jax_row("v3", 512, 256, True)
    assert w == 64 and len(chunks) == 4
    for got, wc, mc in zip(chunks, want, moved):
        g = got.float().numpy()
        rel = [0, 1, 2, 6, 7, 8]
        np.testing.assert_array_equal(g[:, rel], wc[:, rel])
        assert (np.abs(g - wc) <= 1e-2).mean() >= 0.99
        assert (g != wc).sum() <= 2 * (mc != wc).sum()


def test_pe_mlp_pool_packed_plain_matches_jax():
    """Row 13's twin against ``pe_mlp_pool_packed(interpret=True)``: on JAX's
    own channels within 1e-5 of the output's max (the same bf16 products,
    float32 sums in another order; measured 9.2e-7), and on the port's
    channels at the pooled rows' gates. Both tiers are present."""
    _, p = grouping(512, 256)
    want, jchunks = jax_row("v3", 512, 256)
    nudged, _ = jax_row("v3", 512, 256, True)
    tiers = tpf.chunk_tiers(p["total2"], 64)
    assert (tiers == 1).any() and (tiers > 1).any()
    given = tpf.pe_mlp_pool_packed_plain([t(c).to(torch.bfloat16) for c in jchunks], p["total2"], *tmlps()).numpy()
    assert np.abs(given - want).max() <= 1e-5 * np.abs(want).max()
    chunks, _ = tpf.pe_channels_packed(p["g2"], p["w1"], p["w2"], p["center"], R1, R2)
    got = tpf.pe_mlp_pool_packed_plain(chunks, p["total2"], *tmlps()).numpy()
    assert_rows_within_jax_spread(got, want, nudged)


def test_pe_fused_gather_t_matches_jax():
    """Row 12 on the CPU is PE-v5's plain pair: equal to ``pe_fused_v5``'s
    twin bit for bit, and within the pooled rows' gates of
    ``pe_fused_gather_t(interpret=True)``."""
    _, p = grouping(512, 256)
    args = (p["planes"], p["idx"], p["w1"], p["w2"], p["total2"], p["center"])
    (Ws1, bs1), (Ws2, bs2) = tmlps()
    got = tpf.pe_fused_gather_t(*args, Ws1, bs1, Ws2, bs2, R1, R2, None)
    assert torch.equal(got, tpf.pe_fused_v5(*args, Ws1, bs1, Ws2, bs2, R1, R2, None))
    assert_rows_within_jax_spread(got.numpy(), jax_row("gather_t", 512, 256), jax_row("gather_t", 512, 256, True))


def test_pe_fused_packed_t_plain_matches_jax():
    """Row 11's twin on the slot-major slots against
    ``pe_fused_packed_t(interpret=True)`` (blocks on the 64-slot and the
    full tier)."""
    _, p = grouping(512, 256)
    sm = lambda x: x.transpose(1, 2).contiguous()
    tiers = tpf.slot_tiers(p["total2"], 256)
    assert (tiers == 64).any() and (tiers == 256).any()
    got = tpf.pe_fused_packed_t_plain(tuple(map(sm, p["g2"])), sm(p["w1"]), sm(p["w2"]), p["total2"], p["center"],
                                      *tmlps(), R1, R2).numpy()
    assert_rows_within_jax_spread(got, jax_row("packed_t", 512, 256), jax_row("packed_t", 512, 256, True))


def test_packed_pe_twins_refuse_larger_budgets():
    """An S2 past the cloud's N (768 slots on 512 points) or not a multiple
    of 256 (384) raises in each of the four twins, with no fallback; JAX's
    gates admit neither (``tests/test_torch_pe_s768.py`` runs S2 768 on 768
    points)."""
    _, p = grouping(512, 256)
    sm = lambda x: x.transpose(1, 2).contiguous()
    for width in (768, 384):
        wide = lambda x: torch.cat([x, x, x], dim=-1)[..., :width]
        g2, w1, w2 = tuple(map(wide, p["g2"])), wide(p["w1"]), wide(p["w2"])
        chunks, _ = tpf.pe_channels_packed(g2, w1, w2, p["center"], R1, R2)
        calls = (
            lambda: tpf.pe_fused_packed_plain(g2, w1, w2, p["total2"], p["center"], *tmlps(), R1, R2),
            lambda: tpf.pe_mlp_pool_packed_plain(chunks, p["total2"], *tmlps()),
            lambda: tpf.pe_fused_gather_t(p["planes"], wide(p["idx"]), w1, w2, p["total2"], p["center"],
                                          *tmlps()[0], *tmlps()[1], R1, R2, None),
            lambda: tpf.pe_fused_packed_t_plain(tuple(map(sm, g2)), sm(w1), sm(w2), p["total2"], p["center"],
                                                *tmlps(), R1, R2),
        )
        for call in calls:
            with pytest.raises(ValueError):
                call()
