"""Parity of the PyTorch port's ops against the JAX package (CPU).

On the CPU every kernel wrapper runs its plain PyTorch twin; these tests
hold each twin against the JAX function it replaces, and against the TPU
Pallas kernel itself where that kernel runs in interpret mode:

- FPS: indices equal to ``fps_pallas(interpret=True)`` and to ``fps_xla``;
- the planar gather: bitwise equal to the JAX ``gather_planar``;
- the first_k select: bitwise equal on every output to the XLA branch of
  ``_first_k_budget_select(global_compact=True)``, and equal as per-row
  multisets to the TPU keys + compaction kernels in interpret mode (which
  order the slots by lane instead).

The numeric ops (eig3, LRF, Procrustes, solvers) are compared on
well-conditioned inputs at float32 reassociation tolerances.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unopose_tpu_torch.ops import ball_query as tbq
from unopose_tpu_torch.ops import eig3 as teig
from unopose_tpu_torch.ops import geometry as tgeo
from unopose_tpu_torch.ops import lrf as tlrf
from unopose_tpu_torch.ops import procrustes as tpro
from unopose_tpu_torch.ops import solver as tsol
from unopose_tpu_torch.ops.fps import fps, fps_plain, gather_points
from unopose_tpu_torch.ops.gather import gather_planar

jbq = importlib.import_module("unopose_tpu.ops.ball_query")
jfps = importlib.import_module("unopose_tpu.ops.fps")
jgather = importlib.import_module("unopose_tpu.ops.gather_pallas")
jeig = importlib.import_module("unopose_tpu.ops.eig3")
jgeo = importlib.import_module("unopose_tpu.ops.geometry")
jlrf = importlib.import_module("unopose_tpu.ops.lrf")
jpro = importlib.import_module("unopose_tpu.ops.procrustes")
jsol = importlib.import_module("unopose_tpu.ops.solver")


def t(x):
    return torch.from_numpy(np.array(x))


def surface_cloud(rng, B, N, radius=0.5, noise=2e-3):
    """LRF-normalised-like surface clouds: a bumpy sphere of ``radius``."""
    v = rng.normal(size=(B, N, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    bump = 1.0 + 0.2 * np.sin(3.0 * v[..., 0] + 1.0) * np.cos(2.0 * v[..., 1])
    return (radius * bump[..., None] * v + rng.normal(size=(B, N, 3)) * noise).astype(np.float32)


def random_rotations(rng, B):
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def rot_err(Ra, Rb):
    d = np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)
    return float((np.linalg.norm(d, axis=(-2, -1)) / np.sqrt(2.0)).max())


# ------------------------------------------------------------------ FPS (K1)
@pytest.mark.parametrize("B,N,k", [(2, 300, 40), (3, 256, 64)])
def test_fps_matches_tpu_kernel_and_xla(rng, B, N, k):
    """Index-equal to the TPU kernel (interpret mode; N=300 exercises its
    padding) and to the XLA loop."""
    pts = surface_cloud(rng, B, N)
    got = fps(t(pts), k)
    assert got.dtype == torch.int32 and got.shape == (B, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfps.fps_pallas(jnp.asarray(pts), k, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfps.fps_xla(jnp.asarray(pts), k)))


def test_fps_first_occurrence_on_ties():
    """Duplicated points tie exactly; the smallest index wins, as jnp.argmax."""
    pts = np.zeros((1, 8, 3), np.float32)
    pts[0, :, 0] = [0, 3, 3, 1, 1, -3, -3, 2]
    np.testing.assert_array_equal(fps_plain(t(pts), 4).numpy(), np.asarray(jfps.fps_xla(jnp.asarray(pts), 4)))


def test_gather_points_matches_jax(rng):
    data = rng.normal(size=(2, 40, 5)).astype(np.float32)
    idx = rng.integers(0, 40, size=(2, 7, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_points(t(data), t(idx)).numpy(), np.asarray(jfps.gather_points(jnp.asarray(data), jnp.asarray(idx)))
    )


# --------------------------------------------------------- planar gather (K2)
@pytest.mark.parametrize("idx_dtype", [np.int16, np.int32])
def test_gather_planar_bitwise(rng, idx_dtype):
    B, N, P, S = 2, 256, 64, 32
    planes = rng.normal(size=(3, B, N)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, P, S)).astype(idx_dtype)
    got = gather_planar(*(t(p) for p in planes), t(idx))
    want = jgather.gather_planar(*(jnp.asarray(p) for p in planes), jnp.asarray(idx))
    for g, w in zip(got, want):
        assert g.shape == (B, P, S)
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


# ---------------------------------------------------------- first_k select (K3)
R1, K1, R2, K2 = 0.1, 64, 0.2, 256


def _select_pair(pts, **jax_kw):
    js = jbq._first_k_budget_select(R1, K1, R2, K2, jnp.asarray(pts), tbq.CHUNKS, global_compact=True, **jax_kw)
    ts = tbq.first_k_budget_select(R1, K1, R2, K2, t(pts))
    return js, ts


@pytest.mark.parametrize("kind", ["surface", "overflow"])
def test_first_k_select_bitwise_vs_xla_branch(rng, kind):
    """Every output of the plain select equals the XLA branch bit for bit,
    including the truncated slot order of an overflowing cloud."""
    if kind == "surface":
        pts = surface_cloud(rng, 2, 512, radius=0.6)
    else:
        pts = rng.uniform(-0.06, 0.06, size=(2, 256, 3)).astype(np.float32)
    js, ts = _select_pair(pts, fused_keys=False, interpret=False)
    assert bool(ts["overflow"]) == (kind == "overflow")
    for k in tbq.SELECT_KEYS:
        np.testing.assert_array_equal(ts[k].numpy().astype(np.int64), np.asarray(js[k]).astype(np.int64), err_msg=k)
    for g, w in zip(ts["g2"], js["g2"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for a, b in zip(tbq.packed_multiset_weights(ts, K1, K2), jbq._packed_multiset_weights(js, K1, K2)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_first_k_select_multiset_vs_tpu_kernels(rng):
    """Against the TPU pair (_first_k_keys_pallas int8-mask mode +
    _compact_stage_pallas, interpret mode), which orders slots by lane:
    equal per-row multisets of valid slots and of r1 slots, equal counts,
    first hits, pad index and overflow."""
    pts = surface_cloud(rng, 1, 256, radius=0.4)
    js, ts = _select_pair(pts, fused_keys=True, interpret=True)
    assert not bool(ts["overflow"]) and not bool(js["overflow"])
    for k in ("cnt1", "enc1", "total2", "q_first"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
    ti, tv, tm = ts["idx_p"].numpy().astype(np.int64), ts["validslot"].numpy(), ts["m1slot"].numpy()
    ji, jv, jm = np.asarray(js["idx_p"]).astype(np.int64), np.asarray(js["validslot"]), np.asarray(js["m1slot"])
    for b in range(ti.shape[0]):
        for n in range(ti.shape[1]):
            np.testing.assert_array_equal(np.sort(ti[b, n][tv[b, n]]), np.sort(ji[b, n][jv[b, n]]))
            np.testing.assert_array_equal(np.sort(ti[b, n][tm[b, n]]), np.sort(ji[b, n][jm[b, n]]))
            np.testing.assert_array_equal(np.sort(ti[b, n]), np.sort(ji[b, n]))  # pads too


def test_exact_fallback_matches_jax(rng):
    """Two independent first-k ball queries padded with the first hit."""
    pts = surface_cloud(rng, 2, 256, radius=0.3)
    got = tbq.two_scale_group_exact_planar(R1, K1, R2, K2, t(pts))
    want = jbq.two_scale_group_exact_planar(R1, K1, R2, K2, jnp.asarray(pts))
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = np.asarray(jgeo.pairwise_sqdist(jnp.asarray(pts), jnp.asarray(pts))) < R2 * R2
    np.testing.assert_array_equal(
        tbq.first_k_in_radius(t(mask), K2).numpy(), np.asarray(jbq._first_k_in_radius(jnp.asarray(mask), K2))
    )


# ------------------------------------------------------------ geometry, eig3, LRF
def test_geometry_matches_jax(rng):
    x = rng.normal(size=(2, 30, 3)).astype(np.float32) + np.float32(0.6)
    y = rng.normal(size=(2, 20, 3)).astype(np.float32) + np.float32(0.6)
    np.testing.assert_allclose(
        tgeo.pairwise_sqdist(t(x), t(y)).numpy(), np.asarray(jgeo.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y))),
        atol=2e-6,
    )
    f1 = rng.normal(size=(2, 30, 16)).astype(np.float32)
    f2 = rng.normal(size=(2, 20, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.compute_feature_similarity(t(f1), t(f2), temp=0.1).numpy(),
        np.asarray(jgeo.compute_feature_similarity(jnp.asarray(f1), jnp.asarray(f2), temp=0.1)), atol=1e-5,
    )


def test_eig3_matches_jax(rng):
    """Symmetric matrices with separated eigenvalues: eigenvectors 1e-5."""
    Q = random_rotations(rng, 64)
    lam = np.sort(rng.uniform(0.1, 1.0, size=(64, 3)), axis=-1)[:, ::-1] * np.array([1.0, 0.5, 0.1])
    A = (Q * lam[:, None, :].astype(np.float32)) @ np.swapaxes(Q, 1, 2)
    np.testing.assert_allclose(teig.eigvals_sym3(t(A)).numpy(), np.asarray(jeig.eigvals_sym3(jnp.asarray(A))), atol=1e-6)
    np.testing.assert_allclose(
        teig.smallest_eigvec_sym3(t(A)).numpy(), np.asarray(jeig.smallest_eigvec_sym3(jnp.asarray(A))), atol=1e-5
    )
    entries = [A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]]
    for a, b in zip(teig.smallest_eigvec_sym3_planar(*map(t, entries)),
                    jeig.smallest_eigvec_sym3_planar(*map(jnp.asarray, entries))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_global_lrf_matches_jax(rng):
    """Anisotropic clouds (well-separated covariance eigenvalues)."""
    pts = (rng.normal(size=(3, 200, 3)) * np.array([0.1, 0.05, 0.02]) + np.array([0, 0, 0.6])).astype(np.float32)
    pts = pts @ random_rotations(rng, 3)
    np.testing.assert_allclose(tlrf.global_lrf(t(pts)).numpy(), np.asarray(jlrf.global_lrf(jnp.asarray(pts))), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_batch_lrf_planar_matches_jax(rng, masked):
    """Planar patches (a well-defined normal and x-axis), with and without
    multiplicity weights: 1e-4 on the LRF coordinates."""
    B, P, M = 2, 16, 64
    u = rng.uniform(-0.1, 0.1, size=(B, P, M, 2))
    patch = np.concatenate([u * np.array([1.0, 0.6]), 0.3 * u[..., :1] ** 2 + 0.02 * u[..., 1:] ** 3], -1)
    grouped = (patch @ random_rotations(rng, B)[:, None]).astype(np.float32)
    center = grouped[:, :, 0]
    cen = tuple(center[..., i] for i in range(3))
    grp = tuple(grouped[..., i] for i in range(3))
    w = rng.integers(0, 3, size=(B, P, M)).astype(np.float32) if masked else None
    w_t = None if w is None else t(w).to(torch.bfloat16)
    w_j = None if w is None else jnp.asarray(w, jnp.bfloat16)
    got = tlrf.batch_lrf_planar(tuple(map(t, cen)), tuple(map(t, grp)), 0.2, mask=w_t)
    want = jlrf.batch_lrf_planar(tuple(map(jnp.asarray, cen)), tuple(map(jnp.asarray, grp)), 0.2, mask=w_j)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


# ------------------------------------------------------------------ Procrustes
def test_weighted_procrustes_matches_jax(rng):
    B, N = 4, 50
    src = rng.normal(size=(B, N, 3)).astype(np.float32)
    R = random_rotations(rng, B)
    tr = rng.normal(size=(B, 3)).astype(np.float32)
    ref = src @ np.swapaxes(R, 1, 2) + tr[:, None] + rng.normal(size=(B, N, 3)).astype(np.float32) * 0.01
    w = rng.uniform(0, 1, size=(B, N)).astype(np.float32)
    Rt, tt = tpro.weighted_procrustes(t(src), t(ref), t(w), weight_thresh=0.1)
    Rj, tj = jpro.weighted_procrustes(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(w), weight_thresh=0.1)
    assert rot_err(Rj, Rt) < 1e-5
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    assert rot_err(R, Rt) < 0.05


# --------------------------------------------------------------------- solvers
def test_searchsorted_cdf_matches_numpy_and_jax(rng):
    cum = np.cumsum(rng.uniform(0, 1, size=(2, 1000)), axis=1)
    cum = (cum / cum[:, -1:]).astype(np.float32)
    r = rng.uniform(size=(2, 300)).astype(np.float32)
    got = tsol.searchsorted_cdf(t(cum), t(r)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsol.searchsorted_cdf(jnp.asarray(cum), jnp.asarray(r))))
    np.testing.assert_array_equal(got, np.stack([np.searchsorted(cum[b], r[b], side="left") for b in range(2)]))


def _matching(rng, B, n, sharp):
    """Clouds related by a known pose and a similarity peaked on the true
    correspondences: a well-conditioned solve."""
    pts2 = surface_cloud(rng, B, n, radius=0.5)
    R = random_rotations(rng, B)
    tr = rng.normal(size=(B, 3)).astype(np.float32) * 0.1
    perm = np.stack([rng.permutation(n) for _ in range(B)])
    pts1 = np.take_along_axis(pts2, perm[..., None], 1) @ np.swapaxes(R, 1, 2) + tr[:, None]
    pts1 = pts1 + rng.normal(size=pts1.shape) * 5e-3  # no exact fit: the pose score stays finite
    atten = rng.normal(size=(B, n + 1, n + 1)).astype(np.float32)
    atten[np.arange(B)[:, None], np.arange(1, n + 1)[None], perm + 1] += sharp
    score = rng.uniform(0.6, 1.0, size=(B, 2 * n)).astype(np.float32)
    return atten, score, pts1.astype(np.float32), pts2, R, tr


def test_coarse_solver_matches_jax_same_uniforms(rng, monkeypatch):
    """The same atten/scores/clouds and the same uniforms: the JAX pose within
    1e-4 rad and 1e-5, and both near the true pose."""
    atten, score, pts1, pts2, R, tr = _matching(rng, 2, 24, sharp=12.0)
    uniforms = rng.uniform(size=(2, 3 * 200)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(uniforms))
    Rj, tj, sj = jsol.compute_coarse_Rt_overlap(jax.random.PRNGKey(0), *map(jnp.asarray, (atten, score, pts1, pts2)),
                                                None, 200, 30)
    Rt, tt, st = tsol.compute_coarse_Rt_overlap(*map(t, (atten, score, pts1, pts2)), 200, 30, uniforms=t(uniforms))
    assert rot_err(Rj, Rt) < 1e-4
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    # the score is 1 / mean nearest distance, each from the expansion-form d2,
    # whose cancellation leaves ~1e-5 relative noise on small distances
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4)
    assert rot_err(R, Rt) < 0.05  # triplet fits to noisy points: near the true pose


def test_coarse_solver_generator_draws(rng):
    """Without uniforms the draws come from the given generator: the same
    seed gives the same pose."""
    atten, score, pts1, pts2, _, _ = _matching(rng, 2, 16, sharp=8.0)
    args = tuple(map(t, (atten, score, pts1, pts2)))
    outs = [tsol.compute_coarse_Rt_overlap(*args, 100, 20, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tsol.compute_coarse_Rt_overlap(*args, 100, 20, uniforms=torch.rand(2, 7))


def test_fine_solver_matches_jax(rng):
    atten, score, pts1, pts2, R, tr = _matching(rng, 2, 64, sharp=30.0)
    out_t = tsol.compute_fine_Rt_overlap(*map(t, (atten, score, pts1, pts2)))
    out_j = jsol.compute_fine_Rt_overlap(*map(jnp.asarray, (atten, score, pts1, pts2)), None, return_aux=True)
    assert rot_err(out_j[0], out_t[0]) < 1e-4
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert rot_err(R, out_t[0]) < 0.05


def test_dual_softmax_assignment_matches_jax(rng):
    atten, score, *_ = _matching(rng, 2, 20, sharp=5.0)
    got = tsol.dual_softmax_assignment(t(atten), t(score), 20, 20)
    want = jsol._dual_softmax_assignment(jnp.asarray(atten), jnp.asarray(score), 20, 20)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-7)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
