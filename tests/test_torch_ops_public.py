"""The public ops the port took last, and the pose-recovery example, against
the JAX package (CPU).

``ops/__init__.py`` exports the counterparts of ``unopose_tpu/ops``'s names
(but the TPU-only ``fps_pallas`` and ``fps_xla``). Each new op runs on the
same numpy inputs in both packages: the ball query and its grouping equal
index for index, the rotation conversions and the LRF within float32
rounding (the tolerance is stated in each case). ``examples/
pose_recovery_synthetic_torch.py:run`` recovers a known pose on the CPU at
a small size within its own limits.
"""

import importlib.util
import os.path as osp

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import unopose_tpu.ops as jops
import unopose_tpu_torch.ops as tops
from unopose_tpu.ops import rotation as jrot
from unopose_tpu_torch.ops import rotation as trot

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) <= tol


def clouds(seed=0, b=2, n=300, p=40):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.3, 0.3, size=(b, n, 3)).astype(np.float32)
    return xyz, xyz[:, :p].copy(), rng.normal(size=(b, n, 5)).astype(np.float32)


def rotations(seed=1, n=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[: n // 8, 1:] *= 1e-7  # near-identity rotations: the conversions' small-angle branches
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32)


CASES = ["exports", "ball_query", "query_and_group", "quat_to_rotmat", "mat_to_quat", "axangle", "angle_deg",
         "random_so3", "batch_lrf", "largest_eigvec", "l2_similarity"]


@pytest.mark.parametrize("case", CASES)
def test_public_op_matches_jax(case):
    if case == "exports":
        public = {n for n in dir(jops) if not n.startswith("_") and callable(getattr(jops, n))}
        assert public - {"fps_pallas", "fps_xla"} <= set(dir(tops))
    elif case == "ball_query":  # indices equal, pads and empty balls included (r 0.05: some balls hold 1 point)
        xyz, new, _ = clouds()
        for r, k in ((0.05, 8), (0.15, 32), (0.3, 128)):
            want = np.asarray(jops.ball_query(r, k, jnp.asarray(xyz), jnp.asarray(new)))
            got = tops.ball_query(r, k, t(xyz), t(new))
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), (r, k)
    elif case == "query_and_group":  # gathers and one subtraction: equal; the division by the radius too
        xyz, new, feats = clouds()
        for kw in (dict(), dict(features=feats), dict(features=feats, use_xyz=False), dict(normalize_xyz=True)):
            jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
            tkw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
            wg, wi = jops.query_and_group(0.15, 16, jnp.asarray(xyz), jnp.asarray(new), **jkw)
            gg, gi = tops.query_and_group(0.15, 16, t(xyz), t(new), **tkw)
            assert np.array_equal(gi.numpy(), np.asarray(wi)) and np.array_equal(gg.numpy(), np.asarray(wg)), kw
        assert np.array_equal(tops.group_points(t(feats), gi).numpy(), np.asarray(jops.group_points(
            jnp.asarray(feats), jnp.asarray(gi.numpy()))))
    elif case == "quat_to_rotmat":  # products of unit-quaternion entries: 1e-6
        q = rotations()
        assert close(tops.quat_to_rotmat(t(q)), jops.quat_to_rotmat(jnp.asarray(q)), 1e-6)
    elif case == "mat_to_quat":  # a root and a division of float32 entries: 1e-5
        R = np.asarray(jops.quat_to_rotmat(jnp.asarray(rotations())))
        assert close(trot.mat_to_quat(t(R)), jrot.mat_to_quat(jnp.asarray(R)), 1e-5)
    elif case == "axangle":  # Rodrigues 1e-6; the angle 1e-5 rad (arccos near 1), the axis 1e-4 (divided by sin)
        rng = np.random.default_rng(2)
        axis = rng.normal(size=(64, 3)).astype(np.float32)
        ang = rng.uniform(0.01, 3.1, size=64).astype(np.float32)
        R = trot.axangle_to_mat(t(axis), t(ang))
        assert close(R, jrot.axangle_to_mat(jnp.asarray(axis), jnp.asarray(ang)), 1e-6)
        R = np.asarray(jops.quat_to_rotmat(jnp.asarray(rotations())))
        (ta, tg), (ja, jg) = trot.mat_to_axangle(t(R)), jrot.mat_to_axangle(jnp.asarray(R))
        assert close(tg, jg, 1e-5) and close(ta[tg > 1e-3], np.asarray(ja)[tg.numpy() > 1e-3], 1e-4)
    elif case == "angle_deg":  # arccos of a trace: 1e-3 degrees
        R = np.asarray(jops.quat_to_rotmat(jnp.asarray(rotations())))
        R2 = np.asarray(jops.quat_to_rotmat(jnp.asarray(rotations(seed=3))))
        assert close(trot.rotation_angle_deg(t(R), t(R2)), jrot.rotation_angle_deg(jnp.asarray(R), jnp.asarray(R2)),
                     1e-3)
    elif case == "random_so3":  # another generator's bits: rotations of the same form, orthonormal
        gen = torch.Generator().manual_seed(0)
        R = tops.random_so3(gen, (5, 7)).double()
        assert R.shape == (5, 7, 3, 3)
        assert torch.allclose(R @ R.transpose(-1, -2), torch.eye(3, dtype=torch.float64), atol=1e-5)
        assert torch.allclose(torch.linalg.det(R), torch.ones(5, 7, dtype=torch.float64), atol=1e-5)
        Rj = np.asarray(jops.random_so3(jax.random.PRNGKey(0), (5, 7)))
        assert Rj.shape == tuple(R.shape)
    elif case == "batch_lrf":  # the same frames: 1e-5 of the unit-scaled coordinates
        xyz, new, _ = clouds(n=200, p=20)
        grouped = np.asarray(jops.query_and_group(0.3, 64, jnp.asarray(xyz), jnp.asarray(new))[0]) + new[:, :, None]
        want = jops.batch_lrf(jnp.asarray(new), jnp.asarray(grouped), 0.3)
        assert close(tops.batch_lrf(t(new), t(grouped), 0.3), want, 1e-5)
    elif case == "largest_eigvec":  # up to sign, 1e-5
        rng = np.random.default_rng(4)
        a = rng.normal(size=(32, 3, 5)).astype(np.float32)
        A = (a @ a.transpose(0, 2, 1)).astype(np.float32)
        got = tops.largest_eigvec_sym3(t(A)).numpy()
        want = np.asarray(jops.largest_eigvec_sym3(jnp.asarray(A)))
        assert close(got * np.sign((got * want).sum(-1, keepdims=True)), want, 1e-5)
    else:  # sqrt(2 - 2 x.y) of normalised features / temp: float32 rounding, 1e-5 of its max
        rng = np.random.default_rng(5)
        f1, f2 = (rng.normal(size=(2, 30, 16)).astype(np.float32) for _ in range(2))
        want = np.asarray(jops.compute_feature_similarity(jnp.asarray(f1), jnp.asarray(f2), "L2", 0.1))
        got = tops.compute_feature_similarity(t(f1), t(f2), 0.1, sim_type="L2")
        assert close(got, want, 1e-5 * np.abs(want).max())
        assert close(tops.pairwise_dist(t(f1), t(f2)), jops.pairwise_dist(jnp.asarray(f1), jnp.asarray(f2)), 1e-5)


def test_pose_recovery_example_on_the_cpu():
    """The example's ``run`` at B 2, N 256 on the CPU: FPS 196 distinct
    points, the grouping finite, both solvers within its 1 degree and 0.02
    on the oracle attention, and a finite pose on the all-zero probe."""
    spec = importlib.util.spec_from_file_location(
        "pose_recovery_synthetic_torch", osp.join(ROOT, "examples", "pose_recovery_synthetic_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.run("cpu", batch=2, npts=256, log=lambda *a: None)
    assert max(out["coarse_rot_deg"] + out["fine_rot_deg"]) < mod.ROT_LIMIT_DEG
    assert max(out["coarse_trans"] + out["fine_trans"]) < mod.TRANS_LIMIT
    assert out["zero_probe_finite"] and out["grouped_finite"]
