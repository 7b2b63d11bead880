"""BOP pose-error functions in numpy (counterpart of
``unopose_tpu/eval/pose_error.py``): MSSD, MSPD, VSD, ADD/ADI, projection,
rotation and translation errors, with bop_toolkit's semantics. Units are
BOP's: millimetres, depth images in mm."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def transform_pts(pts: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(N, 3) @ R^T + t; t is (3,) or (3, 1)."""
    return pts @ R.T + t.reshape(1, 3)


def project_pts(pts: np.ndarray, K: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    p = transform_pts(pts, R, t) @ K.T
    return p[:, :2] / p[:, 2:3]


def _sym_poses(R_gt, t_gt, syms):
    for sym in syms:
        yield R_gt @ sym["R"], (R_gt @ sym["t"].reshape(3, 1)).reshape(3) + t_gt.reshape(3)


def mssd(R_est, t_est, R_gt, t_gt, pts, syms) -> float:
    """Maximum Symmetry-Aware Surface Distance (pose_error.py:104-127)."""
    pts_est = transform_pts(pts, R_est, t_est)
    es = []
    for Rs, ts in _sym_poses(R_gt, t_gt, syms):
        es.append(np.linalg.norm(pts_est - transform_pts(pts, Rs, ts), axis=1).max())
    return float(min(es))


def mspd(R_est, t_est, R_gt, t_gt, K, pts, syms) -> float:
    """Maximum Symmetry-Aware Projection Distance (pose_error.py:129-153)."""
    proj_est = project_pts(pts, K, R_est, t_est)
    es = []
    for Rs, ts in _sym_poses(R_gt, t_gt, syms):
        es.append(np.linalg.norm(proj_est - project_pts(pts, K, Rs, ts), axis=1).max())
    return float(min(es))


def add(R_est, t_est, R_gt, t_gt, pts) -> float:
    return float(np.linalg.norm(transform_pts(pts, R_est, t_est) - transform_pts(pts, R_gt, t_gt), axis=1).mean())


def adi(R_est, t_est, R_gt, t_gt, pts) -> float:
    """Mean nearest-neighbor distance (indistinguishable views)."""
    from scipy.spatial import cKDTree

    pts_est = transform_pts(pts, R_est, t_est)
    pts_gt = transform_pts(pts, R_gt, t_gt)
    nn, _ = cKDTree(pts_est).query(pts_gt, k=1)
    return float(nn.mean())


def proj(R_est, t_est, R_gt, t_gt, K, pts) -> float:
    """Average 2D projection distance in px (Brachmann et al., CVPR'16;
    bop_toolkit pose_error.py:225-243)."""
    d = project_pts(pts, K, R_est, t_est) - project_pts(pts, K, R_gt, t_gt)
    return float(np.linalg.norm(d, axis=1).mean())


def re(R_est, R_gt) -> float:
    """Rotation error in degrees."""
    cos = (np.trace(R_est.T @ R_gt) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def te(t_est, t_gt) -> float:
    return float(np.linalg.norm(np.asarray(t_est).reshape(3) - np.asarray(t_gt).reshape(3)))


# ------------------------------------------------------------------ VSD


_RAY_NORM_CACHE: dict = {}


def _ray_norm(K: np.ndarray, H: int, W: int) -> np.ndarray:
    """Per-pixel ||ray|| factor of the depth -> distance conversion, cached
    by (K, H, W): the evaluator converts hundreds of images per camera."""
    key = (K[0, 0], K[1, 1], K[0, 2], K[1, 2], H, W)
    if key not in _RAY_NORM_CACHE:
        if len(_RAY_NORM_CACHE) > 8:
            _RAY_NORM_CACHE.clear()
        xs = (np.arange(W) - K[0, 2]) / K[0, 0]
        ys = (np.arange(H) - K[1, 2]) / K[1, 1]
        _RAY_NORM_CACHE[key] = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2 + 1.0)
    return _RAY_NORM_CACHE[key]


def depth_im_to_dist_im(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Depth (z) image -> distance-from-camera image (misc.py:142-163)."""
    H, W = depth.shape
    return depth * _ray_norm(K, H, W)


def estimate_visib_mask(d_test: np.ndarray, d_model: np.ndarray, delta: float, mode: str = "bop19") -> np.ndarray:
    """Visibility of the rendered model surface (visibility.py:9-42)."""
    d_diff = d_model.astype(np.float32) - d_test.astype(np.float32)
    if mode == "bop19":
        return np.logical_and(np.logical_or(d_diff <= delta, d_test == 0), d_model > 0)
    if mode == "bop18":
        return np.logical_and(d_diff <= delta, np.logical_and(d_test > 0, d_model > 0))
    raise ValueError(mode)


def vsd_from_depths(
    depth_est: np.ndarray,
    depth_gt: np.ndarray,
    depth_test: np.ndarray,
    K: np.ndarray,
    delta: float,
    taus: Sequence[float],
    normalized_by_diameter: bool,
    diameter: float,
    cost_type: str = "step",
) -> List[float]:
    """Visible Surface Discrepancy given rendered model depth images.

    Returns one error per misalignment tolerance tau."""
    return vsd_from_dists(
        depth_im_to_dist_im(depth_est, K),
        depth_im_to_dist_im(depth_gt, K),
        depth_im_to_dist_im(depth_test, K),
        delta,
        taus,
        normalized_by_diameter,
        diameter,
        cost_type,
    )


def vsd_from_dists(
    dist_est: np.ndarray,
    dist_gt: np.ndarray,
    dist_test: np.ndarray,
    delta: float,
    taus: Sequence[float],
    normalized_by_diameter: bool,
    diameter: float,
    cost_type: str = "step",
) -> List[float]:
    """VSD on distance images: the evaluator converts dist_test once per
    image and dist_gt once per GT, and only dist_est per estimate."""
    visib_gt = estimate_visib_mask(dist_test, dist_gt, delta)
    visib_est = estimate_visib_mask(dist_test, dist_est, delta)
    visib_est = np.logical_or(visib_est, np.logical_and(visib_gt, dist_est > 0))

    visib_inter = np.logical_and(visib_gt, visib_est)
    visib_union = np.logical_or(visib_gt, visib_est)
    union_count = int(visib_union.sum())
    comp_count = union_count - int(visib_inter.sum())

    dists = np.abs(dist_gt[visib_inter] - dist_est[visib_inter])
    if normalized_by_diameter:
        dists = dists / diameter

    if union_count == 0:
        return [1.0] * len(taus)
    errors = []
    for tau in taus:
        if cost_type == "step":
            costs = dists >= tau
        elif cost_type == "tlinear":
            costs = np.minimum(dists / tau, 1.0)
        else:
            raise ValueError(cost_type)
        errors.append((float(np.sum(costs)) + comp_count) / union_count)
    return errors


def get_symmetry_transformations(model_info: Dict, max_sym_disc_step: float = 0.01) -> List[Dict]:
    """Discrete + discretized-continuous symmetry transforms
    (bop_toolkit misc.get_symmetry_transformations semantics)."""
    trans_disc = [{"R": np.eye(3), "t": np.zeros(3)}]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.asarray(sym, np.float64).reshape(4, 4)
        trans_disc.append({"R": m[:3, :3], "t": m[:3, 3]})

    trans_cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], np.float64)
        offset = np.asarray(sym.get("offset", [0, 0, 0]), np.float64).reshape(3)
        # (pi * diam) / (max_sym_disc_step * diam) steps over the full circle
        discrete_steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / discrete_steps
        ax = axis / np.linalg.norm(axis)
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        for i in range(discrete_steps):
            c, s = np.cos(i * step), np.sin(i * step)
            R = np.eye(3) + s * Kx + (1 - c) * (Kx @ Kx)
            t = -R @ offset + offset
            trans_cont.append({"R": R, "t": t})

    if not trans_cont:
        return trans_disc
    # combine: continuous applied on top of each discrete (misc.py:80-89)
    out = []
    for d in trans_disc:
        for c in trans_cont:
            out.append({"R": c["R"] @ d["R"], "t": c["R"] @ d["t"].reshape(3) + c["t"]})
    return out
