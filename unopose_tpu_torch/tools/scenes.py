"""Synthetic scenes with a known pose for the precision gate (numpy only):
the port's copy of ``benchmarks/study_production_path.py:scene_batch`` and
its helpers, draw for draw.

With random weights, features of corresponding pixels in two views are
uncorrelated, so both crops are the same camera view: the query cloud is
the template's own FPS subset (the model's FPS nodes then correspond one
to one, on the same pixels), expressed in a rotated and translated frame,
so that the matchers see strong assignments and the solvers a real pose.
The template is a corner tripod of three tubes of unequal length, which no
rotation maps onto itself, under a smooth texture on a uniform random
background.
"""

from __future__ import annotations

import numpy as np


def surface_cloud(rng: np.random.Generator, b: int, n: int, scale: float = 0.08) -> np.ndarray:
    """(b, n, 3) points on a corner tripod: three orthogonal tubes of lengths
    1, 0.62, 0.34 and radii 0.16, 0.12, 0.09 (times ``scale``), with 0.2 mm
    of noise."""
    lens = np.array([1.0, 0.62, 0.34], np.float32)
    rads = np.array([0.16, 0.12, 0.09], np.float32)
    axis = rng.integers(0, 3, size=(b, n))
    s = rng.uniform(0, 1, size=(b, n)).astype(np.float32) * lens[axis]
    th = rng.uniform(0, 2 * np.pi, size=(b, n)).astype(np.float32)
    rr = rads[axis]
    p = np.zeros((b, n, 3), np.float32)
    for a in range(3):
        m = axis == a
        u, w = (a + 1) % 3, (a + 2) % 3
        p[..., a][m] = s[m]
        p[..., u][m] = rr[m] * np.cos(th[m])
        p[..., w][m] = rr[m] * np.sin(th[m])
    return (p * scale + rng.normal(size=(b, n, 3)) * 2e-4).astype(np.float32)


def rand_rot(rng: np.random.Generator) -> np.ndarray:
    """A (3, 3) float32 rotation from a normalised Gaussian quaternion."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def texture(p: np.ndarray) -> np.ndarray:
    """A smooth 3-channel texture of the coordinates, in [-1, 1]."""
    s = 1.0 / 0.08  # the feature scale against the cloud's size
    return np.stack(
        [
            np.sin(3.7 * s * p[..., 0]) * np.cos(2.3 * s * p[..., 1]),
            np.sin(2.9 * s * p[..., 1]) * np.cos(3.1 * s * p[..., 2]),
            np.sin(4.1 * s * p[..., 2]) * np.cos(1.9 * s * p[..., 0]),
        ],
        -1,
    ).astype(np.float32)


def project(p: np.ndarray, img: int) -> np.ndarray:
    """Orthographic (x, y) -> flat pixel indices of an ``img`` x ``img`` crop, per cloud."""
    lo = p[..., :2].min(axis=1, keepdims=True)
    hi = p[..., :2].max(axis=1, keepdims=True)
    uv = (p[..., :2] - lo) / (hi - lo + 1e-9)
    px = np.clip(np.round(uv[..., 0] * (img - 1)), 0, img - 1)
    py = np.clip(np.round(uv[..., 1] * (img - 1)), 0, img - 1)
    return (py * img + px).astype(np.int32)


def fps_np(p: np.ndarray, m: int) -> np.ndarray:
    """(b, m) farthest-point indices from index 0, as ``ops/fps.py:fps`` picks them."""
    b, n, _ = p.shape
    idx = np.zeros((b, m), np.int64)
    d = ((p - p[:, :1]) ** 2).sum(-1)
    for i in range(1, m):
        idx[:, i] = d.argmax(axis=1)
        picked = np.take_along_axis(p, idx[:, i][:, None, None], 1)
        d = np.minimum(d, ((p - picked) ** 2).sum(-1))
    return idx


def scene_batch(rng: np.random.Generator, b: int, img: int = 224, nq: int = 2048, nt: int = 5000):
    """(inputs, R_gt (b, 3, 3), t_gt (b, 3)): the model's six inputs as numpy
    arrays (rgb / tem1_rgb the same crop, rgb_choose the template pixels of
    the query points, pts the query cloud R_gt p + t_gt + 0.2 mm noise)."""
    tem = surface_cloud(rng, b, nt)
    sel = fps_np(tem, nq)
    R_gt = np.stack([rand_rot(rng) for _ in range(b)])
    t_gt = (rng.normal(size=(b, 3)) * 0.02).astype(np.float32)
    q = (
        np.einsum("bij,bnj->bni", R_gt, np.take_along_axis(tem, sel[..., None], 1))
        + t_gt[:, None]
        + rng.normal(size=(b, nq, 3)).astype(np.float32) * 2e-4
    ).astype(np.float32)
    tem_tex = texture(tem)
    tem_choose = project(tem, img)
    q_choose = np.take_along_axis(tem_choose, sel, axis=1)
    flat = rng.uniform(-1, 1, size=(b, img * img, 3)).astype(np.float32)
    np.put_along_axis(flat, tem_choose[..., None], tem_tex, axis=1)
    crop = flat.reshape(b, img, img, 3)
    inputs = dict(rgb=crop, rgb_choose=q_choose, pts=q, tem1_rgb=crop, tem1_choose=tem_choose, tem1_pts=tem)
    return inputs, R_gt, t_gt
