"""Depth renderers of the VSD error (counterpart of
``unopose_tpu/eval/renderer.py``).

``MeshRasterRenderer``, the evaluator's: an exact triangle z-buffer (the
host library's ``rasterize_depth``, or its numpy oracle
``rasterize_exact``). The JAX package's point-splatting renderer, which the
evaluator does not use, is not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class MeshRasterRenderer:
    """Exact triangle z-buffer renderer, the evaluator's VSD depth source:
    ``add_object`` registers a mesh, ``render_depth`` rasterises its
    triangles under a pose (the host library's ``rasterize_depth``, or the
    numpy oracle ``rasterize_exact`` where the library is unavailable)."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width
        self._models: Dict[int, tuple] = {}

    def add_object(self, obj_id: int, pts: np.ndarray, faces: np.ndarray, diameter: float = 0.0):
        del diameter
        self._models[obj_id] = (
            np.asarray(pts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3),
        )

    def render_depth(self, obj_id: int, R: np.ndarray, t: np.ndarray, K: np.ndarray) -> np.ndarray:
        from unopose_tpu_torch.data import native

        pts, faces = self._models[obj_id]
        cam = pts @ np.asarray(R, np.float32).T + np.asarray(t, np.float32).reshape(1, 3)
        out = native.rasterize_depth(cam, faces, np.asarray(K, np.float64), self.height, self.width)
        if out is not None:
            return out.astype(np.float64)
        return rasterize_exact(pts, faces, R, t, K, self.height, self.width)


def rasterize_exact(pts: np.ndarray, faces: np.ndarray, R, t, K, height: int, width: int) -> np.ndarray:
    """Exact triangle z-buffer in numpy, one face at a time (slow): the
    oracle of ``rasterize_depth``."""
    cam = pts @ np.asarray(R).T + np.asarray(t).reshape(1, 3)
    depth = np.full((height, width), np.inf)
    for f in faces:
        tri = cam[f]
        if np.any(tri[:, 2] <= 1e-6):
            continue
        proj = tri @ np.asarray(K).T
        uv = proj[:, :2] / proj[:, 2:3]
        u0 = max(int(np.floor(uv[:, 0].min())), 0)
        u1 = min(int(np.ceil(uv[:, 0].max())) + 1, width)
        v0 = max(int(np.floor(uv[:, 1].min())), 0)
        v1 = min(int(np.ceil(uv[:, 1].max())) + 1, height)
        if u0 >= u1 or v0 >= v1:
            continue
        gu, gv = np.meshgrid(np.arange(u0, u1) + 0.0, np.arange(v0, v1) + 0.0)
        # barycentric in image space
        x1, y1 = uv[0]
        x2, y2 = uv[1]
        x3, y3 = uv[2]
        det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
        if abs(det) < 1e-12:
            continue
        l1 = ((y2 - y3) * (gu - x3) + (x3 - x2) * (gv - y3)) / det
        l2 = ((y3 - y1) * (gu - x3) + (x1 - x3) * (gv - y3)) / det
        l3 = 1.0 - l1 - l2
        inside = (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        # perspective-correct depth: interpolate 1/z
        zinv = l1 / tri[0, 2] + l2 / tri[1, 2] + l3 / tri[2, 2]
        z = np.where(inside & (zinv > 0), 1.0 / np.maximum(zinv, 1e-12), np.inf)
        win = depth[v0:v1, u0:u1]
        depth[v0:v1, u0:u1] = np.minimum(win, z)
    depth[~np.isfinite(depth)] = 0.0
    return depth
