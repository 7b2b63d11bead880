"""Debug drawing (counterpart of ``unopose_tpu/utils/vis.py``): a 3D scatter
of one or two clouds, and a projected 3D box. matplotlib and cv2 are
imported inside the functions, so that training without them never loads
them (the card's machine has no matplotlib)."""

from __future__ import annotations

import numpy as np


def plot_3d(pts1: np.ndarray, pts2: np.ndarray | None = None, title: str = "", save_path: str | None = None):
    """Scatter one or two (N, 3) clouds in 3D axes; saved to ``save_path``
    (and the path returned) or the figure returned."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    p1 = np.asarray(pts1)
    ax.scatter(p1[:, 0], p1[:, 1], p1[:, 2], s=1, c="tab:blue", label="pts1")
    if pts2 is not None:
        p2 = np.asarray(pts2)
        ax.scatter(p2[:, 0], p2[:, 1], p2[:, 2], s=1, c="tab:orange", label="pts2")
    ax.set_title(title)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def project_bbox3d(bbox_3d: np.ndarray, K: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The 8 object-frame box corners (8, 3) in pixels (8, 2) under the pose (R, t) and camera K."""
    cam = bbox_3d @ np.asarray(R).T + np.asarray(t).reshape(1, 3)
    uv = cam @ np.asarray(K).T
    return uv[:, :2] / uv[:, 2:3]


def draw_projected_box3d(image: np.ndarray, qs: np.ndarray, color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """Draw a projected box (8, 2) on the image: corners 0-3 the front face, 4-7 the back face."""
    import cv2

    img = np.ascontiguousarray(image)
    qs = qs.astype(np.int32)
    for k in range(4):
        i, j = k, (k + 1) % 4
        cv2.line(img, tuple(qs[i]), tuple(qs[j]), color, thickness)
        i, j = k + 4, (k + 1) % 4 + 4
        cv2.line(img, tuple(qs[i]), tuple(qs[j]), color, thickness)
        cv2.line(img, tuple(qs[k]), tuple(qs[k + 4]), color, thickness)
    return img
