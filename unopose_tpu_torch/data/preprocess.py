"""Host-side (numpy) preprocessing of the BOP test reader (counterpart of
``unopose_tpu/data/preprocess.py``): image and json IO, uncompressed-RLE
masks, the square bbox of a mask, depth backprojection, the crop-resize
index remap, the bilinear crop resize and ImageNet normalisation.
Everything returns channels-last arrays, as the model takes (H, W, C).

``imageio`` reads the images where it is importable, as the JAX package
reads them; where it is not (the card's machine has ``cv2`` but no
``imageio``), ``load_im`` reads PNG files with ``data/png.py``. The crop
resize is ``cv2.resize(..., INTER_LINEAR)``, the JAX package's on every
machine that has ``cv2``.
"""

from __future__ import annotations

import json as _json
from pathlib import Path

import numpy as np

import cv2

try:
    import imageio.v2 as imageio
except ImportError:  # pragma: no cover
    imageio = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_json(path):
    return _json.loads(Path(path).read_bytes())


def load_im(path) -> np.ndarray:
    if imageio is not None:
        return np.asarray(imageio.imread(path))
    if str(path).lower().endswith(".png"):
        from unopose_tpu_torch.data.png import read_png

        return read_png(path)
    raise RuntimeError(f"reading {path} needs imageio; without it only PNG files are read")


def rle_to_binary_mask(rle: dict) -> np.ndarray:
    """Uncompressed COCO-style RLE {size: (H, W), counts: [...]} -> bool (H, W):
    Fortran (column-major) order, runs alternate background/foreground.
    Decoded by the host library where it builds (``data/native.py``)."""
    from unopose_tpu_torch.data import native

    return native.rle_decode(rle["counts"], rle["size"])


def binary_mask_to_rle(mask: np.ndarray) -> dict:
    """Inverse of ``rle_to_binary_mask`` (for writing detection jsons)."""
    flat = np.asarray(mask, bool).reshape(-1, order="F")
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"size": list(mask.shape), "counts": counts}


def backproject_np(depth: np.ndarray, K: np.ndarray, bbox=None) -> np.ndarray:
    """Depth (H, W) -> organised cloud (H, W, 3) float32; optional bbox crop
    (y1, y2, x1, x2)."""
    H, W = depth.shape
    X, Y = np.meshgrid(np.arange(W) - K[0, 2], np.arange(H) - K[1, 2])
    cloud = np.stack((X * depth / K[0, 0], Y * depth / K[1, 1], depth), axis=2).astype(np.float32)
    if bbox is not None:
        y1, y2, x1, x2 = bbox
        return cloud[y1:y2, x1:x2]
    return cloud


def get_bbox(label: np.ndarray):
    """Square bbox containing the mask, clipped into the image: [y1, y2, x1, x2]."""
    img_h, img_w = label.shape
    rows = np.any(label, axis=1)
    cols = np.any(label, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    rmax += 1
    cmax += 1
    b = min(max(rmax - rmin, cmax - cmin), min(img_h, img_w))
    center = [int((rmin + rmax) / 2), int((cmin + cmax) / 2)]
    rmin, rmax = center[0] - b // 2, center[0] + b // 2
    cmin, cmax = center[1] - b // 2, center[1] + b // 2
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_h:
        rmin -= rmax - img_h
        rmax = img_h
    if cmax > img_w:
        cmin -= cmax - img_w
        cmax = img_w
    return [rmin, rmax, cmin, cmax]


def get_resize_rgb_choose(choose: np.ndarray, bbox, img_size: int) -> np.ndarray:
    """Remap flat indices of the crop into the resized (img_size, img_size) crop."""
    y1, y2, x1, x2 = bbox
    crop_h = y2 - y1
    crop_w = x2 - x1
    row_idx = choose // crop_h
    col_idx = choose % crop_h
    return (np.floor(row_idx * (img_size / crop_w)) * img_size + np.floor(col_idx * (img_size / crop_h))).astype(
        np.int64
    )


def normalize_rgb(rgb_uint8: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> ImageNet-normalised float32 (H, W, 3), channels last."""
    return ((rgb_uint8.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)


def sample_choose(rng: np.random.Generator, n_avail: int, n_sample: int) -> np.ndarray:
    """Indices with the reference's rule: with replacement where there are
    at most ``n_sample`` to choose from, else without."""
    if n_avail <= n_sample:
        return rng.choice(np.arange(n_avail), n_sample)
    return rng.choice(np.arange(n_avail), n_sample, replace=False)
