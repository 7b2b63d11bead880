"""ctypes bindings of the host library (``unopose_tpu_torch/native/hostops.cpp``).

``build()`` compiles it with the system C++ compiler into
``native/_build/`` (``native/build.sh``); ``_load`` does so at first use,
and again when the source is newer than the library. Every entry point
has a numpy version, used where the library cannot be built, with the
same results (``rasterize_depth`` returns None there and the renderer
takes its numpy oracle).
"""

from __future__ import annotations

import ctypes
import logging
import os.path as osp
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "native")
_SOURCE = osp.join(_NATIVE_DIR, "hostops.cpp")
_LIB_PATH = osp.join(_NATIVE_DIR, "_build", "libhostops.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> str:
    """Compile the library (raises on a failed build); returns its path."""
    subprocess.run(["sh", osp.join(_NATIVE_DIR, "build.sh")], check=True, capture_output=True, timeout=300)
    return _LIB_PATH


def _stale() -> bool:
    return not osp.exists(_LIB_PATH) or osp.getmtime(_LIB_PATH) < osp.getmtime(_SOURCE)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if _stale():
            build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.rle_decode.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.rle_decompress_counts.restype = ctypes.c_int64
        lib.mask_nonzero.restype = ctypes.c_int64
        lib.bbox_of_mask.restype = ctypes.c_int
        _lib = lib
    except Exception as e:  # pragma: no cover
        logger.warning("host library unavailable (%s); using the numpy versions", e)
    return _lib


def have_native() -> bool:
    return _load() is not None


def rle_decode(counts, size) -> np.ndarray:
    """Uncompressed RLE counts -> bool (H, W) mask (Fortran-order runs)."""
    lib = _load()
    h, w = size
    total = int(h * w)
    if lib is None:
        flat = np.zeros(total, dtype=bool)
        pos = 0
        for i, c in enumerate(counts):
            if i % 2 == 1:
                flat[pos : pos + c] = True
            pos += c
        return flat.reshape(h, w, order="F")
    c_arr = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(total, dtype=np.uint8)
    lib.rle_decode(
        c_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(c_arr)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(total),
    )
    return out.astype(bool).reshape(h, w, order="F")


def rle_decompress_counts(s: str, max_counts: Optional[int] = None) -> np.ndarray:
    """COCO compressed RLE string -> int64 counts."""
    lib = _load()
    if max_counts is None:
        max_counts = len(s) + 1
    if lib is None:
        counts, i = [], 0
        while i < len(s):
            x, k, more = 0, 0, True
            while more:
                c = ord(s[i]) - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(counts) > 2:
                x += counts[-2]
            counts.append(x)
        return np.asarray(counts, np.int64)
    buf = s.encode("ascii") if isinstance(s, str) else bytes(s)
    out = np.empty(max_counts, dtype=np.int64)
    n = lib.rle_decompress_counts(
        ctypes.c_char_p(buf),
        ctypes.c_int64(len(buf)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(max_counts),
    )
    if n < 0:
        raise ValueError("malformed compressed RLE")
    return out[:n]


def mask_nonzero(mask: np.ndarray) -> np.ndarray:
    """Flat row-major indices of nonzero mask pixels."""
    lib = _load()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    if lib is None:
        return np.flatnonzero(m)
    out = np.empty(m.size, dtype=np.int64)
    n = lib.mask_nonzero(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(m.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[:n]


def backproject_choose(depth_crop, bbox, choose, K) -> np.ndarray:
    """Backproject chosen crop pixels to (n, 3) camera points in one pass
    over the n pixels (the full-image meshgrid, crop and gather in one)."""
    lib = _load()
    y0, _, x0, _ = bbox
    d = np.ascontiguousarray(depth_crop, dtype=np.float32)
    h, w = d.shape
    ch = np.ascontiguousarray(choose, dtype=np.int64)
    if lib is None:
        r, c = ch // w, ch % w
        z = d.reshape(-1)[ch]
        return np.stack(
            [(c + x0 - K[0, 2]) * z / K[0, 0], (r + y0 - K[1, 2]) * z / K[1, 1], z], axis=1
        ).astype(np.float32)
    out = np.empty((len(ch), 3), dtype=np.float32)
    lib.backproject_choose(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(h),
        ctypes.c_int64(w),
        ctypes.c_int64(int(y0)),
        ctypes.c_int64(int(x0)),
        ch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(ch)),
        ctypes.c_float(float(K[0, 0])),
        ctypes.c_float(float(K[1, 1])),
        ctypes.c_float(float(K[0, 2])),
        ctypes.c_float(float(K[1, 2])),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def rasterize_depth(cam_verts: np.ndarray, faces: np.ndarray, K: np.ndarray, h: int, w: int) -> Optional[np.ndarray]:
    """Exact triangle z-buffer depth of a camera-space mesh (native only).

    Returns the (h, w) float32 depth map (0 = background), or ``None`` where
    the library is unavailable: the caller then takes the numpy oracle
    (``eval/renderer.py:rasterize_exact``), which computes the same values
    per pixel.
    """
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(cam_verts, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    out = np.empty(int(h) * int(w), dtype=np.float32)
    lib.rasterize_depth(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(v)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(f)),
        ctypes.c_float(float(K[0, 0])),
        ctypes.c_float(float(K[1, 1])),
        ctypes.c_float(float(K[0, 2])),
        ctypes.c_float(float(K[1, 2])),
        ctypes.c_int64(int(h)),
        ctypes.c_int64(int(w)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out.reshape(int(h), int(w))
