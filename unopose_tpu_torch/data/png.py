"""PNG reading and writing with the standard library (``zlib``, ``struct``).

The BOP readers take RGB, mask and depth images through ``imageio`` where
it is importable (``data/preprocess.py:load_im``); where it is not, they
read PNG files here: 8- and 16-bit greyscale, greyscale with alpha, RGB
and RGBA, non-interlaced, every filter type. ``write_png`` writes 8-bit
greyscale or RGB and 16-bit greyscale with filter 0 (BOP's image, mask and
depth formats), for synthetic BOP trees.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _paeth_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = raw.astype(np.int64).tolist()
    up = prev.astype(np.int64).tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def _average_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = raw.astype(np.int64).tolist()
    up = prev.astype(np.int64).tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.asarray(out, np.uint8)


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the decompressed image data -> (height, stride) uint8."""
    rows = np.frombuffer(data, np.uint8)[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            row = raw.copy()
        elif kind == 1:  # Sub: a running sum mod 256 along each of the bpp interleaved byte streams
            row = np.zeros(stride, np.int64)
            for k in range(bpp):
                row[k::bpp] = np.cumsum(raw[k::bpp].astype(np.int64))
            row = (row & 0xFF).astype(np.uint8)
        elif kind == 2:
            row = raw + prev
        elif kind == 3:
            row = _average_row(raw, prev, bpp)
        elif kind == 4:
            row = _paeth_row(raw, prev, bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prev = row
    return out


def read_png(path) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 / uint16 array of a non-interlaced PNG
    (greyscale, greyscale + alpha, RGB or RGBA at 8 or 16 bits)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos: pos + 4])
        kind = blob[pos + 4: pos + 8]
        body = blob[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {colour}, bit depth {depth}, interlace {interlace})")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    img = pixels.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, img: np.ndarray) -> None:
    """Write (H, W) uint8 / uint16 greyscale or (H, W, 3) uint8 RGB, filter 0."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        colour, depth, data = 0, 8, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        colour, depth, data = 2, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        colour, depth, data = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"write_png takes (H, W) uint8/uint16 or (H, W, 3) uint8, got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
