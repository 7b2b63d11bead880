"""Minimal PLY mesh reader, ascii and binary little-endian (counterpart of
``unopose_tpu/eval/ply.py``): vertices (N, 3) and faces (M, 3), the
evaluator's needs; normals, colours and texture coordinates are skipped."""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": ("i1", 1),
    "uchar": ("u1", 1),
    "short": ("i2", 2),
    "ushort": ("u2", 2),
    "int": ("i4", 4),
    "int32": ("i4", 4),
    "uint": ("u4", 4),
    "uint32": ("u4", 4),
    "float": ("f4", 4),
    "float32": ("f4", 4),
    "double": ("f8", 8),
    "float64": ("f8", 8),
}


def load_ply(path: str):
    """Returns dict with 'pts' (N, 3) float64 and 'faces' (M, 3) int64
    (faces may be empty)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a PLY file: {path}"
        fmt = None
        elements = []  # list of (name, count, [(prop_name, type) or ('list', idx_t, cnt_t, name)])
        cur = None
        while True:
            line = f.readline().strip().decode("ascii", errors="replace")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[1], parts[2]))
            elif line.startswith("end_header"):
                break

        pts = np.zeros((0, 3))
        faces = np.zeros((0, 3), np.int64)
        for name, cnt, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(cnt)]
                if name == "vertex":
                    xi = [i for i, p in enumerate(props) if p[1] in ("x", "y", "z")]
                    pts = np.asarray([[float(r[i]) for i in xi] for r in rows])
                elif name == "face":
                    faces = np.asarray([[int(v) for v in r[1:4]] for r in rows], np.int64)
            else:
                assert fmt == "binary_little_endian", fmt
                if name == "vertex" and all(p[0] != "list" for p in props):
                    dtype = np.dtype([(f"p{i}", "<" + _PLY_TYPES[p[0]][0]) for i, p in enumerate(props)])
                    data = np.frombuffer(f.read(dtype.itemsize * cnt), dtype=dtype)
                    names = [p[1] for p in props]
                    cols = [data[f"p{names.index(ax)}"] for ax in ("x", "y", "z")]
                    pts = np.stack(cols, axis=1).astype(np.float64)
                elif name == "face":
                    # assume a single list property (vertex_indices)
                    lst = props[0]
                    cnt_t, idx_t = _PLY_TYPES[lst[1]], _PLY_TYPES[lst[2]]
                    out = np.zeros((cnt, 3), np.int64)
                    for i in range(cnt):
                        n = int(np.frombuffer(f.read(cnt_t[1]), "<" + cnt_t[0])[0])
                        idx = np.frombuffer(f.read(idx_t[1] * n), "<" + idx_t[0])
                        out[i] = idx[:3]
                    faces = out
                else:
                    # skip unknown fixed-size element
                    size = sum(_PLY_TYPES[p[0]][1] for p in props if p[0] != "list")
                    f.read(size * cnt)
    return {"pts": pts, "faces": faces}
