"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, with the
device code they share in ``csrc/*.cuh``).

The sources are compiled at first use with ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface, cached under ``kernels/_build/`` by a hash of the
sources and flags, and loaded with ``ctypes``. Every entry point takes raw
device pointers and the CUDA stream as integers and returns the
``cudaError_t`` of its launch; :func:`check` turns a non-zero code into an
exception. A missing compiler or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CUDA_ROOTS = ("/usr/local/cuda",)
# -fmad=false for every source: the kernels repeat their plain PyTorch twins'
# float32 arithmetic one rounded operation at a time (FPS and the select
# bit for bit, the embedding and the LRF channels to the last bit but for
# the order of the slot sums); tensor-core products are unaffected.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "unopose_fps": [_P, _P, _I, _I, _I, _P],
    "unopose_gather_planar": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, ctypes.c_longlong, _P],
    # pts, pts_p, perm, inv_perm, B, N, k1, k2, r1sq, r2sq, 8 outputs, stream
    "unopose_first_k_select": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float]
    + [_P] * 8
    + [_P],
    # pts, ref_vec, tab_d, tab_a, qscale, out, B, N, k, T, D, bf16_weights, sd, sa, factor_a, stream
    "unopose_geo_rpe": [_P] * 6 + [_I] * 6 + [_F] * 3 + [_P],
    # xp, yp, zp, idx_p, w1, w2, total2, cx, cy, cz, out, B, N, P, S2, r1, r2, 1/r1, 1/r2, stream
    "unopose_pe_channels": [_P] * 11 + [_I] * 4 + [_F] * 4 + [_P],
    # chans, w1, w2, total2, wpack, bpack, out, points, S2, stream
    "unopose_pe_mlp_pool": [_P] * 7 + [ctypes.c_longlong, _I, _P],
    # q, k, v, out, B, N, heads, hd, batch stride, row stride, bf16, scale, stream
    "unopose_mha_fused": [_P] * 4 + [_I] * 4 + [ctypes.c_longlong] * 2 + [_I, _F, _P],
    # f1n, f2n, cm, cs, B, M1, M2, C, stream
    "unopose_fine_colstats": [_P] * 4 + [_I] * 4 + [_P],
    # f1n, f2n, cm, cs, s1, s2, rm, rs, label1, keys, B, M1, M2, C, stream
    "unopose_fine_labels": [_P] * 10 + [_I] * 4 + [_P],
    # f1n, f2n, cm, cs, s1, s2, rm, rs, label1, label2, pts2, wsum, num, B, M1, M2, C, stream
    "unopose_fine_accum": [_P] * 13 + [_I] * 4 + [_P],
    # chans, w0, w1, w2, gb, bn, partial, cap, B, P, S, depth, eps, stream
    "unopose_pe_train_stats": [_P] * 7 + [_I] * 5 + [_F, _P],
    # chans, w0, w1, w2, bn, partial, cap, B, P, S, depth, sums, stream
    "unopose_pe_train_stats_partial": [_P] * 6 + [_I] * 5 + [_P, _P],
    # sums, gb, bn, depth, n, eps, stream
    "unopose_pe_train_stats_finish": [_P] * 3 + [_I, ctypes.c_double, _F, _P],
    # chans, w0, w1, w2, bn, pooled, cnt, B, P, S, stream
    "unopose_pe_train_fwd": [_P] * 7 + [_I] * 3 + [_P],
    # chans, w0, w1, w2, bn, pooled, cnt, dpool, partial, cap, B, P, S, depth, stream
    "unopose_pe_train_bwd_sums": [_P] * 9 + [_I] * 5 + [_P],
    # chans, w0, w1, w2, bn, pooled, cnt, dpool, partial, cap, dw, B, P, S, stream
    "unopose_pe_train_bwd_dw": [_P] * 9 + [_I, _P] + [_I] * 3 + [_P],
    # chans, w0, w1, w2, bn, pooled, cnt, dpool, partial, cap, dw, B, P, S, stream
    "unopose_pe_train_frozen_bwd": [_P] * 9 + [_I, _P] + [_I] * 3 + [_P],
    # kernel (11, 12, 13, 14, 18), depth (K11, K13; K12 3, K14 and K18 0), warps an SM (out)
    "unopose_pe_train_resident_warps": [_I, _I, _P],
    # pts, perm, gx, gy, gz, d2, valid, B, N, S, r2, stream
    "unopose_ball_group_subset": [_P] * 7 + [_I] * 3 + [_F, _P],
    # pts1, rs, ts, tp, model, w1, dsum, B, P2, N1, N2, mode, stream
    "unopose_hyp_select": [_P] * 7 + [_I] * 5 + [_P],
    # g1x, g1y, g1z, m1, g2x, g2y, g2z, m2, cx, cy, cz, wpack, bpack, out, points, S1, S2, r1, r2, 1/r1, 1/r2, stream
    "unopose_pe_masked": [_P] * 14 + [ctypes.c_longlong, _I, _I] + [_F] * 4 + [_P],
    # gx, gy, gz, w1, w2, total2, cx, cy, cz, wpack, bpack, out, B, P, S2, r1, r2, 1/r1, 1/r2, stream
    "unopose_pe_packed": [_P] * 12 + [_I] * 3 + [_F] * 4 + [_P],
    "unopose_pe_packed_t": [_P] * 12 + [_I] * 3 + [_F] * 4 + [_P],
    # c0, c1, c2, c3, total2, wpack, bpack, out, B, P, w, ld, stream
    "unopose_pe_mlp_pool_packed": [_P] * 8 + [_I] * 4 + [_P],
    # xp, yp, zp, idx_p, w1, w2, total2, cx, cy, cz, wpack, bpack, out, B, N, P, S2, r1, r2, 1/r1, 1/r2, stream
    "unopose_pe_gather_fused": [_P] * 13 + [_I] * 4 + [_F] * 4 + [_P],
    # gx, gy, gz, mask, cx, cy, cz, wpack, bpack, out, points, S2, mode, r1, r2, 1/r1, 1/r2, stream
    "unopose_profile_r9": [_P] * 10 + [ctypes.c_longlong, _I, _I] + [_F] * 4 + [_P],
    # gx, gy, gz, w1, w2, cx, cy, cz, wpack, bpack, out, B, P, S2, drop, r1, r2, 1/r1, 1/r2, stream
    "unopose_pe_ablate": [_P] * 11 + [_I] * 4 + [_F] * 4 + [_P],
    # x, out, rows, nrounds, stream
    "unopose_compact_rounds": [_P, _P, _I, _I, _P],
    # x, li, bi, out, rows, stream
    "unopose_compact_gather": [_P] * 4 + [_I, _P],
    # li, out, rows, stream
    "unopose_compact_wherechain": [_P, _P, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: under ``$CUDA_HOME``, ``$CUDA_PATH`` or ``CUDA_ROOTS``, else on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*_sources(), *sorted(CSRC.glob("*.cuh"))]:  # the sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libunopose_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every compiler process; raise on the first that failed."""
    logs, failed = [], None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
    if failed:
        raise KernelBuildError(failed)
    return "".join(logs)


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _compile(target: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    objs = [target.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in _sources()]
    try:
        log = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]) for src, o in zip(_sources(), objs)])
        log += _run([_start([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, target)  # atomic: a concurrent loader never sees a partial file
    return log


def load() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            build_log = _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def launch(name: str, entry: str, tensors, *scalars) -> None:
    """Call the C entry point ``entry`` with the tensors' pointers, then the
    scalars and the stream of the first tensor's device; raise on its error
    code, else count the launch under ``name``."""
    from unopose_tpu_torch.kernels import LAUNCHES

    ptr = ctypes.c_void_p
    with on_device(tensors[0].device):
        err = getattr(load(), entry)(*(ptr(t.data_ptr()) for t in tensors), *scalars, ptr(stream_of(tensors[0])))
    check(err, name)
    LAUNCHES[name] += 1


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle (the
    raw query: ``torch.cuda.current_stream`` builds a Stream object, a few
    microseconds a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(dev):
    """``torch.cuda.device(dev)``, or nothing when ``dev`` is already the
    current device (the common case, which then costs no device switch)."""
    import contextlib

    import torch

    return contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)
