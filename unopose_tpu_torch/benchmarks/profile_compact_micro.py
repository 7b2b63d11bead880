"""The three parts of the first_k grouping's compaction stage, timed alone (counterpart of
``benchmarks/profile_compact_micro.py``).

    python -m unopose_tpu_torch.benchmarks.profile_compact_micro [--iters 10]

The script's blocks are ROWS = 256 rows of C x W = 4 x 512 int32 words with K2 = 256 outputs a row; each
function here takes any leading shape of such rows. Integers only: kernel and twin agree exactly.

- ``compact_rounds`` (its ``_k_rounds``): on each 512-word chunk, ``nrounds`` LSB-first shift rounds (s = 1,
  2, 4, ...): w_in[j] = work[(j + s) mod 512] (``pltpu.roll`` by 512 - s), a word moves in where w_in has
  bit s and j < 512 - s, stays where it lacks bit s, else is cleared; the XOR of the four chunks, its first
  256 words.
- ``compact_gather`` (its ``_k_gather``): out[r, j] = x[r, bi * 128 + li] where 0 <= bi < 16, else 0; li
  must lie in [0, 128), as the script draws it (not checked).
- ``compact_wherechain`` (the prefix search ``kern`` of its ``wherechain``): 16 prefixes
  pref[k] = sum(li[r, :128] * (k + 1)) % 64, c_of[j] = #{k < 15 : pref[k] + k <= j},
  out[r, j] = c_of * 64 + (j - pref[c_of]).

CPU tensors take the plain twins, CUDA tensors the kernels of ``csrc/compact_micro.cu``. ``main()`` builds
the script's inputs with numpy (256 blocks: words in [0, 2^20), li in [0, 128), bi in [0, 16)), times the
four timings of the script through ``_timing`` and prints their JSON of ms per call.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from unopose_tpu_torch.benchmarks._timing import card, timed_loop
from unopose_tpu_torch.kernels import build

ROWS, W, C, K2 = 256, 512, 4, 256
B = 256  # the script's grid blocks
BANKS = C * W // 128


def _rows(t: torch.Tensor, width: int, name: str) -> int:
    if t.dtype != torch.int32 or t.dim() < 1 or t.shape[-1] != width:
        raise ValueError(f"{name} must be int32 rows of {width}, got {t.dtype} {tuple(t.shape)}")
    return t.numel() // width


def compact_rounds_plain(x: torch.Tensor, nrounds: int) -> torch.Tensor:
    """(..., 2048) int32 -> (..., 256) int32 (module docstring)."""
    rows = _rows(x, C * W, "x")
    xs = x.reshape(rows, C * W)
    j = torch.arange(W, device=x.device)
    acc = torch.zeros((rows, W), dtype=torch.int32, device=x.device)
    for c in range(C):
        work = xs[:, c * W:(c + 1) * W]
        s = 1
        for _ in range(nrounds):
            w_in = torch.roll(work, -s, dims=1)
            move_in = ((w_in & s) != 0) & (j < W - s)
            work = torch.where(move_in, w_in - s, torch.where((work & s) == 0, work, torch.zeros_like(work)))
            s *= 2
        acc ^= work
    return acc[:, :K2].reshape(x.shape[:-1] + (K2,))


def compact_rounds_cuda(x: torch.Tensor, nrounds: int) -> torch.Tensor:
    """The kernel: one warp per row, a chunk's words in registers, the rolled word from shared memory."""
    rows = _rows(x, C * W, "x")
    if not 1 <= nrounds <= 9 or x.device.type != "cuda":
        raise ValueError(f"compact_rounds_cuda takes 1..9 rounds on a CUDA tensor, got {nrounds} on {x.device}")
    x = x.contiguous()
    out = torch.empty(x.shape[:-1] + (K2,), dtype=torch.int32, device=x.device)
    build.launch("compact_rounds", "unopose_compact_rounds", (x, out), rows, nrounds)
    return out


def compact_rounds(x: torch.Tensor, nrounds: int) -> torch.Tensor:
    fn = compact_rounds_plain if x.device.type == "cpu" else compact_rounds_cuda
    return fn(x, nrounds)


def compact_gather_plain(x: torch.Tensor, li: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    """x (..., 2048), li and bi (..., 256) int32 -> (..., 256) int32 (module docstring)."""
    rows = _rows(x, C * W, "x")
    if _rows(li, K2, "li") != rows or _rows(bi, K2, "bi") != rows:
        raise ValueError(f"li and bi must hold {rows} rows of {K2}")
    valid = (bi >= 0) & (bi < BANKS)
    idx = torch.where(valid, bi * 128 + li, torch.zeros_like(li)).long().reshape(rows, K2)
    vals = torch.gather(x.reshape(rows, C * W), 1, idx).reshape(li.shape)
    return torch.where(valid, vals, torch.zeros_like(vals))


def gather_sectors(li: torch.Tensor, bi: torch.Tensor) -> int:
    """The distinct 32-byte sectors of x (8 words each) that ``compact_gather`` reads for these draws: a row's
    words bi * 128 + li where 0 <= bi < 16."""
    rows = _rows(li, K2, "li")
    li, bi = li.reshape(rows, K2), bi.reshape(rows, K2)
    per_row = C * W // 8
    sector = torch.arange(rows, device=li.device).unsqueeze(1) * per_row + (bi * 128 + li) // 8
    touched = torch.zeros(rows * per_row, dtype=torch.bool, device=li.device)
    touched[sector[(bi >= 0) & (bi < BANKS)]] = True
    return int(touched.sum())


def compact_gather_cuda(x: torch.Tensor, li: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    """The kernel: a thread per 8 quads of outputs, every index load issued before the gathers."""
    rows = _rows(x, C * W, "x")
    if _rows(li, K2, "li") != rows or _rows(bi, K2, "bi") != rows:
        raise ValueError(f"li and bi must hold {rows} rows of {K2}")
    dev = x.device
    if dev.type != "cuda" or li.device != dev or bi.device != dev:
        raise ValueError("compact_gather_cuda needs all tensors on one CUDA device")
    x, li, bi = x.contiguous(), li.contiguous(), bi.contiguous()
    out = torch.empty_like(li)
    build.launch("compact_gather", "unopose_compact_gather", (x, li, bi, out), rows)
    return out


def compact_gather(x: torch.Tensor, li: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    fn = compact_gather_plain if x.device.type == "cpu" else compact_gather_cuda
    return fn(x, li, bi)


def compact_wherechain_plain(li: torch.Tensor) -> torch.Tensor:
    """(..., 256) int32 -> (..., 256) int32 (module docstring)."""
    _rows(li, K2, "li")
    base = li[..., :128]
    pref = [(base * (k + 1)).sum(-1, keepdim=True) % 64 for k in range(16)]
    j = torch.arange(K2, device=li.device)
    c_of = sum((pref[k] + k <= j).long() for k in range(15))
    cumb = pref[0].expand_as(c_of)
    for k in range(1, 16):
        cumb = torch.where(c_of == k, pref[k], cumb)
    return (c_of * 64 + (j - cumb)).to(torch.int32)


def compact_wherechain_cuda(li: torch.Tensor) -> torch.Tensor:
    """The kernel: one warp per row, the 16 sums by warp reduction."""
    rows = _rows(li, K2, "li")
    if li.device.type != "cuda":
        raise ValueError(f"compact_wherechain_cuda needs a CUDA tensor, got {li.device}")
    li = li.contiguous()
    out = torch.empty(li.shape, dtype=torch.int32, device=li.device)
    build.launch("compact_wherechain", "unopose_compact_wherechain", (li, out), rows)
    return out


def compact_wherechain(li: torch.Tensor) -> torch.Tensor:
    fn = compact_wherechain_plain if li.device.type == "cpu" else compact_wherechain_cuda
    return fn(li)


def script_inputs(rng: np.random.Generator, blocks: int = B) -> dict:
    """The script's inputs, draw for draw: x (blocks, 256, 2048) in [0, 2^20), li (blocks, 256, 256) in
    [0, 128), bi (blocks, 256, 256) in [0, 16). numpy int32."""
    x = rng.integers(0, 1 << 20, size=(blocks, ROWS, C * W)).astype(np.int32)
    li = rng.integers(0, 128, size=(blocks, ROWS, K2)).astype(np.int32)
    bi = rng.integers(0, BANKS, size=(blocks, ROWS, K2)).astype(np.int32)
    return dict(x=x, li=li, bi=bi)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10, help="chained calls a timed loop")
    args = parser.parse_args(argv)
    dev = card()
    d = {k: torch.from_numpy(v).to(dev) for k, v in script_inputs(np.random.default_rng(0)).items()}
    print(f"backend: {torch.cuda.get_device_name(dev)}", flush=True)

    def timed(name, fn, *xs):
        return timed_loop(name, fn, *xs, k=args.iters) * 1e3

    as_int = lambda e: e.to(torch.int32)
    results = {
        "rounds9x4": timed("rounds 9x4 (production)", lambda e, xx: compact_rounds(xx + as_int(e), 9), d["x"]),
        "rounds7x4": timed("rounds 7x4 (subgroup)", lambda e, xx: compact_rounds(xx + as_int(e), 7), d["x"]),
        "gather_2x16": timed("gather 2 pieces x 16 banks",
                             lambda e, xx, l, b: compact_gather(xx + as_int(e), l, b), d["x"], d["li"], d["bi"]),
        "wherechain_15": timed("prefix-search 15cmp+15sel", lambda e, l: compact_wherechain(l + as_int(e)), d["li"]),
    }
    print(json.dumps({k: round(v, 2) for k, v in results.items()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
