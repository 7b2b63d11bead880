"""The least time one H100 could take for the work of the TPU profiling kernels in ``benchmarks/`` that no
path of the model reaches, and that the port therefore does not carry.

    python -m unopose_tpu_torch.tools.tpu_profile_bounds

Worked out from each kernel's shapes and code alone (no card is needed; nothing is measured): the bytes it must
move, each input read once and each output written once, over the card's memory rate, and its operations over
the peak rate for their type; the bound is the larger. The products of the fine PE's MLP count 2 x (6*32 +
32*64 + 64*128) bf16 operations a slot and scale (the block-diagonal packing's zero blocks decide nothing);
32-bit integer operations go at 64 a clock an SM (CUDA programming guide, compute capability 9.0). The
integer-operation counts of the three compaction kernels are estimates, a few operations for each line of
their code, not a count of compiled instructions; their rows say so. The shapes are the benchmarks' own
(``SHAPES``). Prints one JSON line: each kernel's call site, bytes, operations, bound in ms and what bounds it.
"""

from __future__ import annotations

import json

HBM_BPS, BF16_FLOPS = 3.35e12, 989e12  # NVIDIA's H100 SXM data sheet, dense
INT32_RATE = 64 * 132 * 1.98e9  # 32-bit integer results a second: 64 a clock an SM, 132 SMs, 1980 MHz
MLP_FLOP = 2 * (6 * 32 + 32 * 64 + 64 * 128)  # one slot through one scale's MLP


# each benchmark's shapes as its source sets them: batch and points (both clouds of each of B pairs in the PE
# ablation), the slot budget; the compaction micro-kernels' grid blocks of (ROWS, C x W) words and K2 outputs
SHAPES = {
    "benchmarks/profile_pe_ablate.py": {"B": 16, "P": 2048, "nsample2": 256},
    "benchmarks/profile_compact_micro.py": {"B": 256, "ROWS": 256, "W": 512, "C": 4, "K2": 256},
    "benchmarks/profile_r9.py": {"B": 32, "N": 2048, "S2": 256},
}
ESTIMATED = ("benchmarks/profile_compact_micro.py:34", "benchmarks/profile_compact_micro.py:54",
             "benchmarks/profile_compact_micro.py:134")


def bounds() -> dict:
    """{call site: (bytes, operations, operations a second)} of each kernel."""
    pe, cm, r9 = SHAPES.values()
    pts = 2 * pe["B"] * pe["P"]
    fast = pts * pe["nsample2"] // 2  # profile_pe_ablate: a point's first S2 / 2 slots on its fast 64-point block
    rows = cm["B"] * cm["ROWS"]  # profile_compact_micro: blocks of (ROWS rows, C x W words)
    words, outs = rows * cm["C"] * cm["W"], rows * cm["K2"]
    prefix = rows * 16 * (2 * 128 + 1)  # 16 per-row sums of 128 products, and a remainder each
    pts9, s9 = r9["B"] * r9["N"], r9["S2"]
    return {
        # planes (3 x f32) and both weights (bf16) of the fast slots, the centres, the (32, 2048, 256) f32 output
        "benchmarks/profile_pe_ablate.py:68": (fast * (3 * 4 + 2 * 2) + pts * 3 * 4 + pts * 256 * 4,
                                               2 * fast * MLP_FLOP, BF16_FLOPS),
        # 9 shift rounds of ~8 operations (roll, two tests, a bound, two selects, a subtraction, an and) a word
        "benchmarks/profile_compact_micro.py:34": (words * 4 + outs * 4, 9 * 8 * words, INT32_RATE),
        # 16 banks of a gather, a compare and a select per output; reads the words and both index tensors
        "benchmarks/profile_compact_micro.py:54": (words * 4 + 3 * outs * 4, 16 * 3 * outs, INT32_RATE),
        # 15 compares, converts and adds, then 15 compares and selects, and 3 more per output; half the indices
        "benchmarks/profile_compact_micro.py:134": (outs // 2 * 4 + outs * 4, 78 * outs + prefix, INT32_RATE),
        # both scales on all 256 slots: the planes (3 x f32), one f32 mask, the centres and the output
        "benchmarks/profile_r9.py:100": (pts9 * s9 * 4 * 4 + pts9 * 3 * 4 + pts9 * 256 * 4,
                                        2 * pts9 * s9 * MLP_FLOP, BF16_FLOPS),
    }


def main() -> int:
    rows = []
    for site, (nbytes, ops, rate) in bounds().items():
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
        rows.append(dict(kernel=site, bytes=nbytes, operations=ops, operations_estimated=site in ESTIMATED,
                         bytes_ms=t_bytes, operations_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations"))
    print(json.dumps({"computed": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
