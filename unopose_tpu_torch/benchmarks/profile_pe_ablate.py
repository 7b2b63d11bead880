"""The packed PE's fast path with parts of its work dropped, timed (counterpart of
``benchmarks/profile_pe_ablate.py``).

    python -m unopose_tpu_torch.benchmarks.profile_pe_ablate [ONLY] [--iters 10] [--out FILE]

``pe_ablate`` is the script's TPU kernel ``kernel``: per point of the materialised packed first_k grouping
(three (B, P, S2) slot planes, both scales' bf16 multiset weights w1 / w2), only the first S2 / 2 slots; rel
xyz and each scale's LRF weighted by its multiset weights (w1 at r1, w2 at r2); the 12 channels rounded to
bf16; each scale's folded MLP 6 -> 32 -> 64 -> 128 (bf16 operands, float32 sums, bias, ReLU, bf16 after each
layer); the max over the slots of the features times the 0/1 mask w > 0 -> (B, P, 256) float32. ``drop``
takes out parts of the work, as the script does, its numbers deliberately wrong (timing only), and the twin
and the kernel repeat them: "lrf" (frames rel xyz at scale 1, 2 x rel xyz at scale 2), "stack" (every
channel of every slot the rel x of the first slot of the first point of the point's 64-point block), "mlp"
(every feature 0.5 x the bf16 rel-x channel), "pool" (row i of each 64-point block the features of the
block's first point's slot i). The 64-point blocks (the script's ``p_blk``) are part of the function. CPU
tensors take the plain twin, CUDA tensors the kernel ``csrc/pe_ablate.cu``, which takes the seven sets of
``ALL_DROPS``.

``main()`` builds the script's clouds with numpy (2 x 16 clouds of 2048 points uniform in the unit ball), the
PE's weights from a torch seed (folded BatchNorm) and the grouping (``two_scale_group_first_k_packed`` at
0.1 / 64 and 0.2 / 256), times each set (``ONLY``: those whose name holds it) through ``_timing`` and prints
the JSON of ms per call; with ``--out`` it also writes it there (the JAX script writes beside itself).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from unopose_tpu_torch.benchmarks._timing import card, timed_loop
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.lrf import batch_lrf_planar
from unopose_tpu_torch.ops.pe_fused import _check_cuda, _check_packed, _check_weights, _chunked_mlp_max

B, P = 16, 2048
R1, R2, K1, K2 = 0.1, 0.2, 64, 256
P_BLK = 64
ALL_DROPS = (
    (),
    ("lrf",),
    ("stack",),
    ("mlp",),
    ("pool",),
    ("lrf", "stack", "mlp", "pool"),
    ("lrf", "stack", "pool"),
)
DROP_BITS = {"lrf": 1, "stack": 2, "mlp": 4, "pool": 8}


def set_name(drop) -> str:
    return "fast_drop_" + ("+".join(drop) or "none")


def _check(grouped2, w1, w2, center, drop):
    if tuple(drop) not in ALL_DROPS:
        raise ValueError(f"drop must be one of {ALL_DROPS}, got {drop!r}")
    shape = tuple(w1.shape)
    if len(shape) != 3 or any(tuple(t.shape) != shape for t in (*grouped2, w2)) or any(
            tuple(c.shape) != shape[:2] for c in center):
        raise ValueError(f"the slots and weights must be (B, P, S2) and the centres (B, P), got "
                         f"{[tuple(t.shape) for t in (*grouped2, w1, w2)]}, {[tuple(c.shape) for c in center]}")
    if shape[1] % P_BLK or shape[2] % 64 or not 2 * P_BLK <= shape[2] <= 256:
        raise ValueError(f"P must be a multiple of {P_BLK} and S2 one of 128, 192, 256, got {shape[1:]}")


def _mlp(chans, Ws, bs) -> torch.Tensor:
    """(..., 6) bf16 channels -> (..., 128) bf16-valued float32: each slot through the folded MLP."""
    h = chans.float()
    for W, b in zip(Ws, bs):
        h = torch.relu(torch.matmul(h, W.to(torch.bfloat16).float()) + b.float()).to(torch.bfloat16).float()
    return h


def pe_ablate_plain(grouped2, w1, w2, center, mlp1, mlp2, drop, r1: float = R1, r2: float = R2) -> torch.Tensor:
    """The plain twin: three (B, P, S2) slot planes, both (B, P, S2) multiset weights, three (B, P) centres
    and each scale's folded (Ws, bs) -> (B, P, 256) float32 (module docstring)."""
    _check(grouped2, w1, w2, center, drop)
    _check_weights(mlp1, mlp2)
    Bc, Pc, S = w1.shape
    h2 = S // 2
    g = [x[..., :h2].float() for x in grouped2]
    rel = [gi - c.float()[..., None] for gi, c in zip(g, center)]
    m1, m2 = w1[..., :h2].float(), w2[..., :h2].float()
    if "lrf" in drop:
        l1, l2 = rel, [r * 2.0 for r in rel]
    else:
        l1 = batch_lrf_planar(center, g, r1, mask=m1, use_newton=True)
        l2 = batch_lrf_planar(center, g, r2, mask=m2, use_newton=True)
    chans = torch.stack([*rel, *l1, *rel, *l2], dim=-1)  # (B, P, h2, 12)
    if "stack" in drop:  # the first slot's rel x of each block's first point, everywhere in the block
        first = rel[0][:, ::P_BLK, 0].repeat_interleave(P_BLK, dim=1)
        chans = first[..., None, None].expand(-1, -1, h2, 12)
    chans = chans.to(torch.bfloat16)
    if "pool" in drop:  # row i of a block: its first point's slot i
        rows = chans.reshape(Bc, Pc // P_BLK, P_BLK, h2, 12)[:, :, 0, :P_BLK]
        if "mlp" in drop:
            feats = (rows[..., :1] * 0.5).float().expand(-1, -1, -1, 256)
        else:
            feats = torch.cat([_mlp(rows[..., :6], *mlp1), _mlp(rows[..., 6:], *mlp2)], dim=-1)
        return feats.reshape(Bc, Pc, 256).contiguous()
    keep1, keep2 = m1 > 0, m2 > 0
    if "mlp" in drop:
        v = chans[..., 0] * 0.5
        f1, f2 = ((v * k.to(torch.bfloat16)).amax(-1).float()[..., None] for k in (keep1, keep2))
        return torch.cat([f1.expand(-1, -1, 128), f2.expand(-1, -1, 128)], dim=-1)
    return torch.cat([_chunked_mlp_max(chans[..., :6], *mlp1, keep=keep1),
                      _chunked_mlp_max(chans[..., 6:], *mlp2, keep=keep2)], dim=-1)


def pe_ablate_cuda(grouped2, w1, w2, center, packed, drop, r1: float = R1, r2: float = R2) -> torch.Tensor:
    """The kernel (``csrc/pe_ablate.cu``): one warp per point (per 64-point block with the pool dropped);
    ``packed``: both scales' ``pack_mlp``."""
    _check(grouped2, w1, w2, center, drop)
    wpack, bpack = _check_packed(packed)
    _check_cuda("pe_ablate_cuda", (*grouped2, w1, w2, *center, wpack, bpack))
    Bc, Pc, S = w1.shape
    g = [x.float().contiguous() for x in grouped2]
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    c = [x.float().contiguous() for x in center]
    out = torch.empty((Bc, Pc, 256), dtype=torch.float32, device=w1.device)
    build.launch("pe_ablate", "unopose_pe_ablate", (*g, w1, w2, *c, wpack, bpack, out), Bc, Pc, S,
                 sum(DROP_BITS[d] for d in drop), float(r1), float(r2), float(1.0 / r1), float(1.0 / r2))
    return out


def pe_ablate(grouped2, w1, w2, center, mlp1, mlp2, drop, packed=None, r1: float = R1,
              r2: float = R2) -> torch.Tensor:
    """(B, P, 256) float32, dispatched by device: the plain twin reads ``mlp1``/``mlp2``, the kernel their
    ``pack_mlp`` (``packed``)."""
    if w1.device.type == "cpu":
        return pe_ablate_plain(grouped2, w1, w2, center, mlp1, mlp2, drop, r1, r2)
    return pe_ablate_cuda(grouped2, w1, w2, center, packed, drop, r1, r2)


def script_clouds(rng: np.random.Generator) -> np.ndarray:
    """The script's clouds, draw for draw: (2B, P, 3) float32 uniform in [-1, 1]^3, each cloud divided by its
    largest norm."""
    pts = rng.uniform(-1, 1, size=(2 * B, P, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(axis=1, keepdims=True)
    return pts


def script_grouping(pts: torch.Tensor) -> dict:
    """The grouping the script times its kernel on, and the PE weights: the slots, weights, hit counts,
    centres and overflow flag of ``two_scale_group_first_k_packed``, and the PE's folded weights (seed 0)."""
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import two_scale_group_first_k_packed

    torch.manual_seed(0)
    pe = FinePositionalEncoding(out_dim=256, r1=R1, r2=R2, nsample1=K1, nsample2=K2, fused=True).to(pts.device)
    mlp1, mlp2, packed = pe.folded_weights()
    with torch.no_grad():
        g2, w1, w2, total2, overflow = two_scale_group_first_k_packed(R1, K1, R2, K2, pts)
    return dict(g2=g2, w1=w1, w2=w2, total2=total2, overflow=bool(overflow), center=tuple(pts.unbind(-1)),
                mlp1=mlp1, mlp2=mlp2, packed=packed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("only", nargs="?", help="time only the sets whose name holds this")
    parser.add_argument("--iters", type=int, default=10, help="chained calls a timed loop")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args(argv)
    dev = card()
    pts = torch.from_numpy(script_clouds(np.random.default_rng(0))).to(dev)
    print(f"backend: {torch.cuda.get_device_name(dev)}", flush=True)
    d = script_grouping(pts)
    t2 = d["total2"]
    fast = (t2.view(t2.shape[0], -1, P_BLK).amax(-1) <= K2 // 2).float().mean().item()
    print(f"overflow={d['overflow']} total2 max={int(t2.max())} fast-blocks={fast:.3f}", flush=True)

    results = {}
    for drop in ALL_DROPS:
        name = set_name(drop)
        if args.only is not None and args.only not in name:
            continue
        timed_loop(name,
                   lambda e, g, a, b, c, drop=drop: pe_ablate((g[0] + e, g[1], g[2]), a, b, c, d["mlp1"], d["mlp2"],
                                                              drop, d["packed"]),
                   d["g2"], d["w1"], d["w2"], d["center"], k=args.iters, results=results)
    print(json.dumps(results), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
