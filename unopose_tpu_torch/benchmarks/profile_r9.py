"""Row 10's MLP and pool with the frame skipped or without biases, timed (counterpart of
``benchmarks/profile_r9.py``).

    python -m unopose_tpu_torch.benchmarks.profile_r9 [--iters 10]

``r9_variant`` is the script's TPU kernel ``kern`` (built by ``mk_variant``) in the two modes its ``main()``
runs, per point of (B, N, S2) slots with a float32 0/1 mask: scale 1's channels (rel xyz and, in
``full_nobias``, the mask-weighted LRF at R1; in ``matmul_only``, rel xyz again) and scale 2's (rel xyz and
the LRF over every slot at R2, or rel xyz) each through its own MLP 6 -> 32 -> 64 -> 128 with bf16 operands,
float32 sums, ReLU and a bf16 cast after each layer and no bias; then scale 1's max over the slots whose mask
is > 0 (bf16 -inf where none is) and scale 2's over every slot -> (B, N, 256) float32. CPU tensors take the
plain twin, CUDA tensors the kernel ``csrc/profile_r9.cu``. The script's third mode, ``lrf_only``, does not
trace in JAX and is not ported. Its ``p_blk`` (32, 64, 128) tiles the TPU's grid and changes no output:
``main()`` times the same launch under each of the script's names.

``main()`` builds the script's inputs draw for draw with numpy (32 x 2048 points near a 0.5 sphere, each with
256 slots 0.02 around it, a mask kept with probability 0.2) and its weights (normal x 0.1, zero biases) from
a torch seed, then times row 10's packed PE (kernel ``pe_packed``) and both modes through ``_timing``, and
prints the JSON of ms per call under the script's names.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from unopose_tpu_torch.benchmarks._timing import card, timed_loop
from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.lrf import batch_lrf_planar
from unopose_tpu_torch.ops.pe_fused import _check_cuda, _check_packed, _chunked_mlp_max, pack_mlp, pe_fused_packed

B, N, S2 = 32, 2048, 256
R1, R2 = 0.1, 0.2
MODES = ("matmul_only", "full_nobias")
MLP_SHAPES = ((6, 32), (32, 64), (64, 128))
# the rule where no frame is involved (``bf16_agreement``): the least share of outputs bitwise equal, and the
# most share of outputs past one bf16 ulp of their own value
BF16_EQUAL, BF16_PAST_OWN = 0.999, 1e-4


def _check(grouped, mask, center, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    shape = tuple(mask.shape)
    if len(shape) != 3 or any(tuple(g.shape) != shape for g in grouped) or any(
            tuple(c.shape) != shape[:2] for c in center):
        raise ValueError(f"the slots and mask must be (B, N, S2) and the centres (B, N), got "
                         f"{[tuple(g.shape) for g in grouped]}, {shape}, {[tuple(c.shape) for c in center]}")
    if shape[2] % 32 or not 0 < shape[2] <= 256:
        raise ValueError(f"S2 must be a multiple of 32 up to 256, got {shape[2]}")


def _check_weights(Ws1, Ws2):
    for Ws in (Ws1, Ws2):
        if [tuple(W.shape) for W in Ws] != list(MLP_SHAPES):
            raise ValueError(f"each scale's MLP must be 6 -> 32 -> 64 -> 128, got {[tuple(W.shape) for W in Ws]}")


def _zero_biases(Ws):
    return [torch.zeros(W.shape[1], dtype=torch.float32, device=W.device) for W in Ws]


def pack_nobias(Ws1, Ws2):
    """Both scales' weights as the kernel reads them (``pack_mlp``, zero biases)."""
    _check_weights(Ws1, Ws2)
    return pack_mlp((Ws1, _zero_biases(Ws1)), (Ws2, _zero_biases(Ws2)))


def bf16_agreement(got: torch.Tensor, want: torch.Tensor, row: int = 128) -> dict:
    """Two results of the same bf16 layers with no frame involved (K23 ``matmul_only``, K24's sets that drop
    the frames, the channels or the MLP), their float32 sums taken in another order: a kernel and its twin, or
    the twin and JAX. A bf16 rounding of an inner layer may then land one ulp apart and carry into the next
    layer at that layer's scale, not the output's. Returns the share of outputs bitwise equal (equal
    infinities included), the count past one bf16 ulp of the wanted value (``past_own``), whether every output
    lies within one bf16 ulp of the largest finite wanted output of its ``row`` (``within_row``), the largest
    difference (``err``), and ``ok``, the rule: at least ``BF16_EQUAL`` of the outputs bitwise equal, at most
    ``BF16_PAST_OWN`` of them past one ulp of their own value, and all within one ulp of their row's largest."""
    def ulp(x):  # one bf16 step at |x| >= 1e-30
        return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)

    with torch.no_grad():
        same = got == want
        diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
        finite = torch.where(torch.isfinite(want), want.abs(), torch.zeros_like(want))
        row_max = finite.reshape(-1, row).amax(-1, keepdim=True).expand(-1, row).reshape(want.shape)
        n = got.numel()
        r = dict(entries=n, equal=same.float().mean().item(), err=diff.max().item(),
                 past_own=int((diff > ulp(finite.clamp_min(1e-30))).sum()),
                 within_row=bool((diff <= ulp(row_max.clamp_min(1e-30))).all()))
    r["ok"] = r["equal"] >= BF16_EQUAL and r["past_own"] <= BF16_PAST_OWN * n and r["within_row"]
    return r


def r9_variant_plain(grouped, mask, center, Ws1, Ws2, mode: str, r1: float = R1, r2: float = R2) -> torch.Tensor:
    """The plain twin: three (B, N, S2) slot planes, the (B, N, S2) mask, three (B, N) centres and each scale's
    three weights -> (B, N, 256) float32 (module docstring)."""
    _check(grouped, mask, center, mode)
    _check_weights(Ws1, Ws2)
    mask = mask.float()
    rel = [g.float() - c.float()[..., None] for g, c in zip(grouped, center)]
    if mode == "matmul_only":
        l1 = l2 = rel
    else:
        l1 = batch_lrf_planar(center, grouped, r1, mask=mask, use_newton=True)
        l2 = batch_lrf_planar(center, grouped, r2, mask=torch.ones_like(mask), use_newton=True)
    keep = mask > 0
    f1 = _chunked_mlp_max(torch.stack([*rel, *l1], dim=-1).to(torch.bfloat16), Ws1, _zero_biases(Ws1), keep=keep)
    f1 = torch.where(keep.any(-1, keepdim=True), f1, torch.full_like(f1, float("-inf")))
    f2 = _chunked_mlp_max(torch.stack([*rel, *l2], dim=-1).to(torch.bfloat16), Ws2, _zero_biases(Ws2))
    return torch.cat([f1, f2], dim=-1)


def r9_variant_cuda(grouped, mask, center, packed, mode: str, r1: float = R1, r2: float = R2) -> torch.Tensor:
    """The kernel (``csrc/profile_r9.cu``): one warp per point; ``packed`` is ``pack_nobias``'s output."""
    _check(grouped, mask, center, mode)
    wpack, bpack = _check_packed(packed)
    _check_cuda("r9_variant_cuda", (*grouped, mask, *center, wpack, bpack))
    Bc, Nc, S = mask.shape
    g = [x.float().contiguous() for x in grouped]
    c = [x.float().contiguous() for x in center]
    out = torch.empty((Bc, Nc, 256), dtype=torch.float32, device=mask.device)
    build.launch("profile_r9", "unopose_profile_r9", (*g, mask.float().contiguous(), *c, wpack, bpack, out), Bc * Nc,
                 S, MODES.index(mode), float(r1), float(r2), float(1.0 / r1), float(1.0 / r2))
    return out


def r9_variant(grouped, mask, center, Ws1, Ws2, mode: str, packed=None, r1: float = R1,
               r2: float = R2) -> torch.Tensor:
    """(B, N, 256) float32, dispatched by device: the plain twin reads ``Ws1``/``Ws2``, the kernel their
    ``pack_nobias`` (``packed``, made here when None)."""
    if mask.device.type == "cpu":
        return r9_variant_plain(grouped, mask, center, Ws1, Ws2, mode, r1, r2)
    return r9_variant_cuda(grouped, mask, center, pack_nobias(Ws1, Ws2) if packed is None else packed, mode, r1, r2)


def script_inputs(rng: np.random.Generator, b: int = B, n: int = N, s2: int = S2) -> dict:
    """The script's inputs, draw for draw: ``pts`` (b, n, 3) near a 0.5 sphere, slot planes ``g2`` (three
    (b, n, s2)) 0.02 around each point, ``w1`` a (b, n, s2) 0/1 mask kept with probability 0.2. numpy float32."""
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (0.5 * v + rng.normal(size=(b, n, 3)) * 2e-3).astype(np.float32)
    g2 = tuple(np.repeat(pts[..., i][:, :, None], s2, axis=2) + rng.normal(size=(b, n, s2)).astype(np.float32) * 0.02
               for i in range(3))
    w1 = (rng.uniform(size=(b, n, s2)) < 0.2).astype(np.float32)
    return dict(pts=pts, g2=g2, w1=w1)


def script_weights(gen: torch.Generator):
    """Each scale's three weights, normal x 0.1 (the script's draws are JAX's; these are torch's)."""
    Ws1, Ws2 = [], []
    for shape in MLP_SHAPES:
        Ws1.append(torch.randn(shape, generator=gen) * 0.1)
        Ws2.append(torch.randn(shape, generator=gen) * 0.1)
    return Ws1, Ws2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10, help="chained calls a timed loop")
    args = parser.parse_args(argv)
    dev = card()
    d = script_inputs(np.random.default_rng(0))
    g2 = tuple(torch.from_numpy(x).to(dev) for x in d["g2"])
    w1 = torch.from_numpy(d["w1"]).to(dev)
    center = tuple(torch.from_numpy(np.ascontiguousarray(d["pts"][..., i])).to(dev) for i in range(3))
    Ws1, Ws2 = script_weights(torch.Generator().manual_seed(0))
    Ws1, Ws2 = [W.to(dev) for W in Ws1], [W.to(dev) for W in Ws2]
    bs1, bs2 = _zero_biases(Ws1), _zero_biases(Ws2)
    packed = pack_nobias(Ws1, Ws2)
    print(f"backend: {torch.cuda.get_device_name(dev)}", flush=True)

    results = {}
    ones, total2 = torch.ones_like(w1), torch.full(w1.shape[:2], w1.shape[-1], dtype=torch.int32, device=dev)
    for pb in (32, 64, 128):
        timed_loop(f"pe_fused_packed_pblk{pb}",
                   lambda e, a, b, c, w: pe_fused_packed((a + e, b, c), w, ones, total2, center, Ws1, bs1, Ws2, bs2,
                                                         R1, R2, packed),
                   *g2, w1, k=args.iters, results=results)
    for mode in MODES:
        for pb in (32, 64):
            timed_loop(f"{mode}_pblk{pb}",
                       lambda e, a, b, c, w, mode=mode: r9_variant((a + e, b, c), w, center, Ws1, Ws2, mode, packed),
                       *g2, w1, k=args.iters, results=results)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
