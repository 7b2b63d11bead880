"""The TPU profiling kernels of ``benchmarks/`` against their PyTorch twins (CPU).

The port carries the five Pallas kernels of three JAX timing scripts (``unopose_tpu_torch/benchmarks/``):
``profile_r9.py``'s ``kern`` (row 24), ``profile_pe_ablate.py``'s ``kernel`` (row 20) and
``profile_compact_micro.py``'s ``_k_rounds``, ``_k_gather`` and the prefix search ``kern`` (rows 21-23). The
oracle is each script's own kernel code: ``_k_rounds`` and ``_k_gather`` are imported; the three kernels
nested inside a function that builds full-size inputs are lifted out of the script's source with ``ast`` and
run with the names they close over. All of them go through ``pl.pallas_call(..., interpret=True)`` on a
small grid, on inputs made with numpy from a seed and handed to both packages.

Gates: the integer kernels bitwise. Row 24 without frames (``matmul_only``): three bf16 layers whose
float32 sums the two packages take in another order, so a rounding to bf16 may land one ulp apart and carry
into the next layer. The card holds the kernels to the twins by ``profile_r9.bf16_agreement``'s rule (at
least 99.9% of outputs bitwise equal, at most one in 10^4 past one bf16 ulp of its own value, all within one
ulp of their row's largest output), and so the twin is held to JAX here, where row 24 also keeps every other
output within one bf16 ulp of its own value and row 20's frameless sets the rows' gates below.
Row 24 with frames and row 20: the fine PE's local frames are ill conditioned on some neighbourhoods, so the
rows are held to JAX's own spread under a one-ulp input change (``assert_rows_within_jax_spread``).
"""

import ast
import functools
import importlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_fused import R1, R2, as_np, mixed_tier_cloud
from test_torch_pe_variants import assert_rows_within_jax_spread
from unopose_tpu_torch.benchmarks import profile_compact_micro as tcm
from unopose_tpu_torch.benchmarks import profile_pe_ablate as tpa
from unopose_tpu_torch.benchmarks import profile_r9 as tr9
from unopose_tpu_torch.kernels import LAUNCHES, build

jcm = importlib.import_module("benchmarks.profile_compact_micro")
jbq = importlib.import_module("unopose_tpu.ops.ball_query")
jpf = importlib.import_module("unopose_tpu.ops.pe_fused")

ROOT = Path(__file__).resolve().parents[1]


def lift(script: str, parent: str, names, **env) -> dict:
    """The functions ``names`` nested in ``parent`` of ``benchmarks/<script>``, executed with ``env``."""
    tree = ast.parse((ROOT / "benchmarks" / script).read_text())
    outer = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == parent)
    defs = [n for n in ast.walk(outer) if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in defs) == sorted(names), [n.name for n in defs]
    scope = dict(env, jax=jax, jnp=jnp)
    exec(compile(ast.Module(body=defs, type_ignores=[]), script, "exec"), scope)
    return {name: scope[name] for name in names}


def up(x):
    return np.nextafter(x, np.float32(np.inf)).astype(np.float32)


# ------------------------------------------------------------------ rows 21-23: the compaction micro-kernels
@functools.lru_cache(maxsize=None)
def compact_inputs():
    d = tcm.script_inputs(np.random.default_rng(0), 1)
    d["bi"][0, :4, :8] = np.array([-1, 16, 17, 1 << 30, -(1 << 30), 15, 0, 7], np.int32)  # banks off the chain
    return d


def compact_specs():
    """The script's block specs: one block of (ROWS, C x W) words, one of (ROWS, K2) indices or outputs."""
    return (pl.BlockSpec((1, jcm.ROWS, jcm.C * jcm.W), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, jcm.ROWS, jcm.K2), lambda b: (b, 0, 0), memory_space=pltpu.VMEM))


@pytest.mark.parametrize("nrounds", [9, 7])
def test_compact_rounds_matches_jax(nrounds):
    """``_k_rounds`` (row 21) in interpret mode, one block of 256 rows: every output equal (the roll's
    direction and the wrapped lanes' mask included)."""
    x = compact_inputs()["x"]
    blkx, blki = compact_specs()
    kern = functools.partial(jcm._k_rounds, nrounds=nrounds, chunks=jcm.C, width=jcm.W)
    want = pl.pallas_call(kern, grid=(1,), in_specs=[blkx], out_specs=blki,
                          out_shape=jax.ShapeDtypeStruct((1, jcm.ROWS, jcm.K2), jnp.int32), interpret=True)(x)
    got = tcm.compact_rounds(torch.from_numpy(x), nrounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compact_gather_matches_jax():
    """``_k_gather`` (row 22) in interpret mode: every output equal, banks outside [0, 16) giving 0 as the
    select chain does."""
    d = compact_inputs()
    blkx, blki = compact_specs()
    want = pl.pallas_call(jcm._k_gather, grid=(1,), in_specs=[blkx, blki, blki], out_specs=blki,
                          out_shape=jax.ShapeDtypeStruct((1, jcm.ROWS, jcm.K2), jnp.int32),
                          interpret=True)(d["x"], d["li"], d["bi"])
    got = tcm.compact_gather(*(torch.from_numpy(d[k]) for k in ("x", "li", "bi")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[0, :4, :5] == 0).all()


def test_gather_sectors_counts_the_sectors_the_draws_touch():
    """``gather_sectors`` (the bytes of row 22's bound on the card): per row the distinct 32-byte sectors
    (bi * 128 + li) // 8 of the draws on a bank in [0, 16), counted here row by row with sets."""
    d = compact_inputs()
    li, bi = d["li"].reshape(-1, tcm.K2), d["bi"].reshape(-1, tcm.K2)
    want = sum(len(set(((b * 128 + l) // 8)[(b >= 0) & (b < 16)].tolist())) for l, b in zip(li, bi))
    assert tcm.gather_sectors(torch.from_numpy(d["li"]), torch.from_numpy(d["bi"])) == want
    assert 0.6 * li.size < want < 0.66 * li.size  # ~63% of the rows' K2 sectors under the uniform draw


def test_compact_wherechain_matches_jax():
    """The prefix search ``kern`` of ``wherechain`` (row 23), lifted from the script, in interpret mode:
    every output equal."""
    kern = lift("profile_compact_micro.py", "wherechain", ["kern"], ROWS=jcm.ROWS, K2=jcm.K2)["kern"]
    li = compact_inputs()["li"]
    _, blki = compact_specs()
    want = pl.pallas_call(kern, grid=(1,), in_specs=[blki], out_specs=blki,
                          out_shape=jax.ShapeDtypeStruct((1, jcm.ROWS, jcm.K2), jnp.int32), interpret=True)(li)
    got = tcm.compact_wherechain(torch.from_numpy(li))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ row 24: profile_r9's kern
R9_B, R9_N, R9_PBLK = 1, 64, 32


@functools.lru_cache(maxsize=None)
def r9_inputs():
    d = tr9.script_inputs(np.random.default_rng(0), R9_B, R9_N)
    d["w1"][0, 5] = 0.0  # a point with no kept slot: scale 1's max over none, -inf
    Ws1, Ws2 = tr9.script_weights(torch.Generator().manual_seed(0))
    return d, [W.numpy() for W in Ws1], [W.numpy() for W in Ws2]


def jax_r9(mode: str, nudge: bool = False) -> np.ndarray:
    d, Ws1, Ws2 = r9_inputs()
    S2 = d["w1"].shape[-1]
    fns = lift("profile_r9.py", "mk_variant", ["kern", "blkdiag4"], mode=mode, p_blk=R9_PBLK, S2=S2, R1=tr9.R1,
               R2=tr9.R2, _masked_lrf_block=jpf._masked_lrf_block)
    weights = [fns["blkdiag4"](jnp.asarray(a), jnp.asarray(b)).astype(jnp.bfloat16) for a, b in zip(Ws1, Ws2)]
    f = up if nudge else (lambda x: x)
    g2 = [f(x) for x in d["g2"]]
    cs = [f(np.ascontiguousarray(d["pts"][..., i]))[..., None] for i in range(3)]
    blk_s2 = pl.BlockSpec((1, R9_PBLK, S2), lambda b, j: (b, j, 0), memory_space=pltpu.VMEM)
    blk2 = pl.BlockSpec((1, R9_PBLK, 1), lambda b, j: (b, j, 0), memory_space=pltpu.VMEM)
    full = lambda a: pl.BlockSpec(a.shape, lambda b, j: (0,) * a.ndim, memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        fns["kern"], grid=(R9_B, R9_N // R9_PBLK), in_specs=[blk_s2] * 4 + [blk2] * 3 + [full(x) for x in weights],
        out_specs=pl.BlockSpec((1, R9_PBLK, 256), lambda b, j: (b, j, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R9_B, R9_N, 256), jnp.float32), interpret=True,
    )(*g2, d["w1"], *cs, *weights)
    return np.asarray(out)


def port_r9(mode: str) -> np.ndarray:
    d, Ws1, Ws2 = r9_inputs()
    center = [torch.from_numpy(np.ascontiguousarray(d["pts"][..., i])) for i in range(3)]
    out = tr9.r9_variant([torch.from_numpy(x) for x in d["g2"]], torch.from_numpy(d["w1"]), center,
                         [torch.from_numpy(W) for W in Ws1], [torch.from_numpy(W) for W in Ws2], mode)
    return out.numpy()


def test_r9_matmul_only_matches_jax():
    """``matmul_only`` (no frame): ``bf16_agreement``'s rule, and at least 99% of outputs bitwise equal, the
    rest within one bf16 ulp of their value (module docstring); the point with no kept slot is -inf on scale 1
    in both, and finite on scale 2."""
    got, want = port_r9("matmul_only"), jax_r9("matmul_only")
    assert got.shape == want.shape == (R9_B, R9_N, 256)
    rule = tr9.bf16_agreement(torch.tensor(got), torch.tensor(want))
    assert rule["ok"], rule
    assert np.isneginf(want[0, 5, :128]).all() and np.isneginf(got[0, 5, :128]).all()
    inf = np.isinf(want)
    assert (np.isinf(got) == inf).all() and np.isfinite(got[0, 5, 128:]).all()
    g, w = got[~inf], want[~inf]
    assert (g == w).mean() >= 0.99, (g == w).mean()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(g - w) <= ulp).all(), np.abs(g - w).max()


def test_r9_full_nobias_matches_jax():
    """``full_nobias``: scale 1's frame over the mask, scale 2's over every slot; rows within JAX's own
    spread under a one-ulp input change (the -inf row compared as equal)."""
    got, want, moved = port_r9("full_nobias"), jax_r9("full_nobias"), jax_r9("full_nobias", nudge=True)
    inf = np.isinf(want)
    assert (np.isinf(got) == inf).all() and (np.isinf(moved) == inf).all()
    zero = lambda x: np.where(inf, 0.0, x)
    assert_rows_within_jax_spread(zero(got), zero(want), zero(moved))


# ------------------------------------------------------------------ row 20: profile_pe_ablate's kernel
@pytest.fixture(scope="module")
def ablate_case():
    """Two 256-point clouds cut from the mixed-tier cloud, its shell drawn towards its centre by 0.3 (on the
    0.5 shell a 0.12 neighbourhood holds ~5 points, and there JAX's own frames move on 9% of rows under a
    one-ulp change): the dense ring (a 64-point block of 160 hits, past the S2 / 2 the kernel reads) and 96
    shell points, then the other 256 shell points; grouped by JAX's ``two_scale_group_first_k_packed`` at
    the mixed-tier radii, with random folded weights; every input handed to both packages as numpy."""
    cloud = mixed_tier_cloud()[0]
    ring, shell = cloud[:160], cloud[160:]
    shell = shell.mean(0) + (shell - shell.mean(0)) * 0.3
    pts = np.stack([np.concatenate([ring, shell[:96]]), shell[96:]]).astype(np.float32)
    g2, w1, w2, total2, overflow = jax.jit(
        lambda p: jbq.two_scale_group_first_k_packed(R1, 64, R2, 256, p))(jnp.asarray(pts))
    assert not bool(overflow)
    rng = np.random.default_rng(1)
    mlps = []
    for _ in range(2):
        Ws, bs, cin = [], [], 6
        for dout in (32, 64, 128):
            Ws.append((rng.normal(size=(cin, dout)) * (2.0 / cin) ** 0.5).astype(np.float32))
            bs.append((rng.normal(size=dout) * 0.1).astype(np.float32))
            cin = dout
        mlps.append((Ws, bs))
    assert as_np(w1).max() > 1  # multiset weights above 1 reach the frames
    return dict(pts=pts, g2=[np.array(x) for x in g2], w1=np.asarray(w1), w2=np.asarray(w2), mlps=mlps)


def jax_ablate(case, drop, nudge: bool = False) -> np.ndarray:
    fns = lift("profile_pe_ablate.py", "main", ["kernel", "prep"], _masked_lrf_block=jpf._masked_lrf_block)
    (Wa, ba), (Wb, bb) = case["mlps"]
    ws = fns["prep"](*map(lambda x: [jnp.asarray(a) for a in x], (Wa, ba, Wb, bb)))
    f = up if nudge else (lambda x: x)
    g2 = [f(x) for x in case["g2"]]
    cs = [f(np.ascontiguousarray(case["pts"][..., i]))[..., None] for i in range(3)]
    P, S2, p_blk = 256, 256, tpa.P_BLK
    blk_s2 = pl.BlockSpec((1, p_blk, S2), lambda b, j: (b, j, 0), memory_space=pltpu.VMEM)
    blk2 = pl.BlockSpec((1, p_blk, 1), lambda b, j: (b, j, 0), memory_space=pltpu.VMEM)
    full = lambda a: pl.BlockSpec(a.shape, lambda b, j: (0,) * a.ndim, memory_space=pltpu.VMEM)
    k = functools.partial(fns["kernel"], r1=R1, r2=R2, p_blk=p_blk, s2=S2, drop=drop)
    out = pl.pallas_call(
        k, grid=(2, P // p_blk), in_specs=[blk_s2] * 5 + [blk2] * 3 + [full(w) for w in ws],
        out_specs=pl.BlockSpec((1, p_blk, 256), lambda b, j: (b, j, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((2, P, 256), jnp.float32), interpret=True,
    )(*g2, case["w1"], case["w2"], *cs, *ws)
    return np.asarray(out)


@pytest.mark.parametrize("drop", tpa.ALL_DROPS, ids=tpa.set_name)
def test_pe_ablate_plain_matches_jax(ablate_case, drop):
    """Each of the seven sets against the script's kernel in interpret mode: rows within JAX's own spread
    under a one-ulp input change of the slots and centres. Where the set's output uses no frame (the frames,
    the channels or the MLP dropped) that spread is taken as none, which is the stricter gate, and the set
    also meets ``bf16_agreement``'s rule, the card's between kernel and twin."""
    c = ablate_case
    (Wa, ba), (Wb, bb) = [([torch.from_numpy(W) for W in Ws], [torch.from_numpy(b) for b in bs])
                          for Ws, bs in c["mlps"]]
    center = [torch.from_numpy(np.ascontiguousarray(c["pts"][..., i])) for i in range(3)]
    w1, w2 = (torch.from_numpy(np.asarray(w).astype(np.float32)).to(torch.bfloat16) for w in (c["w1"], c["w2"]))
    got = tpa.pe_ablate([torch.from_numpy(x) for x in c["g2"]], w1, w2, center, (Wa, ba), (Wb, bb), drop, r1=R1,
                        r2=R2).numpy()
    want = jax_ablate(c, drop)
    assert got.shape == want.shape and np.isfinite(got).all()
    frames = not {"lrf", "stack", "mlp"} & set(drop)
    assert_rows_within_jax_spread(got, want, jax_ablate(c, drop, nudge=True) if frames else want)
    if not frames:
        rule = tr9.bf16_agreement(torch.tensor(got), torch.tensor(want))
        assert rule["ok"], rule


# ------------------------------------------------------------------ dispatch
def test_profile_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    """The five CUDA wrappers raise on CPU tensors without touching the kernel loader, and the dispatching
    functions take the plain twins there (no launch counted)."""
    monkeypatch.setattr(build, "load", lambda: pytest.fail("the loader was reached"))
    before = dict(LAUNCHES)
    x, li = torch.zeros((1, 2048), dtype=torch.int32), torch.zeros((1, 256), dtype=torch.int32)
    for fn, args in ((tcm.compact_rounds_cuda, (x, 9)), (tcm.compact_gather_cuda, (x, li, li)),
                     (tcm.compact_wherechain_cuda, (li,))):
        with pytest.raises(ValueError):
            fn(*args)
    g = [torch.zeros((1, 64, 256)) for _ in range(3)]
    c = [torch.zeros((1, 64)) for _ in range(3)]
    Ws = [torch.zeros(s) for s in tr9.MLP_SHAPES]
    with pytest.raises(ValueError):
        tr9.r9_variant_cuda(g, g[0], c, tr9.pack_nobias(Ws, Ws), "matmul_only")
    with pytest.raises(ValueError):
        tpa.pe_ablate_cuda(g, g[0], g[0], c, tr9.pack_nobias(Ws, Ws), ())
    assert tcm.compact_wherechain(li).shape == (1, 256)
    assert tr9.r9_variant(g, g[0], c, Ws, Ws, "matmul_only").shape == (1, 64, 256)
    assert dict(LAUNCHES) == before
