"""What each part of the K1 (FPS), K7 (ViT attention), K9 (the fused assignment's labels) and K4 (int8
geometric embedding) designs buys, on one CUDA card.

    python -m unopose_tpu_torch.tools.kernel_variants [--parent DIR] [--only K9,K4] [--reps 20] [--out FILE]

Builds the shipped sources ``kernels/csrc/fps.cu``, ``vit_attn.cu``, ``fine_assign.cu`` and ``geo_rpe.cu`` and
variants of each, every variant the shipped text with one design choice replaced, each into a library of its
own (``nvcc`` with the package's flags, all builds started together), and times every build on the same
inputs at the main path's shapes with CUDA events: K1 at 16 x 5000 -> 2048 and 16 x 2048 -> 196, K7 at
32 x 261 x 768 bf16 with 12 heads read in place from the qkv output, K9 at 16 pairs of 2049 x 2049 rows, C
256 (the shipped, parent and IEEE-division builds also with f1n scaled by 40, where pred underflows), K4 at
32 clouds of 197 points, 256 channels, T 128, k 3, bf16 contraction (the shipped and parent builds also with
the float32 contraction). The builds run in turns, forward then backward, and each reports
the median of its two times. ``--parent DIR``: a checkout of another commit, whose four sources join as the
builds ``*_parent``. ``--only``: the kernels to build and time.

Variants of K1 (shipped: 256 threads a cloud up to 6144 points, the points in registers, a packed-key argmax,
one barrier a step): ``t1024`` and ``t512``, that many threads a cloud; ``cluster2`` and ``cluster4``, a
cluster of 2 or 4 CTAs a cloud, each holding its share of the points and sending its warps' keys to every CTA
of the cluster through distributed shared memory, one cluster barrier a step.
Variants of K7 (shipped: K and V rows of hd 64 XOR-swizzled, three blocks an SM, the division without its
slow path, every tile over all 17 key steps): ``ieee_division``, the plain ``e / l``, whose slow path is a
call; ``padded_two_blocks``, rows padded by one 16-byte chunk and two blocks an SM; ``runtime_steps``, the
key loops ended at ceil(N / 16) steps at run time. Beside them, ``scaled_dot_product_attention`` on the same
q, k, v (PyTorch's own kernel, the yardstick; the port never calls it).
Variants of K9 (shipped: 64-row tiles of 4 consumer warps, the rows' A fragments in registers, a producer
warp streaming the column tiles through a 3-slot ring by bulk copies and mbarriers, ldmatrix B fragments,
fast_div.cuh's quotients): ``cp_async``, the ring filled by the producer warp's 16-byte ``cp.async`` copies
(one per lane and row, into the same swizzled layout) in place of the tensor map's bulk copies; ``no_ring``, a
ring of one slot, each tile loaded while none other is in flight;
``ld32``, the B fragments as scalar 32-bit shared loads; ``ieee_division``, the IEEE ``/`` in pred;
``128_rows``, 128-row tiles of 8 consumer warps sharing each staged tile.
Variants of K4 (shipped: bf16 tables of 256 channels, 8 channels a lane, a warp's own stencils):
``f32_tables``, float32 tables in 128-channel tiles, 4 channels a lane; ``f32_8ch``, the same with 8 channels
a lane (two 16-byte reads a table row where bf16 takes one and widens); ``f32_64``, float32 tables in
64-channel tiles; ``4ch``, bf16 tables in 128-channel tiles, 4 channels a lane; ``row_barrier``, the block's
stencils of one row at a time in shared memory between two barriers; ``runtime_k``, the angle count read at run
time (the kernel built for k up to kMaxK only, without its k = 3 build).

Every build's output is checked: K1's indices equal to the plain loop's, K7's outputs, K9's rm, rs, label1 and
column keys and K4's int8 codes bitwise equal to the shipped kernel's (for K7's ``parent``, the first
version, the share of equal outputs is reported too). Prints the card's name and power limit, then one JSON
line; ``--out`` writes the JSON there too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.models.embedding import GeometricStructureEmbedding, knn_anchor_vectors
from unopose_tpu_torch.ops import assignment_fused, geo_fused
from unopose_tpu_torch.ops.fps import fps_plain
from unopose_tpu_torch.ops.lrf import global_lrf

_P = ctypes.c_void_p

CLUSTER_FPS = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
namespace cg = cooperative_groups;
namespace {
constexpr int kThreads = 1024, kWarps = 32, CL = CLUSTER;

template <int PER>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ pts, int n, int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float *xs = smem, *ys = xs + n, *zs = ys + n;
  __shared__ unsigned s_bits[2][CL * kWarps];
  __shared__ int s_idx[2][CL * kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cloud = blockIdx.x / CL;
  const float* p = pts + (size_t)cloud * n * 3;
  int* o = out + (size_t)cloud * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += kThreads) { xs[i] = p[3 * i]; ys[i] = p[3 * i + 1]; zs[i] = p[3 * i + 2]; }
  float px[PER], py[PER], pz[PER], md[PER];
  for (int u = 0; u < PER; ++u) {
    const int i = tid + (u * CL + rank) * kThreads;
    md[u] = 1e10f;
    if (i < n) { px[u] = p[3 * i]; py[u] = p[3 * i + 1]; pz[u] = p[3 * i + 2]; }
  }
  unsigned* rb[CL];
  int* ri[CL];
  for (int c = 0; c < CL; ++c) {
    rb[c] = cluster.map_shared_rank(&s_bits[0][0], c);
    ri[c] = cluster.map_shared_rank(&s_idx[0][0], c);
  }
  if (tid == 0 && rank == 0) o[0] = 0;
  cluster.sync();
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float x1 = xs[last], y1 = ys[last], z1 = zs[last];
    float best = -1.0f;
    int besti = INT_MAX;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + (u * CL + rank) * kThreads;
      if (i < n) {
        const float dx = __fsub_rn(px[u], x1), dy = __fsub_rn(py[u], y1), dz = __fsub_rn(pz[u], z1);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float m = fminf(md[u], d);
        md[u] = m;
        if (m > best) { best = m; besti = i; }
      }
    }
    unsigned bits = besti < n ? __float_as_uint(best) : 0u;
    unsigned top = __reduce_max_sync(0xffffffffu, bits);
    int idx = __reduce_min_sync(0xffffffffu, bits == top ? besti : INT_MAX);
    const int par = j & 1;
    if (lane < CL) {
      rb[lane][par * CL * kWarps + rank * kWarps + warp] = top;
      ri[lane][par * CL * kWarps + rank * kWarps + warp] = idx;
    }
    cluster.sync();
    unsigned bb = 0u;
    int bi = INT_MAX;
    for (int c = 0; c < CL; ++c) {
      const unsigned b2 = s_bits[par][c * kWarps + lane];
      const int i2 = s_idx[par][c * kWarps + lane];
      if (b2 > bb || (b2 == bb && i2 < bi)) { bb = b2; bi = i2; }
    }
    top = __reduce_max_sync(0xffffffffu, bb);
    idx = __reduce_min_sync(0xffffffffu, bb == top ? bi : INT_MAX);
    last = idx;
    if (tid == 0 && rank == 0) o[j] = last;
  }
  cluster.sync();
}

template <int PER>
int launch(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<PER><<<batch * CL, kThreads, smem, stream>>>(pts, n, npoint, out);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int unopose_fps(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  switch ((n + CL * kThreads - 1) / (CL * kThreads)) {
    case 1: return launch<1>(pts, out, batch, n, npoint, stream);
    case 2: return launch<2>(pts, out, batch, n, npoint, stream);
    case 3: return launch<3>(pts, out, batch, n, npoint, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"the shipped source no longer holds {old[:60]!r}: update this variant")
    return text.replace(old, new)


K9_LD32 = """  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    const int n = 2 * np * 8 + g, k = ks * 16 + 2 * t;
    b[np][0] = ld32(sB + tile_at<kKb>(n, k)), b[np][1] = ld32(sB + tile_at<kKb>(n, k + 8));
    b[np][2] = ld32(sB + tile_at<kKb>(n + 8, k)), b[np][3] = ld32(sB + tile_at<kKb>(n + 8, k + 8));
  }
}
"""
K9_CP_ASYNC_COPY = """// a 16-byte chunk into shared memory by cp.async, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// the current phase of bar waits, besides its arrivals, for the copies this thread has issued by cp.async
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\\n" ::"r"(smem_addr(bar)) : "memory");
}

"""
K9_CP_ASYNC_LOAD = """      if (u < sweep) {  // each lane copies its 16-byte chunks of every row of the tile, rows past m2 as zeros
        const int row0 = (u % tiles) * kTile;
        const __nv_bfloat16* src = f2 + ((long long)b * m2 + row0) * c;
        for (int n = 0; n < kTile; ++n)
          for (int k8 = 8 * lane; k8 < c; k8 += 256)
            cp_async16(sRing + s * slot + tile_at<kKb>(n, k8), row0 + n < m2 ? src + (long long)n * c + k8 : f2,
                       row0 + n < m2 ? 16 : 0);
        cp_async_arrive(&full[s]);
      }
"""
K4_BF16 = "  if (bf16_weights && D % 256 == 0) return launch<__nv_bfloat16, 256, 8>(p, stream);"
K4_ROW_BARRIER = """  // one row i at a time: the block's stencils of all its columns between two barriers
  for (long long bi = blockIdx.x; bi < (long long)p.batch * n; bi += gridDim.x) {
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) stencils(s_st + j, n, p, (int)(bi / n), (int)(bi % n), j);
    __syncthreads();
    int8_t* row = p.out + (size_t)bi * n * p.D + c0 + cl * kCh;
    for (int jj = warp * kColsPerStep + lane / kLanesPerCol; jj < n; jj += kWarps * kColsPerStep)
      entry<Tab, kTile, kCh>(row + (size_t)jj * p.D, tab_d, tab_a, s_st + jj, n, k, qs);
  }
}

"""


def _between(text: str, start: str, end: str, new: str) -> str:
    """text with the span from ``start`` up to ``end`` (kept) replaced by ``new``."""
    if start not in text or end not in text:
        raise ValueError(f"the shipped source no longer holds {start[:60]!r}: update this variant")
    i = text.index(start)
    return text[:i] + new + text[text.index(end, i):]


# kernel: (source, entry point)
KERNELS = {"K1": ("fps.cu", "unopose_fps"), "K7": ("vit_attn.cu", "unopose_mha_fused"),
           "K9": ("fine_assign.cu", "unopose_fine_labels"), "K4": ("geo_rpe.cu", "unopose_geo_rpe")}


def sources(parent: Path | None, only=("K1", "K7", "K9", "K4")) -> dict:
    """{build name: (kernel, CUDA source text)} of the kernels in ``only``."""
    fps = (build.CSRC / "fps.cu").read_text()
    attn = (build.CSRC / "vit_attn.cu").read_text()
    fa = (build.CSRC / "fine_assign.cu").read_text()
    geo = (build.CSRC / "geo_rpe.cu").read_text()
    out = {"fps": ("K1", fps), "vit_attn": ("K7", attn), "fine_assign": ("K9", fa), "geo_rpe": ("K4", geo)}
    for threads, per in ((1024, 6), (512, 12)):
        text = _sub(fps, "constexpr int kSmallT = 256;", f"constexpr int kSmallT = {threads};")
        text = _sub(text, "constexpr int kSmallPer = 24;", f"constexpr int kSmallPer = {per};")
        out[f"fps_t{threads}"] = ("K1", text)
    for cl in (2, 4):
        out[f"fps_cluster{cl}"] = ("K1", CLUSTER_FPS.replace("CLUSTER", str(cl)))
    out["vit_attn_ieee_division"] = ("K7", _sub(
        attn, "return kExact ? div_exact(e, l, y) : div_fast(e, l, y);", "return e / l;"))
    text = _sub(attn, "  return HD % 64 == 0 ? HD : HD + 8;", "  return HD + 8;")
    text = _sub(text, "  return HD % 64 == 0 ? r * HD + ((c ^ (r & 7)) << 3) : r * (HD + 8) + c * 8;",
                "  return r * (HD + 8) + c * 8;")
    out["vit_attn_padded_two_blocks"] = ("K7", _sub(text, "__launch_bounds__(kThreads, HD <= 64 ? 3 : 2)",
                                                    "__launch_bounds__(kThreads, 2)"))
    text = attn.replace("p < kSteps; ++p)", "p < kSteps && 16 * p < n; ++p)")
    text = text.replace("nt < 2 * kSteps; ++nt)", "nt < 2 * kSteps && 16 * (nt >> 1) < n; ++nt)")
    out["vit_attn_runtime_steps"] = ("K7", _sub(text, "kk < kSteps; ++kk)", "kk < kSteps && 16 * kk < n; ++kk)"))
    text = _between(fa, "// one box of the (B, m2, c) tensor of f2", "__device__ __forceinline__ void mbar_init",
                    K9_CP_ASYNC_COPY)
    text = _sub(text, "const __grid_constant__ CUtensorMap f2_map", "const __nv_bfloat16* __restrict__ f2")
    text = _between(text, "      if (u < sweep && lane == 0) {\n        mbar_expect",
                    "      const int tp = u - kStages - tiles;", K9_CP_ASYNC_LOAD)
    text = _between(text, "  static EncodeTiled encode = nullptr;", "  const size_t smem = 1024", "")
    out["fine_assign_cp_async"] = ("K9", _sub(text, "static_cast<const __nv_bfloat16*>(f1), map, cm",
                                              "static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2), cm"))
    out["fine_assign_no_ring"] = ("K9", _sub(fa, "constexpr int kStages = 3;", "constexpr int kStages = 1;"))
    out["fine_assign_ld32"] = ("K9", _between(
        fa, "  const int lane = threadIdx.x & 31, i = lane >> 3;\n  // matrix i of an ldmatrix.x4",
        "\n// the warp's logits against one staged column tile", K9_LD32))
    out["fine_assign_ieee_division"] = ("K9", _sub(fa, "const bool helper = m1 < 4096 && m2 < 4096;",
                                                   "const bool helper = false;"))
    text = _sub(fa, "constexpr int kLabelWarps = 4;", "constexpr int kLabelWarps = 8;")
    out["fine_assign_128_rows"] = ("K9", _sub(text, "constexpr int kLabelBlocks = 2;",
                                              "constexpr int kLabelBlocks = 1;"))
    for name, kind in (("f32_tables", "float, 128, 4"), ("f32_8ch", "float, 128, 8"), ("f32_64", "float, 64, 4"),
                       ("4ch", "__nv_bfloat16, 128, 4")):
        out[f"geo_rpe_{name}"] = ("K4", _sub(geo, K4_BF16, K4_BF16.replace("__nv_bfloat16, 256, 8", kind)))
    out["geo_rpe_runtime_k"] = ("K4", _sub(
        geo, "p.k == 3 ? geo_rpe_kernel<Tab, kTile, kCh, 3> : geo_rpe_kernel<Tab, kTile, kCh, kMaxK>",
        "geo_rpe_kernel<Tab, kTile, kCh, kMaxK>"))
    out["geo_rpe_row_barrier"] = ("K4", _between(
        geo, "  // units of one row i and 32 columns j", "// one block an SM's worth of blocks", K4_ROW_BARRIER))
    if parent is not None:
        csrc = parent / "unopose_tpu_torch" / "kernels" / "csrc"
        for name, (kernel, (src, _)) in zip(("fps", "vit_attn", "fine_assign", "geo_rpe"), KERNELS.items()):
            out[f"{name}_parent"] = (kernel, (csrc / src).read_text())
    return {name: v for name, v in out.items() if v[0] in only}


def compile_all(srcs: dict, workdir: Path) -> dict:
    """Build every source into workdir/<name>.so, all nvcc processes at once; {name: ctypes.CDLL}."""
    workdir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, (_, text) = item
        src, lib = workdir / f"{name}.cu", workdir / f"{name}.so"
        src.write_text(text)
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared", "-o", str(lib),
                            str(src)], capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise build.KernelBuildError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(srcs)) as ex:
        return dict(ex.map(one, srcs.items()))


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fine_inputs(dev, gen) -> tuple:
    """K9's inputs at the main shape as chip_smoke.py makes them: 16 pairs of 2049 x 2049, C 256, three
    quarters of the query rows matching a reference row; the column statistics from the plain twin."""
    Bp, M, C = 16, 2049, 256
    f2 = torch.randn(Bp, M, C, device=dev, generator=gen)
    f1 = torch.randn(Bp, M, C, device=dev, generator=gen)
    match = torch.randperm(M, device=dev, generator=gen)[: 3 * M // 4]
    f1[:, : len(match)] = f2[:, match] + 0.5 * f1[:, : len(match)]
    score = torch.rand(Bp, 2 * (M - 1), device=dev, generator=gen)
    f1n, f2n, s1, s2 = assignment_fused.operands(f1, f2, score, 0.1)
    cm, cs = assignment_fused.colstats_plain(f1n, f2n)
    return f1n, f2n, cm, cs, s1, s2


def geo_inputs(dev, rng, dtype) -> tuple:
    """K4's arguments (before the stream) at the main shape as chip_smoke.py makes them: both clouds' 196
    FPS nodes in their LRF plus the (1, 1, 1) bg point, 256 channels, T 128, k 3."""
    B2, N, D, T, k = 32, 197, 256, 128, 3
    pts = rng.uniform(-0.1, 0.1, size=(B2, N - 1, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
    nodes = global_lrf(torch.from_numpy(pts).to(dev))
    points = torch.cat([torch.ones((B2, 1, 3), device=dev), nodes], dim=1)
    torch.manual_seed(0)
    ge = GeometricStructureEmbedding(D, dtype=torch.bfloat16, d_index_max=float(2.1 * np.sqrt(3.0) / 0.2),
                                     fused_table=T, quant_int8=True).to(dev)
    factor_a = 180.0 / (ge.sigma_a * np.pi)
    _, ref_vec = knn_anchor_vectors(points, k)
    with torch.no_grad():
        tab_d, scale_d = geo_fused.build_taylor_table(ge.proj_d.weight.t(), ge.proj_d.bias, ge.d_index_max, T)
        tab_a, scale_a = geo_fused.build_taylor_table(ge.proj_a.weight.t(), ge.proj_a.bias,
                                                      float(np.pi * factor_a), T)
    return geo_fused.kernel_args(points, ref_vec, tab_d, tab_a, scale_d, scale_a, ge.sigma_d, factor_a, dtype)[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--only", default="K1,K7,K9,K4")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    srcs = sources(args.parent, tuple(args.only.split(",")))
    libs = compile_all(srcs, build.BUILD_DIR / "variants")
    stream = lambda: _P(torch.cuda.current_stream().cuda_stream)
    for name, lib in libs.items():
        entry = KERNELS[srcs[name][0]][1]
        getattr(lib, entry).argtypes = build._SIGNATURES[entry]

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = {}  # kernel: {shape: inputs}
    clouds = {}
    for b, n, k in ((16, 5000, 2048), (16, 2048, 196)):
        pts = rng.uniform(-0.1, 0.1, size=(b, n, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
        pts = global_lrf(torch.from_numpy(pts).to(dev)).contiguous()
        clouds[f"{b}x{n}->{k}"] = (pts, k, fps_plain(pts, k), torch.empty((b, k), dtype=torch.int32, device=dev))
    shapes["K1"] = clouds
    B, N, H, hd = 32, 261, 12, 64
    qkv = torch.randn(B, N, 3 * H * hd, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * hd, dim=-1)
    shapes["K7"] = {"32x261x768": None}
    if "K9" in args.only:
        fine = fine_inputs(dev, gen)
        # and with f1n scaled by 40, where pred underflows: fast_div.cuh's exact path for tiny dividends
        f1x = (fine[0].float() * 40.0).to(torch.bfloat16)
        shapes["K9"] = {"16x2049x2049x256": fine,
                        "16x2049x2049x256 q x40": (f1x, fine[1], *assignment_fused.colstats_plain(f1x, fine[1]),
                                                   *fine[4:])}
    if "K4" in args.only:
        shapes["K4"] = {"32x197x197x256 bf16": geo_inputs(dev, rng, torch.bfloat16),
                        "32x197x197x256 f32": geo_inputs(dev, rng, torch.float32)}

    def run_case(name: str, key: str):
        """(call, outputs) of one build at one shape; the call launches the kernel once."""
        lib, kernel = libs[name], srcs[name][0]
        if kernel == "K1":
            pts, npoint, _, out = clouds[key]
            call = lambda: lib.unopose_fps(_P(pts.data_ptr()), _P(out.data_ptr()), pts.shape[0], pts.shape[1],
                                           npoint, stream())
            outs = (out,)
        elif kernel == "K7":
            out = torch.empty((B, N, H * hd), dtype=torch.bfloat16, device=dev)
            call = lambda: lib.unopose_mha_fused(_P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
                                                 _P(out.data_ptr()), B, N, H, hd, q.stride(0), q.stride(1), 1,
                                                 hd**-0.5, stream())
            outs = (out,)
        elif kernel == "K9":
            f1n, f2n, cm, cs, s1, s2 = shapes["K9"][key]
            Bp, M1, C = f1n.shape
            M2 = f2n.shape[1]
            rm, rs = (torch.empty((Bp, M1), device=dev) for _ in range(2))
            label1 = torch.empty((Bp, M1), dtype=torch.int32, device=dev)
            keys = torch.zeros((Bp, M2), dtype=torch.int64, device=dev)
            ptrs = [_P(x.data_ptr()) for x in (f1n, f2n, cm, cs, s1, s2, rm, rs, label1, keys)]

            def call():  # the keys are zeroed before each launch, as the wrapper allocates them
                keys.zero_()
                return lib.unopose_fine_labels(*ptrs, Bp, M1, M2, C, stream())
            outs = (rm, rs, label1, keys)
        else:
            a = shapes["K4"][key]
            out = torch.empty_like(a[5])
            ptrs = [_P(x.data_ptr()) if torch.is_tensor(x) else x for x in a[:5]] + [_P(out.data_ptr())]
            call = lambda: lib.unopose_geo_rpe(*ptrs, *a[6:], stream())
            outs = (out,)
        err = call()
        if err:
            raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
        return call, outs

    shipped = {"K1": "fps", "K7": "vit_attn", "K9": "fine_assign", "K4": "geo_rpe"}
    # K4's float32 contraction only for the shipped and parent builds (the variants are of the bf16 path), K9's
    # scaled q for those and the IEEE division
    extra = ("geo_rpe", "geo_rpe_parent", "fine_assign", "fine_assign_parent", "fine_assign_ieee_division")
    cases = [(name, key) for name in srcs for key in shapes[srcs[name][0]]
             if not ((key.endswith("f32") or key.endswith("x40")) and name not in extra)]
    times = {c: [] for c in cases}
    heads = [x.reshape(B, N, H, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
    sdpa = []
    for order in (cases, cases[::-1]):
        if "K7" in args.only:
            sdpa.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads), args.reps))
        for name, key in order:
            call, _ = run_case(name, key)
            times[(name, key)].append(cuda_ms(call, args.reps))
    reference = {(srcs[name][0], key): [o.clone() for o in run_case(name, key)[1]]
                 for name, key in cases if name == shipped[srcs[name][0]]}
    results = []
    for name, key in cases:
        kernel = srcs[name][0]
        _, outs = run_case(name, key)
        torch.cuda.synchronize()
        if kernel == "K1":
            check = dict(indices_equal_plain=bool(torch.equal(outs[0], clouds[key][2])))
        else:
            ref = reference[(kernel, key)]
            bits = lambda x: x.view(torch.int16) if x.dtype == torch.bfloat16 else x
            check = dict(bitwise_equal_shipped=all(torch.equal(bits(o), bits(r)) for o, r in zip(outs, ref)))
            if kernel == "K7":
                check["equal_share_shipped"] = (outs[0] == ref[0]).float().mean().item()
        results.append(dict(build=name, kernel=kernel, shape=key, ms=float(np.median(times[(name, key)])),
                            **check))
    if "K7" in args.only:
        results.append(dict(build="scaled_dot_product_attention", kernel="K7", shape="32x261x768",
                            ms=float(np.median(sdpa))))
    print(card)
    line = json.dumps({"card": card, "variants": results})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
