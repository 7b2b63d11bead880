"""What each part of the K1 (FPS), K7 (ViT attention), K9 and K10 (the fused assignment's labels and
accumulation), K4 (int8 geometric embedding), K6 (the fine PE's MLP and pool), K3 (the first_k select) and K8
(the fused assignment's column statistics) designs buys, on one CUDA card.

    python -m unopose_tpu_torch.tools.kernel_variants [--parent DIR] [--only K3,K8] [--reps 20] [--out FILE]

Builds the shipped sources ``kernels/csrc/fps.cu``, ``vit_attn.cu``, ``fine_assign.cu``, ``geo_rpe.cu``,
``pe_mlp_pool.cu`` and ``first_k_select.cu`` and variants of each, every variant the shipped text with one design
choice replaced, each into a library of its own (``nvcc`` with the package's flags, all builds started together,
one build per distinct text), and times every build on the same inputs at the main path's shapes with CUDA
events: K1 at 16 x 5000 -> 2048 and 16 x 2048 -> 196, K7 at 32 x 261 x 768 bf16 with 12 heads read in place from
the qkv output, K9 and K10 at 16 pairs of 2049 x 2049 rows, C 256 (the shipped, parent and IEEE-division builds
also with f1n scaled by 40, where pred underflows), K4 at 32 clouds of 197 points, 256 channels, T 128, k 3, bf16
contraction (the shipped and parent builds also with the float32 contraction), K6 at 32 x 2048 points, S2 256, on
the uniform cubes and on the sphere surfaces that fill every 64-slot tier, fed the plain twin's channels, K3 at
32 clouds of 2048 points, budgets 64 / 256, on the uniform cubes and on the sphere surfaces (neither overflows;
~33 r2 hits a centre on the cubes), on a 0.1 m cube not scaled by the LRF (every centre overflows every way: a
chunk's budget, total2 > k2 and cnt1 > k1), and on cubes of 1984 and 2000 points (chunks ending inside a word),
576 and 272, K8 at 16 pairs of 2049 x 2049 rows, C 256 (the shipped and parent builds also with f1n scaled by
40), 4 pairs of 300 x 257 rows, C 48 (off the 64-row grid, 32-byte swizzle) and 2 of 65 x 130 rows, C 16. The
builds run in turns, forward then backward, and each reports the median of its two times. ``--parent DIR``: a
checkout of another commit, whose sources (with the headers they include from its ``csrc/``) join as the builds
``*_parent``. ``--only``: the kernels to build and time.

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
Variants of K10 (shipped: K9's block and ring for one sweep over the live column tiles, the column scalars
staged with each tile, masked entries selected away, fast_div.cuh's quotients): ``accum_ieee_division``, the
IEEE ``/`` in pred; ``accum_no_ring``, a ring of one slot (the same texts as K9's two variants, timed on K10).
Variants of K6 (shipped: 8 warps a block, 3 blocks an SM, each block's range of points taken by its warps from
a counter in shared memory; each 64-slot chunk's kept slots packed to its front and only their m-tiles run,
the last m-tile's spare rows repeating a kept slot; one ldmatrix B fragment per 16-slot m-tile; layers 1-2's
biases in registers; the max on the raw layer-3 sums, bias, ReLU and rounding once per column; the next
chunk's rows copied by cp.async into the warp's buffer in shared memory and the weights of the one after it
loaded while a chunk's products run): ``registers``, the next chunk's rows loaded into registers instead;
``b64``, each B
fragment shared by the chunk's (up to 4) packed m-tiles; ``no_packing``, all 4 m-tiles of every chunk with a
kept slot run, each masked slot's row repeating a kept one; ``epilogue_first``, bias, ReLU and rounding on
every layer-3 output before the max (the first design's epilogue); ``atomic``, every warp of the persistent
grid taking its points from one counter in device memory (zeroed by the launcher) in place of its block's
range and counter; ``stride``, the first design's static stride over the points; ``wgmma``, the warpgroup
products in place of mma.sync: a block of 4 warps per chunk (no packing), each warp's 16 rows as the A
operand in registers, B read by descriptor from the weights laid out again in shared memory in the canonical
K-major layout, the 4 warps' maxes merged in shared memory.

Variants of K3 (shipped: a block of 8 warps takes 32 consecutive centres of one cloud, whose permuted points it
stages once in shared memory as (x, y, z, |p|^2), with perm; each warp scans the candidates two words a step for
its 4 centres at once into ballot words; per centre, a lane a word: the words' hit counts prefix-summed across the
warp give each hit its rank in its chunk and the chunk counts, the first r2 and r1 hits by original index come from
the least key over the hits or a walk in original order, the kept hits go into a staged row of slot words, and the
row leaves as 16-byte vectors): ``global_scan``, each candidate read from device memory by three scalar loads and
its |p|^2 recomputed for every centre (the first design's scan); ``c1``, ``c2`` and ``c8``, 1, 2 or 8 centres a
warp; ``w16``, 16 warps a block; ``ordered_walk``, the first r2 and r1 hits by original index always from the walk
in original order (shipped: only where the mask holds one hit in 64 or more, else the least key over the lanes'
hits, perm staged beside the cloud); ``keys_only``, always the least key, never the walk; ``walk_at_4``,
``walk_at_16`` and ``walk_at_32``, the walk where the mask holds one hit in 4, 16 or 32 candidates or more;
``scalar_stores``, the row written slot by slot as 2- and 1-byte stores; ``word_walk``, the compaction of the first
design (the chunk counts from the words, then each chunk's words walked one by one, a lane a bit, until its budget
is full) in place of a lane a word with a warp prefix sum of the words' hit counts.
Variants of K8 (shipped: one block per pair and 64-column tile, the tile of f2 resident in shared memory; a
producer warp streaming f1's 64-row tiles through a 2-slot ring by the tensor map, 2 blocks an SM; 8 consumer
warps, each a row group of 16 rows against 4 of the tile's 8 n-tiles, fragments by ldmatrix): ``sync``, a ring of
one slot (each row tile loaded while none other is in flight, the copies never overlapping the products);
``4warps``, 4 consumer warps, each a row group against all 8 n-tiles (the first design's split); ``16warps``, 16
warps of a row group against 2 n-tiles, one block an SM; ``3stages``, a ring of 3 slots, one block an SM.

Every build's output is checked: K1's indices equal to the plain loop's, K7's outputs, K9's rm, rs, label1 and
column keys, K10's wsum and num, K4's int8 codes, K6's pooled features, K3's eight outputs (each also equal to
the plain twin's) and K8's cm and cs bitwise equal to the shipped kernel's (for K7's ``parent``, the first
version, the share of equal outputs is reported too). Prints the card's name and power limit, then one JSON line;
``--out`` writes the JSON there too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.models.embedding import GeometricStructureEmbedding, knn_anchor_vectors
from unopose_tpu_torch.ops import assignment_fused, geo_fused, pe_fused
from unopose_tpu_torch.ops.ball_query import SELECT_KEYS
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
K6_RAW_MAX = """    mx[nt][0] = fmaxf(mx[nt][0], fmaxf(c[0], c[2]));
    mx[nt][1] = fmaxf(mx[nt][1], fmaxf(c[1], c[3]));
"""
K6_EPILOGUE_FIRST = """    const int col = 96 + nt * 8 + 2 * (lane & 3);  // B0 + 96: the layer-3 biases
    mx[nt][0] = fmaxf(mx[nt][0], fmaxf(relu_bf16(c[0] + B0[col]), relu_bf16(c[2] + B0[col])));
    mx[nt][1] = fmaxf(mx[nt][1], fmaxf(relu_bf16(c[1] + B0[col + 1]), relu_bf16(c[3] + B0[col + 1])));
"""
K6_GLOBAL_COUNTER = """constexpr unsigned kAll = 0xffffffffu;
__device__ unsigned long long g_next;  // the next point to take, zeroed before each launch
"""
K6_LOOP = """    const uint32_t* ab = abuf + b * kTiles * 2 * 32 + lane;
    for (int q = 0; q < tiles; ++q) {  // the packed m-tiles one by one (none where no slot is kept)
      const uint32_t aq[2] = {ab[2 * q * 32], ab[(2 * q + 1) * 32]};
      mlp_mtile(aq, W0, B0, mx);
    }
"""
# the b64 variant's own products: NT m-tiles through the three layers at once, each B fragment shared by them
K6_MLP_TILES = """// m-tiles 0 .. NT - 1 of a through the scale's three layers (W0 / B0: its packed weights and
// biases in shared memory; layers 1 and 2's biases are read into registers once for the NT m-tiles) into
// the running max mx of this lane's columns of the raw layer-3 sums
template <int NT>
__device__ __forceinline__ void mlp_tiles(const uint32_t (&a)[kTiles][2], const __nv_bfloat16* W0,
                                          const float* B0, float (&mx)[16][2]) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  const __nv_bfloat16* W1 = W0 + kW0;
  const __nv_bfloat16* W2 = W1 + kW1;
  float b0[8], b1[16];
  load_bias(B0, b0, b1);
  // layer 1: 6 -> 32, K zero-padded to 16; an ldmatrix.x4 gives n-tiles 2np and 2np + 1, both k halves
  uint32_t a2[NT][2][4];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t bq[4];
    ldsm_x4(bq, W0 + ((2 * np + (i >> 1)) * 8 + r) * kLd0 + (i & 1) * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * np + h;
#pragma unroll
      for (int mt = 0; mt < NT; ++mt) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const uint32_t af[4] = {a[mt][0], a[mt][1], 0u, 0u};
        mma16816(c, af, bq[2 * h], bq[2 * h + 1]);
        a2[mt][nt >> 1][(nt & 1) * 2] = relu_pack(c[0] + b0[2 * nt], c[1] + b0[2 * nt + 1]);
        a2[mt][nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[2] + b0[2 * nt], c[3] + b0[2 * nt + 1]);
      }
    }
  }
  // layer 2: 32 -> 64; an ldmatrix.x4 gives one n-tile's two k-steps, each k-step's products of the
  // m-tiles issued together (they are independent; one m-tile's k-steps are not)
  uint32_t a3[NT][4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    uint32_t bq[4];
    ldsm_x4(bq, W1 + (nt * 8 + r) * kLd1 + i * 8);
    float c[NT][4];
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int mt = 0; mt < NT; ++mt) mma16816(c[mt], a2[mt][kt], bq[2 * kt], bq[2 * kt + 1]);
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      a3[mt][nt >> 1][(nt & 1) * 2] = relu_pack(c[mt][0] + b1[2 * nt], c[mt][1] + b1[2 * nt + 1]);
      a3[mt][nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[mt][2] + b1[2 * nt], c[mt][3] + b1[2 * nt + 1]);
    }
  }
  // layer 3: 64 -> 128, n-tile by n-tile into the masked running max of the raw sums
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    uint32_t bq[2][4];
    ldsm_x4(bq[0], W2 + (nt * 8 + r) * kLd2 + i * 8);
    ldsm_x4(bq[1], W2 + (nt * 8 + r) * kLd2 + 32 + i * 8);
    float c[NT][4];
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int mt = 0; mt < NT; ++mt)
        mma16816(c[mt], a3[mt][kt], bq[kt >> 1][(kt & 1) * 2], bq[kt >> 1][(kt & 1) * 2 + 1]);
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      mx[nt][0] = fmaxf(mx[nt][0], fmaxf(c[mt][0], c[mt][2]));
      mx[nt][1] = fmaxf(mx[nt][1], fmaxf(c[mt][1], c[mt][3]));
    }
  }
}

"""
K6_SHARED_B = """    const uint32_t* ab = abuf + b * kTiles * 2 * 32 + lane;
    uint32_t a[kTiles][2];
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt) a[mt][0] = ab[2 * mt * 32], a[mt][1] = ab[(2 * mt + 1) * 32];
    switch (tiles) {
      case 1: mlp_tiles<1>(a, W0, B0, mx); break;
      case 2: mlp_tiles<2>(a, W0, B0, mx); break;
      case 3: mlp_tiles<3>(a, W0, B0, mx); break;
      case 4: mlp_tiles<4>(a, W0, B0, mx); break;
      default: break;  // no kept slot in this chunk
    }
"""
# the next item's A words loaded into registers a chunk early, in place of cp.async into the warp's buffers
K6_REG_ROWS = """__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ chans, const Item& it, int s2, int tiles,
                                          int n, const unsigned char* sidx, uint32_t (&a)[kTiles][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* c = chans + (it.pt * s2 + it.ch * kChunk) * 12 + 6 * it.sc + 2 * t;
#pragma unroll
  for (int mt = 0; mt < kTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = mt * 16 + g + 8 * h;
      a[mt][h] = t < 3 && mt < tiles ? ld32(c + sidx[j < n ? j : 0] * 12) : 0u;
    }
  }
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&a)[kTiles][2], int q, int h) {
  return q == 0 ? a[0][h] : q == 1 ? a[1][h] : q == 2 ? a[2][h] : a[3][h];
}

"""
K6_REG = (
    ("  int tiles = compact(wlo, whi, sidx, n), b = 0;\n  load_rows(chans, cur, s2, tiles, n, sidx, abuf);",
     "  int tiles = compact(wlo, whi, sidx, n);\n  uint32_t a[kTiles][2];\n  load_rows(chans, cur, s2, tiles, n, sidx, a);"),
    ("    if (more) ntiles = compact(wlo, whi, sidx, n);\n"
     "    load_rows(chans, nxt, s2, ntiles, n, sidx, abuf + (b ^ 1) * kTiles * 2 * 32);  // an empty group past the last\n"
     "    asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");  // this item's words have landed",
     "    uint32_t na[kTiles][2];\n    if (more) ntiles = compact(wlo, whi, sidx, n);\n"
     "    if (more) load_rows(chans, nxt, s2, ntiles, n, sidx, na);"),
    ("      const uint32_t aq[2] = {ab[2 * q * 32], ab[(2 * q + 1) * 32]};",
     "      const uint32_t aq[2] = {pick(a, q, 0), pick(a, q, 1)};"),
    ("    const uint32_t* ab = abuf + b * kTiles * 2 * 32 + lane;\n", ""),
    ("    b ^= 1;", "#pragma unroll\n    for (int mt = 0; mt < kTiles; ++mt) a[mt][0] = na[mt][0], a[mt][1] = na[mt][1];"),
)
K6_PACK = """  if (klo) sidx[__popc(lo & below)] = (unsigned char)lane;
  if (khi) sidx[nlo + __popc(hi & below)] = (unsigned char)(32 + lane);
  __syncwarp();
  return (n + 15) >> 4;
"""
K6_NO_PACK = """  const int first = lo ? __ffs(lo) - 1 : 31 + __ffs(hi);  // a kept slot, where there is one
  sidx[lane] = (unsigned char)(klo ? lane : first);
  sidx[32 + lane] = (unsigned char)(khi ? 32 + lane : first);
  __syncwarp();
  const bool any = n > 0;
  n = 64;
  return any ? 4 : 0;
"""
K6_ZERO_NEXT = """  void* next = nullptr;
  if ((err = cudaGetSymbolAddress(&next, g_next)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(next, 0, sizeof(unsigned long long), stream)) != cudaSuccess) return (int)err;
  pe_mlp_pool_kernel<<<"""

K6_WGMMA = r"""
// K6 on the warpgroup products: one block of 4 warps (a warpgroup) per 64-slot chunk, warp w holding its rows
// 16 w .. 16 w + 15 as the A operand in registers, B read by descriptor from the weights in shared memory,
// each layer's accumulators packed to bf16 as the next layer's A.
#include "pe_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlocks = 3;
// one scale's weights in the canonical K-major layout without swizzle: per layer and 16-deep k-step, core
// matrices of 8 outputs x 8 inputs (128 bytes), the two k halves 128 bytes apart, the 8-output groups 256
constexpr int kC0 = 32 * 16, kC1 = 64 * 32, kC2 = 128 * 64;
constexpr int kCScale = kC0 + kC1 + kC2;

__device__ __forceinline__ int canon(int n, int k, int N) {
  return (((k >> 4) * (N >> 3) + (n >> 3)) * 2 + ((k >> 3) & 1)) * 64 + (n & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint64_t desc(const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

WGMMA_FUNCTIONS

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ int chunks_of(int total2, int s2) { return max(1, min((total2 + 63) >> 6, s2 >> 6)); }

__global__ void __launch_bounds__(kThreads, kBlocks)
pe_mlp_pool_kernel(const __nv_bfloat16* __restrict__ chans, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2, const int* __restrict__ total2,
                   const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack,
                   float* __restrict__ out, long long points, int s2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kCScale]
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kCScale);       // [2][kBScale]
  float* s_red = s_b + 2 * kBScale;                               // [4 warps][128]
  for (int e = threadIdx.x; e < 2 * kCScale; e += kThreads) {
    const int sc = e / kCScale;
    int r = e % kCScale, N = 32, K = 16, ld = kLd0, src = 0, dst = 0;
    if (r >= kC0 + kC1) r -= kC0 + kC1, N = 128, K = 64, ld = kLd2, src = kW0 + kW1, dst = kC0 + kC1;
    else if (r >= kC0) r -= kC0, N = 64, K = 32, ld = kLd1, src = kW0, dst = kC0;
    const int n = r / K, k = r % K;
    s_w[sc * kCScale + dst + canon(n, k, N)] = wpack[sc * kWScale + src + n * ld + k];
  }
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (long long pt = blockIdx.x; pt < points; pt += gridDim.x) {
    const int chunks = chunks_of(total2[pt], s2);
    for (int sc = 0; sc < 2; ++sc) {
      const __nv_bfloat16* W = s_w + sc * kCScale;
      const float* B = s_b + sc * kBScale;
      const __nv_bfloat16* wm = (sc ? w2 : w1) + pt * s2;
      const __nv_bfloat16* c = chans + pt * s2 * 12 + 6 * sc + 2 * t;
      float mx[16][2];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) mx[nt][0] = mx[nt][1] = neg_inf();
      for (int ch = 0; ch < chunks; ++ch) {
        const int r0 = ch * 64 + warp * 16 + g, r1 = r0 + 8;
        const uint32_t a1[4] = {t < 3 ? ld32(c + r0 * 12) : 0u, t < 3 ? ld32(c + r1 * 12) : 0u, 0u, 0u};
        const bool k0 = __bfloat162float(wm[r0]) > 0.0f, k1 = __bfloat162float(wm[r1]) > 0.0f;
        float d1[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) d1[i] = 0.0f;
        wg_fence();
        wgmma_n32(d1, a1, desc(W));
        wg_commit_wait();
        hold(d1);
        uint32_t a2[2][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = nt * 8 + 2 * t;
          a2[nt >> 1][(nt & 1) * 2] = relu_pack(d1[4 * nt] + B[col], d1[4 * nt + 1] + B[col + 1]);
          a2[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(d1[4 * nt + 2] + B[col], d1[4 * nt + 3] + B[col + 1]);
        }
        float d2[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d2[i] = 0.0f;
        wg_fence();
        wgmma_n64(d2, a2[0], desc(W + kC0));
        wgmma_n64(d2, a2[1], desc(W + kC0 + 64 * 16));
        wg_commit_wait();
        hold(d2);
        uint32_t a3[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = 32 + nt * 8 + 2 * t;
          a3[nt >> 1][(nt & 1) * 2] = relu_pack(d2[4 * nt] + B[col], d2[4 * nt + 1] + B[col + 1]);
          a3[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(d2[4 * nt + 2] + B[col], d2[4 * nt + 3] + B[col + 1]);
        }
        float d3[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) d3[i] = 0.0f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_n128(d3, a3[ks], desc(W + kC0 + kC1 + ks * 128 * 16));
        wg_commit_wait();
        hold(d3);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          mx[nt][0] = fmaxf(mx[nt][0], fmaxf(k0 ? d3[4 * nt] : neg_inf(), k1 ? d3[4 * nt + 2] : neg_inf()));
          mx[nt][1] = fmaxf(mx[nt][1], fmaxf(k0 ? d3[4 * nt + 1] : neg_inf(), k1 ? d3[4 * nt + 3] : neg_inf()));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = mx[nt][j];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (g == 0) s_red[warp * 128 + nt * 8 + 2 * t + j] = v;
        }
      }
      __syncthreads();
      const int col = threadIdx.x;
      const float v = fmaxf(fmaxf(s_red[col], s_red[128 + col]), fmaxf(s_red[256 + col], s_red[384 + col]));
      out[pt * 256 + sc * 128 + col] = relu_bf16(v + B[96 + col]);
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int unopose_pe_mlp_pool(const void* chans, const void* w1, const void* w2, const int* total2,
                                   const void* wpack, const float* bpack, float* out, long long points, int s2,
                                   cudaStream_t stream) {
  if (s2 > kMaxSlots || s2 % 64 != 0 || s2 == 0) return (int)cudaErrorInvalidValue;
  if (points == 0) return 0;
  const size_t smem = (size_t)2 * kCScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      4 * 128 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pe_mlp_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_mlp_pool_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = points;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_mlp_pool_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(chans), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), total2, static_cast<const __nv_bfloat16*>(wpack), bpack, out, points,
      s2);
  return (int)cudaGetLastError();
}
"""


def _wgmma_fn(n: int) -> str:
    """wgmma_n<n>(d, a, b): d += a b for a 64 x 16 bf16 A held as mma fragments by the warpgroup's warps and a
    16 x n B read by descriptor (K-major, no swizzle), float32 accumulators (n / 2 a thread)."""
    r = n // 2
    outs = ", ".join(f"%{i}" for i in range(r))
    regs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"__device__ __forceinline__ void wgmma_n{n}(float (&d)[{r}], const uint32_t (&a)[4], uint64_t b) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'               "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{outs}}}, '
            f'{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, 0;\\n}}\\n"\n'
            f"               : {regs}\n"
            f'               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));\n}}\n')


def _inline_headers(text: str, csrc: Path) -> str:
    """text with each ``#include "x.cuh"`` replaced by that header of ``csrc`` (another checkout's)."""
    return re.sub(r'#include "(\w+\.cuh)"', lambda m: (csrc / m.group(1)).read_text(), text)


def _between(text: str, start: str, end: str, new: str) -> str:
    """text with the span from ``start`` up to ``end`` (kept) replaced by ``new``."""
    if start not in text or end not in text:
        raise ValueError(f"the shipped source no longer holds {start[:60]!r}: update this variant")
    i = text.index(start)
    return text[:i] + new + text[text.index(end, i):]


K3_CAND_AT = """// a candidate read from device memory by three scalar loads, its |p|^2 computed again for every centre
__device__ __forceinline__ float4 cand_at(const float* cand, int pos, int n) {
  if (pos >= n) return make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
  const float x = __ldg(cand + 3 * pos), y = __ldg(cand + 3 * pos + 1), z = __ldg(cand + 3 * pos + 2);
  return make_float4(x, y, z, dot3(x, y, z, x, y, z));
}

"""
K3_SPAN_BITS = """// the bits of word w that lie in the permuted positions [lo, hi)
__device__ __forceinline__ uint32_t span_bits(int w, int lo, int hi) {
  const int from = min(max(lo - (w << 5), 0), 32), to = min(max(hi - (w << 5), 0), 32);
  const uint32_t below_to = to == 32 ? kFull : (1u << to) - 1u;
  const uint32_t below_from = from == 32 ? kFull : (1u << from) - 1u;
  return below_to & ~below_from;
}

"""
K3_WORD_COUNTS = """    // each chunk's r2 and r1 hits, counted from the words
    int ccnt[kChunks], c1cnt[kChunks];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) ccnt[ch] = c1cnt[ch] = 0;
    for (int w = lane; w < words; w += 32) {
      const uint32_t w2 = mm[2 * w], w1 = mm[2 * w + 1];
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const uint32_t in = span_bits(w, ch * width, (ch + 1) * width);
        ccnt[ch] += __popc(w2 & in);
        c1cnt[ch] += __popc(w1 & in);
      }
    }
    int total2 = 0, cnt1 = 0;
    bool over = false;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      ccnt[ch] = __reduce_add_sync(kFull, ccnt[ch]);
      c1cnt[ch] = __reduce_add_sync(kFull, c1cnt[ch]);
      total2 += ccnt[ch];
      cnt1 += c1cnt[ch];
      over |= ccnt[ch] > budget;
    }
    over |= total2 > k2 || cnt1 > k1;
    // the r2 and r1 hits with the smallest original index: the first met in original order
    int q_first = -1, enc1 = n * 4096;
    for (int i0 = 0; i0 < n && ((total2 > 0 && q_first < 0) || (cnt1 > 0 && enc1 == n * 4096)); i0 += 32) {
      const int i = i0 + lane;
      const int pos = i < n ? __ldg(inv_perm + i) : 0;
      const uint32_t f2 = __ballot_sync(kFull, i < n && ((mm[2 * (pos >> 5)] >> (pos & 31)) & 1u));
      const uint32_t f1 = __ballot_sync(kFull, i < n && ((mm[2 * (pos >> 5) + 1] >> (pos & 31)) & 1u));
      const int p2 = __shfl_sync(kFull, pos, f2 ? __ffs(f2) - 1 : 0);
      const int p1 = __shfl_sync(kFull, pos, f1 ? __ffs(f1) - 1 : 0);
      if (q_first < 0 && f2) q_first = p2;
      if (enc1 == n * 4096 && f1) enc1 = (i0 + __ffs(f1) - 1) * 4096 + p1;
    }
    if (q_first < 0) q_first = __ldg(inv_perm);
"""
K3_WORD_WALK = """    // the kept hits to their compacted slots, a chunk's words one by one, each lane its bit of a word
    const uint32_t below = (1u << lane) - 1u;
    int kept = 0;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c1 = c1cnt[ch], lo = ch * width, hi = lo + width;  // the chunk's permuted positions [lo, hi)
      int r1rank = 0, r2rank = 0;
      for (int g = lo >> 5; g <= (hi - 1) >> 5 && (r1rank < budget || c1 + r2rank < budget); ++g) {
        const uint32_t in = span_bits(g, lo, hi);
        const uint32_t b1 = mm[2 * g + 1] & in, b2only = mm[2 * g] & ~b1 & in;
        const uint32_t pos = (uint32_t)((g << 5) + lane);
        if ((b1 >> lane) & 1u) {
          const int rank = r1rank + __popc(b1 & below);
          if (rank < budget) srow[kept + rank] = pos | (1u << 16) | (1u << 24);
        }
        if ((b2only >> lane) & 1u) {
          const int rank = c1 + r2rank + __popc(b2only & below);
          if (rank < budget) srow[kept + rank] = pos | (1u << 16);
        }
        r1rank += __popc(b1);
        r2rank += __popc(b2only);
      }
      kept += min(ccnt[ch], budget);
    }
"""
K3_SCALAR_STORES = """// a staged row of k2 slot words to device memory, slot by slot
template <int kVec>
__device__ __forceinline__ void write_row(const uint32_t* srow, int base, int k2, uint32_t pad, int16_t* out_idx,
                                          uint8_t* out_valid, uint8_t* out_m1) {
  for (int s = threadIdx.x & 31; s < k2; s += 32) {
    const uint32_t v = s < base ? srow[s] : pad;
    out_idx[s] = (int16_t)(v & 0xffffu);
    out_valid[s] = (uint8_t)((v >> 16) & 0xffu);
    out_m1[s] = (uint8_t)(v >> 24);
  }
}

"""


# kernel: (source, entry point)
KERNELS = {"K1": ("fps.cu", "unopose_fps"), "K7": ("vit_attn.cu", "unopose_mha_fused"),
           "K9": ("fine_assign.cu", "unopose_fine_labels"), "K4": ("geo_rpe.cu", "unopose_geo_rpe"),
           "K6": ("pe_mlp_pool.cu", "unopose_pe_mlp_pool"), "K10": ("fine_assign.cu", "unopose_fine_accum"),
           "K3": ("first_k_select.cu", "unopose_first_k_select"), "K8": ("fine_assign.cu", "unopose_fine_colstats")}
SHIPPED = {"K1": "fps", "K7": "vit_attn", "K9": "fine_assign", "K4": "geo_rpe", "K6": "pe_mlp_pool",
           "K10": "fine_assign_accum", "K3": "first_k_select", "K8": "fine_assign_colstats"}


def sources(parent: Path | None, only=tuple(KERNELS)) -> dict:
    """{build name: (kernel, CUDA source text)} of the kernels in ``only``."""
    fps = (build.CSRC / "fps.cu").read_text()
    attn = (build.CSRC / "vit_attn.cu").read_text()
    fa = (build.CSRC / "fine_assign.cu").read_text()
    geo = (build.CSRC / "geo_rpe.cu").read_text()
    pe = (build.CSRC / "pe_mlp_pool.cu").read_text()
    fk = (build.CSRC / "first_k_select.cu").read_text()
    out = {"fps": ("K1", fps), "vit_attn": ("K7", attn), "fine_assign": ("K9", fa), "geo_rpe": ("K4", geo),
           "pe_mlp_pool": ("K6", pe), "fine_assign_accum": ("K10", fa), "first_k_select": ("K3", fk),
           "fine_assign_colstats": ("K8", fa)}
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
    # K9 only: K10 keeps its tensor map
    text = _sub(fa, "__device__ __forceinline__ void mbar_init",
                K9_CP_ASYNC_COPY + "__device__ __forceinline__ void mbar_init")
    text = _sub(text, "labels_kernel(const __nv_bfloat16* __restrict__ f1, const __grid_constant__ CUtensorMap f2_map",
                "labels_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ f2")
    text = _between(text, "      if (u < sweep && lane == 0) {\n        mbar_expect",
                    "      const int tp = u - kStages - tiles;", K9_CP_ASYNC_LOAD)
    out["fine_assign_cp_async"] = ("K9", _sub(text, "(f1), map, cm, cs, s1, s2, rm, rs, label1, keys",
                                              "(f1), static_cast<const __nv_bfloat16*>(f2), cm, cs, s1, s2, rm, rs, "
                                              "label1, keys"))
    # a ring of one slot and the IEEE division apply to K9 and K10 alike: one text each, timed on both
    no_ring = _sub(fa, "constexpr int kStages = 3;", "constexpr int kStages = 1;")
    out["fine_assign_no_ring"] = ("K9", no_ring)
    out["fine_assign_accum_no_ring"] = ("K10", no_ring)
    out["fine_assign_ld32"] = ("K9", _between(
        fa, "  const int lane = threadIdx.x & 31, i = lane >> 3;\n  // matrix i of an ldmatrix.x4",
        "\n// the warp's logits against one staged column tile", K9_LD32))
    ieee = _sub(fa, "const bool helper = m1 < 4096 && m2 < 4096;", "const bool helper = false;")
    out["fine_assign_ieee_division"] = ("K9", ieee)
    out["fine_assign_accum_ieee_division"] = ("K10", ieee)
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
    text = _between(pe, "// one m-tile of packed rows", "// The running max reduced", K6_MLP_TILES)
    out["pe_mlp_pool_b64"] = ("K6", _sub(text, K6_LOOP, K6_SHARED_B))
    text = _between(pe, "__device__ __forceinline__ void load_rows(", "// The next point of the block's range", K6_REG_ROWS)
    for old, new in K6_REG:
        text = _sub(text, old, new)
    out["pe_mlp_pool_registers"] = ("K6", text)
    out["pe_mlp_pool_no_packing"] = ("K6", _sub(pe, K6_PACK, K6_NO_PACK))
    text = _sub(pe, K6_RAW_MAX, K6_EPILOGUE_FIRST)
    text = _sub(text, "mx[nt][0] = mx[nt][1] = neg_inf();", "mx[nt][0] = mx[nt][1] = 0.0f;")
    out["pe_mlp_pool_epilogue_first"] = ("K6", _sub(
        text, "make_float2(relu_bf16(mx[nt][0] + B2[col]), relu_bf16(mx[nt][1] + B2[col + 1]))",
        "make_float2(mx[nt][0], mx[nt][1])"))
    # the points: every warp of the grid from one counter in device memory, or the first design's static stride
    text = _sub(pe, "constexpr unsigned kAll = 0xffffffffu;\n", K6_GLOBAL_COUNTER)
    text = _sub(text, "atomicAdd(s_next, 1ull)", "atomicAdd(&g_next, 1ull)")
    text = _sub(text, "  const long long last = min(points, first + share);", "  const long long last = points;")
    out["pe_mlp_pool_atomic"] = ("K6", _sub(text, "  pe_mlp_pool_kernel<<<", K6_ZERO_NEXT))
    text = _sub(pe, "Item cur{take_point(s_next, last), 0, 0, 0};",
                "Item cur{(long long)blockIdx.x * kWarps + (threadIdx.x >> 5), 0, 0, 0};")
    text = _sub(text, "      n.pt = take_point(s_next, last);", "      n.pt = it.pt + (long long)gridDim.x * kWarps;")
    out["pe_mlp_pool_stride"] = ("K6", _sub(text, "  const long long last = min(points, first + share);",
                                            "  const long long last = points;"))
    out["pe_mlp_pool_wgmma"] = ("K6", K6_WGMMA.replace("WGMMA_FUNCTIONS", "".join(_wgmma_fn(n) for n in (32, 64, 128))))
    kernel_head = "__global__ void __launch_bounds__(kWarps * 32)"
    text = _sub(fk, kernel_head, K3_CAND_AT + kernel_head)
    out["first_k_select_global_scan"] = ("K3", _sub(
        text, "const float4 p0 = s_pts[(g << 5) + lane], p1 = s_pts[((g + 1) << 5) + lane];",
        "const float4 p0 = cand_at(cand, (g << 5) + lane, n), p1 = cand_at(cand, ((g + 1) << 5) + lane, n);"))
    for c in (1, 2, 8):
        out[f"first_k_select_c{c}"] = ("K3", _sub(fk, "constexpr int kCentres = 4;", f"constexpr int kCentres = {c};"))
    out["first_k_select_w16"] = ("K3", _sub(fk, "constexpr int kWarps = 8;", "constexpr int kWarps = 16;"))
    out["first_k_select_ordered_walk"] = ("K3", _sub(fk, "const bool walk2 = 64 * total2 >= n, walk1 = 64 * cnt1 >= n;",
                                                    "const bool walk2 = total2 > 0, walk1 = cnt1 > 0;"))
    out["first_k_select_keys_only"] = ("K3", _sub(fk, "const bool walk2 = 64 * total2 >= n, walk1 = 64 * cnt1 >= n;",
                                                 "const bool walk2 = false, walk1 = false;"))
    for f in (4, 16, 32):
        out[f"first_k_select_walk_at_{f}"] = ("K3", _sub(
            fk, "const bool walk2 = 64 * total2 >= n, walk1 = 64 * cnt1 >= n;",
            f"const bool walk2 = {f} * total2 >= n, walk1 = {f} * cnt1 >= n;"))
    out["first_k_select_scalar_stores"] = ("K3", _between(
        fk, "// a staged row of k2 slot words to device memory", kernel_head, K3_SCALAR_STORES))
    # the first design's compaction: chunk counts from the words, then a chunk's words walked one by one
    row_head = "// a staged row of k2 slot words to device memory"
    text = _sub(fk, row_head, K3_SPAN_BITS + row_head)
    text = _between(text, "    // the lane's words it * 32 + lane",
                    "    const long long row = (long long)b * n + q0 + c;", K3_WORD_COUNTS)
    out["first_k_select_word_walk"] = ("K3", _between(text, "    // the kept hits to their compacted slots, each lane",
                                                      "    __syncwarp();\n    const uint32_t pad", K3_WORD_WALK))
    out["fine_assign_colstats_sync"] = ("K8", _sub(fa, "constexpr int kColStages = 2;",
                                                   "constexpr int kColStages = 1;"))
    out["fine_assign_colstats_4warps"] = ("K8", _sub(fa, "constexpr int kColNt = 4; ", "constexpr int kColNt = 8; "))
    text = _sub(fa, "constexpr int kColNt = 4; ", "constexpr int kColNt = 2; ")
    one_block = ("constexpr int kColBlocks = 2; ", "constexpr int kColBlocks = 1; ")
    out["fine_assign_colstats_16warps"] = ("K8", _sub(text, *one_block))
    text = _sub(fa, "constexpr int kColStages = 2;", "constexpr int kColStages = 3;")
    out["fine_assign_colstats_3stages"] = ("K8", _sub(text, *one_block))
    if parent is not None:
        csrc = parent / "unopose_tpu_torch" / "kernels" / "csrc"
        for kernel, name in SHIPPED.items():
            out[f"{name}_parent"] = (kernel, _inline_headers((csrc / KERNELS[kernel][0]).read_text(), csrc))
    return {name: v for name, v in out.items() if v[0] in only}


def compile_all(srcs: dict, workdir: Path) -> dict:
    """Build every distinct source text into workdir/<name>.so (named after its first build), all nvcc
    processes at once; {name: ctypes.CDLL}."""
    workdir.mkdir(parents=True, exist_ok=True)
    first = {}  # text: the first build of it
    for name, (_, text) in srcs.items():
        first.setdefault(text, name)

    def one(name):
        text = srcs[name][1]
        src, lib = workdir / f"{name}.cu", workdir / f"{name}.so"
        src.write_text(text)
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared", "-o", str(lib),
                            str(src)], capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise build.KernelBuildError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(first)) as ex:
        libs = dict(ex.map(one, first.values()))
    return {name: libs[first[text]] for name, (_, text) in srcs.items()}


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


def accum_inputs(fine, gen) -> tuple:
    """K10's inputs on K9's: the plain twin's row statistics and labels, and pts2 uniform in [-1, 1)^3, as
    chip_smoke.py makes them."""
    f1n, f2n, cm, cs, s1, s2 = fine
    Bp, M2 = cs.shape
    pts2 = torch.rand(Bp, M2 - 1, 3, device=f1n.device, generator=gen) * 2 - 1
    return (*fine, *assignment_fused.labels_plain(*fine), pts2)


def select_inputs(dev, rng, n: int, cloud: str = "cubes") -> tuple:
    """K3's arguments at budgets 64 / 256 on 32 clouds of n points: ``cubes``, uniform in a 0.2 m cube in
    their global LRF, as chip_smoke.py makes them (the LRF scales a cloud to a radius of about 1); ``dense``,
    uniform in a 0.1 m cube as it is (every point inside r2 of every other); ``surfaces``, (n 2048) on the
    sphere surfaces. Then the plain twin's outputs and which budgets they overflow."""
    from unopose_tpu_torch.configs import surface_clouds
    from unopose_tpu_torch.ops.ball_query import first_k_select_plain, permutation

    B2, k1, k2 = 32, 64, 256
    perm, inv_perm = permutation(n, dev)
    if cloud == "surfaces":
        pts = torch.from_numpy(surface_clouds(rng, B2, perm.cpu().numpy())).to(dev)
    elif cloud == "dense":
        pts = torch.from_numpy(rng.uniform(-0.05, 0.05, size=(B2, n, 3)).astype(np.float32)).to(dev)
    else:
        pts = rng.uniform(-0.1, 0.1, size=(B2, n, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
        pts = global_lrf(torch.from_numpy(pts).to(dev))
    pts = pts.float().contiguous()
    args = (pts, pts.index_select(1, perm.long()).contiguous(), perm, inv_perm, 0.1, k1, 0.2, k2)
    plain = first_k_select_plain(*args)
    # a chunk over its budget keeps fewer slots than the centre has r2 hits
    kept = plain["validslot"].sum(dim=-1)
    over = dict(chunk=bool((kept < plain["total2"]).any()), total2=bool((plain["total2"] > k2).any()),
                cnt1=bool((plain["cnt1"] > k1).any()))
    return args, plain, over


def pe_inputs(dev, rng, surfaces: bool) -> tuple:
    """K6's arguments (before the point count) at the main shape as chip_smoke.py makes them: 32 clouds of
    2048 points, uniform in a 0.2 m cube in their global LRF or on sphere surfaces that fill every 64-slot
    tier, grouped at budgets 64 / 256; the plain twin's channels; the fine PE's folded weights at seed 0."""
    from unopose_tpu_torch.configs import surface_clouds
    from unopose_tpu_torch.models.matching import FinePositionalEncoding
    from unopose_tpu_torch.ops.ball_query import permutation, two_scale_group_first_k_packed_idx

    B2, N = 32, 2048
    if surfaces:
        perm, _ = permutation(N, "cpu")
        pts = torch.from_numpy(surface_clouds(rng, B2, perm.numpy())).to(dev)
    else:
        pts = rng.uniform(-0.1, 0.1, size=(B2, N, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
        pts = global_lrf(torch.from_numpy(pts).to(dev))
    planes, idx_p, w1, w2, total2, _ = two_scale_group_first_k_packed_idx(0.1, 64, 0.2, 256, pts)
    chans = pe_fused.pe_channels_plain(planes, idx_p, w1, w2, total2, tuple(pts.unbind(-1)), 0.1, 0.2)
    torch.manual_seed(0)
    _, _, (wpack, bpack) = FinePositionalEncoding(256, fused=True).to(dev).folded_weights()
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    return chans.contiguous(), w1, w2, total2.to(torch.int32).contiguous(), wpack, bpack


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
    parser.add_argument("--only", default=",".join(KERNELS))
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
    only = args.only.split(",")
    if "K9" in only or "K10" in only:
        fine = fine_inputs(dev, gen)
        # and with f1n scaled by 40, where pred underflows: fast_div.cuh's exact path for tiny dividends
        f1x = (fine[0].float() * 40.0).to(torch.bfloat16)
        shapes["K9"] = {"16x2049x2049x256": fine,
                        "16x2049x2049x256 q x40": (f1x, fine[1], *assignment_fused.colstats_plain(f1x, fine[1]),
                                                   *fine[4:])}
        if "K10" in only:
            shapes["K10"] = {key: accum_inputs(v, gen) for key, v in shapes["K9"].items()}
    if "K6" in only:
        shapes["K6"] = {"32x2048 S2 256 cubes": pe_inputs(dev, rng, False),
                        "32x2048 S2 256 surfaces": pe_inputs(dev, rng, True)}
    if "K3" in only:
        shapes["K3"] = {"32x2048 cubes": select_inputs(dev, rng, 2048),
                        "32x2048 surfaces": select_inputs(dev, rng, 2048, "surfaces"),
                        "32x2048 dense": select_inputs(dev, rng, 2048, "dense"),
                        **{f"32x{n} cubes": select_inputs(dev, rng, n) for n in (1984, 2000, 576, 272)}}
    if "K8" in only:
        f1n, f2n = (shapes["K9"]["16x2049x2049x256"] if "K9" in shapes else fine_inputs(dev, gen))[:2]
        small = {}
        for b, m1, m2, c in ((4, 300, 257, 48), (2, 65, 130, 16)):
            f1s, f2s = (torch.nn.functional.normalize(torch.randn(b, m, c, device=dev, generator=gen), dim=-1)
                        for m in (m1, m2))
            small[f"{b}x{m1}x{m2}x{c}"] = ((f1s / 0.1).to(torch.bfloat16), f2s.to(torch.bfloat16))
        shapes["K8"] = {"16x2049x2049x256": (f1n, f2n), "16x2049x2049x256 q x40": ((f1n.float() * 40.0).to(
            torch.bfloat16), f2n), **small}
    if "K4" in only:
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
        elif kernel == "K10":
            a = shapes["K10"][key]  # f1n, f2n, cm, cs, s1, s2, rm, rs, label1, label2, pts2
            Bp, M1, C = a[0].shape
            M2 = a[1].shape[1]
            wsum = torch.empty((Bp, M1), device=dev)
            num = torch.empty((Bp, M1, 3), device=dev)
            ptrs = [_P(x.data_ptr()) for x in (*a, wsum, num)]
            call = lambda: lib.unopose_fine_accum(*ptrs, Bp, M1, M2, C, stream())
            outs = (wsum, num)
        elif kernel == "K3":
            (pts, pts_p, perm, inv_perm, r1, k1, r2, k2), _, _ = shapes["K3"][key]
            Bc, n, _ = pts.shape
            sel = dict(idx_p=torch.empty((Bc, n, k2), dtype=torch.int16, device=dev),
                       validslot=torch.empty((Bc, n, k2), dtype=torch.bool, device=dev),
                       m1slot=torch.empty((Bc, n, k2), dtype=torch.bool, device=dev),
                       **{k: torch.empty((Bc, n), dtype=torch.int32, device=dev)
                          for k in ("cnt1", "enc1", "total2", "q_first")})
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            ptrs = [_P(x.data_ptr()) for x in (pts, pts_p, perm, inv_perm)]
            optrs = [_P(x.data_ptr()) for x in (*sel.values(), flag)]

            def call():  # the overflow flag is zeroed before each launch, as the wrapper allocates it
                flag.zero_()
                return lib.unopose_first_k_select(*ptrs, Bc, n, k1, k2, r1 * r1, r2 * r2, *optrs, stream())
            outs = (*sel.values(), flag)
        elif kernel == "K8":
            f1n, f2n = shapes["K8"][key]
            Bp, M1, C = f1n.shape
            M2 = f2n.shape[1]
            cm, cs = (torch.empty((Bp, M2), device=dev) for _ in range(2))
            ptrs = [_P(x.data_ptr()) for x in (f1n, f2n, cm, cs)]
            call = lambda: lib.unopose_fine_colstats(*ptrs, Bp, M1, M2, C, stream())
            outs = (cm, cs)
        elif kernel == "K6":
            a = shapes["K6"][key]  # chans, w1, w2, total2, wpack, bpack
            Bc, P, S2, _ = a[0].shape
            out = torch.empty((Bc, P, 256), device=dev)
            ptrs = [_P(x.data_ptr()) for x in (*a, out)]
            call = lambda: lib.unopose_pe_mlp_pool(*ptrs, Bc * P, S2, stream())
            outs = (out,)
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

    shipped = SHIPPED
    # K4's float32 contraction only for the shipped and parent builds (the variants are of the bf16 path), K9's
    # and K10's scaled q for those and the IEEE division
    extra = ("geo_rpe", "geo_rpe_parent", "fine_assign", "fine_assign_parent", "fine_assign_ieee_division",
             "fine_assign_accum", "fine_assign_accum_parent", "fine_assign_accum_ieee_division",
             "fine_assign_colstats", "fine_assign_colstats_parent")
    cases = [(name, key) for name in srcs for key in shapes[srcs[name][0]]
             if not ((key.endswith("f32") or key.endswith("x40")) and name not in extra)]
    times = {c: [] for c in cases}
    heads = [x.reshape(B, N, H, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
    sdpa = []
    for order in (cases, cases[::-1]):
        if "K7" in only:
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
            if kernel == "K3":
                _, plain, over = shapes["K3"][key]
                check["equal_plain"] = all(torch.equal(o.view(-1), plain[k].to(o.dtype).view(-1))
                                           for o, k in zip(outs, SELECT_KEYS))
                check["overflows"] = over
        results.append(dict(build=name, kernel=kernel, shape=key, ms=float(np.median(times[(name, key)])),
                            **check))
    if "K7" in only:
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
