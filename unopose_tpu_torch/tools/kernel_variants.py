"""What each part of the K1 (FPS), K7 (ViT attention), K9 and K10 (the fused assignment's labels and
accumulation), K4 (int8 geometric embedding), K6 (the fine PE's MLP and pool), K3 (the first_k select), K8
(the fused assignment's column statistics), K5 (the fine PE's channels), K26 (the compaction script's banked
gather) and K11-K14 and K18 (the train PE's passes) designs buys, on one CUDA card.

    python -m unopose_tpu_torch.tools.kernel_variants [--parent DIR] [--only K12,K14] [--reps 20] [--out FILE]

Builds the shipped sources ``kernels/csrc/fps.cu``, ``vit_attn.cu``, ``fine_assign.cu``, ``geo_rpe.cu``,
``pe_mlp_pool.cu``, ``first_k_select.cu``, ``pe_channels.cu`` and ``compact_micro.cu`` and variants of each, every variant the shipped text with one design
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
40), 4 pairs of 300 x 257 rows, C 48 (off the 64-row grid, 32-byte swizzle) and 2 of 65 x 130 rows, C 16, K5 on
the plain twin's inputs at 32 x 2048 points, S2 256, on the uniform cubes and on the sphere surfaces that fill
every 64-slot tier, on the cubes with every seventh point's total2 set to 0, on 4 cubes of 4096 points and on 32
cubes of 2000 points at S2 128 (a point count no multiple of a block's, tiers clipped to S2), every build's output
buffer zeroed first, so that a slot written past a point's tier shows; K26 on
``benchmarks/profile_compact_micro.py:script_inputs`` (65536 rows of 2048 words, 256 draws a row) and on those
rows' first 1000 with every seventh bank index outside [0, 16). The
builds run in turns, forward, backward and forward again, and each reports the median of its three times (two
turns left a build's place in the run in its time: the same code read 7% apart). ``--parent DIR``: a
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
Variants of K5 (shipped: a block of 8 warps stages its cloud's planes once for 128 points, each warp 16 points in
four passes, one point at a time, the sums of a point over its slots with the lanes over the slots (warp_sum's
butterfly), the scalar steps of the frame once for the warp's points with lane p on point p, two slots a lane per
loop step, each slot's row as three 8-byte stores): ``w4`` and ``w16``, 4 or 16 warps a block; ``p32``, 32 points
a warp (every lane busy in the scalar steps, half the warps); ``staged_stores``, a warp's 32 slot rows written
through a 768-byte buffer in shared memory as 16-byte vectors.
Variants of K26 (shipped: each thread 8 quads of outputs, every index load of its quads issued before its gathers
from device memory, streaming cache hints, a grid of every quad): ``quads2`` and ``quads4``, 2 or 4 quads a thread;
``ldcg``, the gathers cached in L2 only (``__ldcg``) in place of the streaming hint; ``default_cache``, no cache
hint on any load or store; ``streamed``, the rows streamed in order through a ring of 4 shared-memory stages of 4
rows (words, li and bi by bulk copies on an mbarrier each stage), one persistent block an SM, the gathers from
shared memory.
Beside K26, one ``torch.gather`` of the flat indices bi * 128 + li (int64, made outside the timing) over x, the
yardstick.
The train PE's passes (``pe_train.cu``: K11 statistics at depths 1-3, K12 forward, K13 backward sums at layers
3-1, K14 weight gradients, K18 frozen-BN backward) at B 8 x P 2048 x S 256 and 64 on ``chip_smoke.py``'s phase-3
inputs (``configs.pe_train_chans``: a third of each point's slots distinct, the rest pads that tie) and at
``test_pe_train_odd_tiles``' B 3 x P 37 x S 16, 48, 80 and 112 (``ODD_S``; as there, at S 80 and 112 a point whose
shipped K12 max moves from the plain forward's by more than 1e-5 of the largest, at most 2, takes no cotangent on
either side; S 16 and 48 take the full cotangent), each backward
fed the shipped K12's max and tie counts and the plain passes' statistics and deeper sums. Variants of K12
(shipped: ``fwd_wg_kernel``, four warpgroups a block, 16 warps an SM, each warpgroup a 64-slot tile through wgmma
with A from registers, each thread's running max and tie count in its row of shared memory): ``mma_sync``, the
first design (the template's kFwd pass: one warp a point, mma.sync m16n8k16); ``one_group``, one warpgroup a
block, three blocks an SM; ``two_groups``, two a block, two blocks; ``five_groups``, five a block (20 warps).
Variants of K14 (shipped: ``dw_wg_kernel``, two chain warpgroups and a dW warpgroup, a ring of two
stages, one a chain): ``mma_sync``, the first design (the template's kBwdDw pass: 16 warps staging by stmatrix,
mma.sync); ``ring4``, four stages, two a chain; ``one_chain`` and ``one_chain_ring3``, one chain warpgroup with a
ring of 2 or 3; ``three_chains``, three chain warpgroups (16 warps, 128 registers), a ring of 3. ``--only K12,K14``
also builds K11's, K13's and K18's shipped (and, with ``--parent``, parent) builds and the tie-count checks. K14's
records carry ``half_grid_max_abs``, the build's largest dW difference from its own run on a grid capped at half
the first design's blocks at that shape (``cap``). Variants of K13 and K18
(shipped: z1 and z2 recomputed from the bf16 fragments, dz3, dz2 and y2's gates read back from shared memory for
the layer below, ldmatrix fragments of one copy of the weights, packed constants, the next m-tile's chans in
flight, two m-tiles a step at K13's layer 3, the sums reduced over n-tile pairs, 8-warp blocks two an SM for K13,
one 16-warp block an SM staging by stmatrix for K18):
``volatile_mma``, the products as volatile asm (kept in program order); ``no_prefetch``, each m-tile's chans loaded
at its start; ``group2`` and ``group8``, two or eight n-tiles of dy accumulated together (shipped: eight for K18,
four for K13); ``fmax_relu``, the ReLU by fmaxf before the bf16 conversion;
``dz_registers``, dz3 and dz2 held in registers and y2's gates too; ``single_tiles`` (K13), one m-tile a step at
layer 3; ``three_blocks`` (K13), dz in registers, one m-tile a step and three blocks an SM;
``one_block`` (K11), its kernels not held to two blocks an SM; ``pairs`` (K11), two m-tiles a step
at depth 3. The tie-count checks
``pe_train_bwd_sums_ties`` and ``pe_train_frozen_bwd_ties`` (and ``*_ties_parent``) count, per (point, channel),
the slots whose recomputed y3 equals the forward's max (``TIE_ANCHORS``), against the shipped K12's tie count: not
timed.

Every build's output is checked: K1's indices equal to the plain loop's, K7's outputs, K9's rm, rs, label1 and
column keys, K10's wsum and num, K4's int8 codes, K6's pooled features, K3's eight outputs (each also equal to
the plain twin's), K8's cm and cs, K5's channels (every slot, the unwritten ones zero) and K26's outputs (also
equal to the plain twin's) bitwise equal to the shipped kernel's (for K7's ``parent``, the first version, the share
of equal outputs is reported too); the train passes' outputs against the plain passes at phase 3's gates, two runs
bitwise equal, and their largest difference from the shipped build's (the sums' rounding follows the block count,
which follows the occupancy). K5's, K26's and the train passes' records also carry what ``-Xptxas -v`` says of the
kernel (registers a thread, spill bytes, static shared memory; a train pass's kernel function, K12's and K14's
warpgroup kernels or else its ``pe_train_kernel`` instantiation),
K5's and the train passes' the warps an SM holds of the kernel (the runtime's occupancy query,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, on a probe compiled into each build; K5 at N 2048) and K5's each
shape's tier histogram (points needing 1-4 chunks of 64 slots). Prints the card's name and power
limit, then one JSON line; ``--out`` writes the JSON there too.
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
    Out* row = p.out + (size_t)bi * n * p.D + c0 + cl * kCh;
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


def _lines(text: str, first: str, last: str, new: str) -> str:
    """text with its lines from the one holding ``first`` to the next holding ``last`` replaced by ``new``,
    indented as the first of them."""
    if first not in text:
        raise ValueError(f"the shipped source no longer holds {first[:60]!r}: update this variant")
    at = text.index(first)
    start = text.rindex("\n", 0, at) + 1
    end = text.index("\n", text.index(last, at)) + 1
    indent = text[start:at]
    return text[:start] + "".join(indent + line + "\n" for line in new.strip("\n").split("\n")) + text[end:]


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
# K26 streamed: the rows through a ring of shared-memory stages filled by bulk copies (kernel and launcher)
K26_STREAMED = r"""constexpr int kGatherRows = 4;    // rows a stage: 4 x (8 KB of words + 1 KB of li + 1 KB of bi)
constexpr int kGatherStages = 4;  // stages a block: 160 KB
constexpr int kStageWords = kGatherRows * (kRowWords + 2 * kOut);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// the barrier's arrival, which also makes its phase wait for bytes more of copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from src to dst by the copy engine, counted on bar's transactions
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// group g's rows (kGatherRows from g * kGatherRows on, fewer at the end) into a stage: words, then li, then bi
__device__ __forceinline__ void load_group(int* stage, uint64_t* bar, const int* x, const int* li, const int* bi,
                                           long long g, int rows) {
  const long long r0 = g * kGatherRows;
  const int nr = (int)min((long long)kGatherRows, rows - r0);
  mbar_arrive_expect(bar, nr * (kRowWords + 2 * kOut) * 4);
  bulk_load(stage, x + r0 * kRowWords, nr * kRowWords * 4, bar);
  bulk_load(stage + kGatherRows * kRowWords, li + r0 * kOut, nr * kOut * 4, bar);
  bulk_load(stage + kGatherRows * (kRowWords + kOut), bi + r0 * kOut, nr * kOut * 4, bar);
}

__global__ void __launch_bounds__(kThreads)
compact_gather_kernel(const int* __restrict__ x, const int* __restrict__ li, const int* __restrict__ bi,
                      int* __restrict__ out, int rows) {
  extern __shared__ __align__(128) int s_ring[];  // kGatherStages x kStageWords
  __shared__ __align__(8) uint64_t full[kGatherStages];
  const long long groups = (rows + kGatherRows - 1) / kGatherRows;
  const long long mine = (groups - blockIdx.x + gridDim.x - 1) / gridDim.x;  // groups blockIdx.x + i * gridDim.x
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGatherStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kGatherStages && i < mine; ++i)
      load_group(s_ring + i * kStageWords, &full[i], x, li, bi, blockIdx.x + (long long)i * gridDim.x, rows);
  }
  __syncthreads();
  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % kGatherStages);
    const long long g = blockIdx.x + i * gridDim.x;
    const int nq = (int)min((long long)kGatherRows, rows - g * kGatherRows) * (kOut / 4);
    const int* stage = s_ring + s * kStageWords;
    mbar_wait(&full[s], (int)((i / kGatherStages) & 1));
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const int4 l = reinterpret_cast<const int4*>(stage + kGatherRows * kRowWords)[q];
      const int4 b = reinterpret_cast<const int4*>(stage + kGatherRows * (kRowWords + kOut))[q];
      const int* row = stage + (q / (kOut / 4)) * kRowWords;
      int4 o;
      o.x = (unsigned)b.x < (unsigned)kBanks ? row[b.x * 128 + l.x] : 0;
      o.y = (unsigned)b.y < (unsigned)kBanks ? row[b.y * 128 + l.y] : 0;
      o.z = (unsigned)b.z < (unsigned)kBanks ? row[b.z * 128 + l.z] : 0;
      o.w = (unsigned)b.w < (unsigned)kBanks ? row[b.w * 128 + l.w] : 0;
      reinterpret_cast<int4*>(out)[g * kGatherRows * (kOut / 4) + q] = o;
    }
    __syncthreads();  // every thread is done with the stage
    if (threadIdx.x == 0 && i + kGatherStages < mine)
      load_group(s_ring + s * kStageWords, &full[s], x, li, bi, g + (long long)kGatherStages * gridDim.x, rows);
  }
}

"""
K26_STREAMED_LAUNCH = r"""// x (rows, 2048), li and bi (rows, 256) int32 -> out (rows, 256) int32; every pointer 16-byte aligned
extern "C" int unopose_compact_gather(const int* x, const int* li, const int* bi, int* out, int rows,
                                      cudaStream_t stream) {
  if (rows < 0 || ((uintptr_t)x | (uintptr_t)li | (uintptr_t)bi | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const size_t smem = (size_t)kGatherStages * kStageWords * sizeof(int);
  cudaError_t err =
      cudaFuncSetAttribute(compact_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_gather_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long groups = ((long long)rows + kGatherRows - 1) / kGatherRows;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(groups < resident ? groups : resident);
  compact_gather_kernel<<<blocks, kThreads, smem, stream>>>(x, li, bi, out, rows);
  return (int)cudaGetLastError();
}

"""

# the train PE's kernels (K11-K14, K18: one source, one template body) and the pe_train_kernel<mode, depth>
# instantiation each runs
TRAIN = ("K11", "K12", "K13", "K14", "K18")
TRAIN_MODE = {"K11": 0, "K12": 1, "K13": 2, "K14": 3, "K18": 4}
# the tie-count check: every slot whose recomputed y3 equals the forward's max adds one to its (point, channel)
# in g_ties, set by unopose_pe_train_set_ties (null: no count); declared after the includes
TIE_DECL = """__device__ unsigned* g_ties;
extern "C" int unopose_pe_train_set_ties(unsigned* p) { return (int)cudaMemcpyToSymbol(g_ties, &p, sizeof(p)); }
"""
# the pool backward's compare, in the shipped source and in the first design's (a slot's y3 against the row's
# max), and the count inserted after it
TIE_ANCHORS = (
    ("gv[m][j] = pre == (j & 1 ? pq.y : pq.x) ? (j & 1 ? pq.w : pq.z) : 0.0f;  // the pool backward",
     "if (g_ties && live[m] && fmaxf(pre, 0.0f) == pooled_in[pt * 128 + nt * 8 + 2 * t + (j & 1)]) "
     "atomicAdd(g_ties + pt * 128 + nt * 8 + 2 * t + (j & 1), 1u);"),
    ("float gv = y == pool[col] ? pool[128 + col] : 0.0f;  // the pool backward, ties split evenly",
     "if (g_ties && y == pool[col]) atomicAdd(g_ties + pt * 128 + col, 1u);"),
)
# the warps an SM holds of each instantiation, for a source without unopose_pe_train_resident_warps (the first
# design: 8 warps a block, its launcher's shared memory)
TRAIN_PROBE = """
namespace {
template <int kMode, int kDepth>
int resident_probe(int* warps) {
  auto kernel = pe_train_kernel<kMode, kDepth>;
  const size_t smem = (size_t)kWElems * 2 + (size_t)(kConsts + 2 * kWarps * 256) * 4 +
                      (kMode == kBwdDw || kMode == kBwdFrozen ? (size_t)kSRows * kLdS * 2 : 0) +
                      (kMode == kBwdFrozen ? (size_t)kWarps * kSums * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  *warps = blocks * kWarps;
  return (int)err;
}
}  // namespace
extern "C" int unopose_pe_train_resident_warps(int kernel, int depth, int* warps) {
  switch (kernel * 4 + depth) {
    case 11 * 4 + 1: return resident_probe<kStats, 1>(warps);
    case 11 * 4 + 2: return resident_probe<kStats, 2>(warps);
    case 11 * 4 + 3: return resident_probe<kStats, 3>(warps);
    case 12 * 4 + 3: return resident_probe<kFwd, 3>(warps);
    case 13 * 4 + 1: return resident_probe<kBwdSums, 1>(warps);
    case 13 * 4 + 2: return resident_probe<kBwdSums, 2>(warps);
    case 13 * 4 + 3: return resident_probe<kBwdSums, 3>(warps);
    case 14 * 4 + 0: return resident_probe<kBwdDw, 0>(warps);
    case 18 * 4 + 0: return resident_probe<kBwdFrozen, 0>(warps);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
TRAIN_PREFETCH = """      // the next step's chans: this point's next m-tiles, else the warp's next point's first
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (mt + kM < mtiles) {
          if (active && mt + kM + m < mtiles) load_tile(nx[m], cb, (mt + kM + m) * 16, plane, lane);
        } else if (npt < points && m < mtiles) {
          load_tile(nx[m], nb, m * 16, plane, lane);
        }
      }
"""
TRAIN_STEP = "      bool live[kM];  // a step's m-tiles inside the point (the last of an odd count runs idle)\n"
TRAIN_NO_PREFETCH = """#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (active && mt + m < mtiles) load_tile(nx[m], cb, (mt + m) * 16, plane, lane);
      }
"""
TRAIN_CVT_RELU = """  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
"""
TRAIN_BLOCKS = "return has_dw(mode) ? 1 : 2; }"
TRAIN_READ_BACK = "return mode == kBwdSums || has_dw(mode); }"
TRAIN_GROUP = "return has_dw(mode) ? 8 : 4; }"
TRAIN_PAIRS = "return mode == kBwdSums && depth == 3 ? 2 : 1; }"
# K12's and K14's warpgroup kernels: their launch constants, and their entry points' calls and occupancy cases,
# which the mma_sync variant sends to the template's kFwd and kBwdDw passes (the first designs)
TRAIN_FWD_LAUNCH = "constexpr int kFwdGroups = 4, kFwdBlocks = 1;\n"
TRAIN_DW_LAUNCH = "constexpr int kDwChains = 2, kDwStages = 2;\n"
TRAIN_MMA_SYNC = (
    ("  return (int)launch_fwd(chans, w0, w1, w2, bn, pooled, cnt, B, P, S, stream);",
     "  int blocks = 0;\n  return (int)launch<kFwd, 3>(chans, w0, w1, w2, bn, nullptr, nullptr, nullptr, pooled, cnt, "
     "nullptr, 0, B, P, S, &blocks, stream);"),
    ("launch_dw(chans, w0, w1, w2, bn, pooled, cnt, dpool, partial, cap, B, P, S, &blocks, stream);",
     "launch<kBwdDw, 0>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B, P, S, "
     "&blocks, stream);"),
    ("return resident_fwd(warps);", "return resident<kFwd, 3>(warps);"),
    ("return resident_dw(warps);", "return resident<kBwdDw, 0>(warps);"),
)
# the kernel function of K12's and K14's warpgroup designs (their mma.sync builds, *_mma_sync and *_parent, run the
# template's pe_train_kernel<mode, depth>)
WG_KERNELS = {"K12": "fwd_wg_kernel", "K14": "dw_wg_kernel"}


def with_train_probe(text: str) -> str:
    """A pe_train source with ``unopose_pe_train_resident_warps``: its own, or the first design's probe."""
    return text if "unopose_pe_train_resident_warps" in text else text + TRAIN_PROBE


def tie_check(text: str) -> str:
    """A pe_train source whose pool backward also counts, per (point, channel), the slots whose recomputed y3
    equals the forward's max (``g_ties``)."""
    text = _sub(text, "#include <stdint.h>\n", "#include <stdint.h>\n" + TIE_DECL)
    for anchor, count in TIE_ANCHORS:
        if anchor in text:
            return _lines(text, anchor, anchor, anchor + "\n" + count)
    raise ValueError("the pe_train source holds none of the pool backward's known compares: update TIE_ANCHORS")


def fwd_launch(groups: int, blocks: int) -> str:
    return f"constexpr int kFwdGroups = {groups}, kFwdBlocks = {blocks};\n"


def train_variants(text: str) -> dict:
    """{variant: (kernels timed, text)}: the shipped pe_train source with one design choice of K12's, K14's,
    K13's and K18's (or K11's) replaced."""
    registers = _sub(text, TRAIN_READ_BACK, "return has_dw(mode); }")
    no_prefetch = _sub(_sub(text, TRAIN_PREFETCH, ""), TRAIN_STEP, TRAIN_NO_PREFETCH + TRAIN_STEP)
    mma_sync = text
    for old, new in TRAIN_MMA_SYNC:
        mma_sync = _sub(mma_sync, old, new)
    dw = lambda chains, stages: _sub(text, TRAIN_DW_LAUNCH,
                                     f"constexpr int kDwChains = {chains}, kDwStages = {stages};\n")
    return {
        "mma_sync": (("K12", "K14"), mma_sync),
        "one_group": (("K12",), _sub(text, TRAIN_FWD_LAUNCH, fwd_launch(1, 3))),
        "two_groups": (("K12",), _sub(text, TRAIN_FWD_LAUNCH, fwd_launch(2, 2))),
        "five_groups": (("K12",), _sub(text, TRAIN_FWD_LAUNCH, fwd_launch(5, 1))),
        "ring4": (("K14",), dw(2, 4)),
        "one_chain": (("K14",), dw(1, 2)),
        "one_chain_ring3": (("K14",), dw(1, 3)),
        "three_chains": (("K14",), dw(3, 3)),
        "volatile_mma": (("K13", "K18"), _sub(text, '  asm("mma.sync.aligned', '  asm volatile("mma.sync.aligned')),
        "no_prefetch": (("K13", "K18"), no_prefetch),
        "group2": (("K13", "K18"), _sub(text, TRAIN_GROUP, "return 2; }")),
        "group8": (("K13", "K18"), _sub(text, TRAIN_GROUP, "return 8; }")),
        "fmax_relu": (("K13", "K18"), _sub(text, TRAIN_CVT_RELU, "  return pack(fmaxf(lo, 0.0f), fmaxf(hi, 0.0f));\n")),
        "dz_registers": (("K13", "K18"), registers),
        "single_tiles": (("K13",), _sub(text, TRAIN_PAIRS, "return 1; }")),
        "three_blocks": (("K13",), _sub(_sub(registers, TRAIN_PAIRS, "return 1; }"), TRAIN_BLOCKS,
                                        "return has_dw(mode) ? 1 : mode == kBwdSums ? 3 : 2; }")),
        "one_block": (("K11",), _sub(text, TRAIN_BLOCKS, "return has_dw(mode) || mode <= kFwd ? 1 : 2; }")),
        "pairs": (("K11",), _sub(text, TRAIN_PAIRS,
                                 "return (mode == kBwdSums || mode <= kFwd) && depth == 3 ? 2 : 1; }")),
    }


# kernel: (source, entry point)
KERNELS = {"K1": ("fps.cu", "unopose_fps"), "K7": ("vit_attn.cu", "unopose_mha_fused"),
           "K9": ("fine_assign.cu", "unopose_fine_labels"), "K4": ("geo_rpe.cu", "unopose_geo_rpe"),
           "K6": ("pe_mlp_pool.cu", "unopose_pe_mlp_pool"), "K10": ("fine_assign.cu", "unopose_fine_accum"),
           "K3": ("first_k_select.cu", "unopose_first_k_select"), "K8": ("fine_assign.cu", "unopose_fine_colstats"),
           "K5": ("pe_channels.cu", "unopose_pe_channels"), "K26": ("compact_micro.cu", "unopose_compact_gather"),
           "K11": ("pe_train.cu", "unopose_pe_train_stats"), "K12": ("pe_train.cu", "unopose_pe_train_fwd"),
           "K13": ("pe_train.cu", "unopose_pe_train_bwd_sums"), "K14": ("pe_train.cu", "unopose_pe_train_bwd_dw"),
           "K18": ("pe_train.cu", "unopose_pe_train_frozen_bwd")}
SHIPPED = {"K1": "fps", "K7": "vit_attn", "K9": "fine_assign", "K4": "geo_rpe", "K6": "pe_mlp_pool",
           "K10": "fine_assign_accum", "K3": "first_k_select", "K8": "fine_assign_colstats", "K5": "pe_channels",
           "K26": "compact_gather", "K11": "pe_train_stats", "K12": "pe_train_fwd", "K13": "pe_train_bwd_sums",
           "K14": "pe_train_bwd_dw", "K18": "pe_train_frozen_bwd"}
# the kernel function whose -Xptxas -v lines a build's record carries (a train kernel's: its instantiation of
# pe_train_kernel<mode, depth>, the depth from the shape, ptxas_fn)
PTXAS_OF = {"K5": "pe_channels_kernel", "K26": "compact_gather_kernel",
            **{k: f"pe_train_kernelILi{TRAIN_MODE[k]}ELi" for k in TRAIN}}


def train_depth(kernel: str, key: str) -> int:
    """The depth (K11) or layer (K13) of a train kernel's shape key; K12 runs depth 3, K14 and K18 0."""
    return int(key.split()[-1]) if kernel in ("K11", "K13") else 3 if kernel == "K12" else 0


def ptxas_fn(kernel: str, key: str, build: str = "") -> str:
    """The kernel function of build ``build`` (default: the shipped one) that runs ``kernel`` at shape ``key``."""
    if kernel in WG_KERNELS and not build.endswith(("_parent", "_mma_sync")):
        return WG_KERNELS[kernel]
    return PTXAS_OF[kernel] + (f"{train_depth(kernel, key)}E" if kernel in TRAIN else "")


def sources(parent: Path | None, only=tuple(KERNELS)) -> dict:
    """{build name: (kernel, CUDA source text)} of the kernels in ``only``."""
    fps = (build.CSRC / "fps.cu").read_text()
    attn = (build.CSRC / "vit_attn.cu").read_text()
    fa = (build.CSRC / "fine_assign.cu").read_text()
    geo = (build.CSRC / "geo_rpe.cu").read_text()
    pe = (build.CSRC / "pe_mlp_pool.cu").read_text()
    fk = (build.CSRC / "first_k_select.cu").read_text()
    ch = (build.CSRC / "pe_channels.cu").read_text()
    cm = (build.CSRC / "compact_micro.cu").read_text()
    pt = (build.CSRC / "pe_train.cu").read_text()
    out = {"fps": ("K1", fps), "vit_attn": ("K7", attn), "fine_assign": ("K9", fa), "geo_rpe": ("K4", geo),
           "pe_mlp_pool": ("K6", pe), "fine_assign_accum": ("K10", fa), "first_k_select": ("K3", fk),
           "fine_assign_colstats": ("K8", fa), "pe_channels": ("K5", ch), "compact_gather": ("K26", cm),
           **{SHIPPED[k]: (k, pt) for k in TRAIN}}
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
        geo, "p.k == 3 ? geo_rpe_kernel<Tab, kTile, kCh, 3, Out> : geo_rpe_kernel<Tab, kTile, kCh, kMaxK, Out>",
        "geo_rpe_kernel<Tab, kTile, kCh, kMaxK, Out>"))
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
    for warps in (4, 16):
        out[f"pe_channels_w{warps}"] = ("K5", _sub(ch, "constexpr int kWarps = 8;", f"constexpr int kWarps = {warps};"))
    out["pe_channels_p32"] = ("K5", _sub(ch, "constexpr int kPointsPerWarp = 16;", "constexpr int kPointsPerWarp = 32;"))
    out["pe_channels_staged_stores"] = ("K5", _lines(ch, "uint2* dst = reinterpret_cast<uint2*>(out",
                                                     "dst[2] = make_uint2(", K5_STAGED))
    for quads in (2, 4):
        out[f"compact_gather_quads{quads}"] = ("K26", _sub(cm, "constexpr int kQuads = 8;",
                                                           f"constexpr int kQuads = {quads};"))
    text = cm
    for c in "xyzw":
        text = _sub(text, f"__ldcs(row + b[k].{c} * 128 + l[k].{c})", f"__ldcg(row + b[k].{c} * 128 + l[k].{c})")
    out["compact_gather_ldcg"] = ("K26", text)
    text = cm
    for v in ("li", "bi"):
        text = _sub(text, f"__ldcs(reinterpret_cast<const int4*>({v}) + q)", f"reinterpret_cast<const int4*>({v})[q]")
    for c in "xyzw":
        text = _sub(text, f"__ldcs(row + b[k].{c} * 128 + l[k].{c})", f"row[b[k].{c} * 128 + l[k].{c}]")
    out["compact_gather_default_cache"] = ("K26", _sub(text, "__stcs(reinterpret_cast<int4*>(out) + q, o);",
                                                       "reinterpret_cast<int4*>(out)[q] = o;"))
    text = _between(cm, "constexpr int kQuads = 8;", "__global__ void __launch_bounds__(kThreads)\n"
                    "compact_wherechain_kernel", K26_STREAMED)
    out["compact_gather_streamed"] = ("K26", _between(text, "// x (rows, 2048), li and bi (rows, 256)",
                                                      "// li (rows, 256) int32", K26_STREAMED_LAUNCH))
    for variant, (kernels, text) in train_variants(pt).items():
        out.update({f"{SHIPPED[k]}_{variant}": (k, text) for k in kernels})
    ties = tie_check(pt)
    out["pe_train_bwd_sums_ties"], out["pe_train_frozen_bwd_ties"] = ("K13", ties), ("K18", ties)
    if parent is not None:
        csrc = parent / "unopose_tpu_torch" / "kernels" / "csrc"
        for kernel, name in SHIPPED.items():
            out[f"{name}_parent"] = (kernel, _inline_headers((csrc / KERNELS[kernel][0]).read_text(), csrc))
        ties = tie_check(out["pe_train_bwd_sums_parent"][1])
        out["pe_train_bwd_sums_ties_parent"], out["pe_train_frozen_bwd_ties_parent"] = ("K13", ties), ("K18", ties)
    out = {name: (k, with_train_probe(text) if k in TRAIN else text) for name, (k, text) in out.items()}
    picked = {name: v for name, v in out.items() if v[0] in only}
    if {"K12", "K14"} & set(only):
        # the passes beside K12 and K14: K11's, K13's and K18's shipped and parent builds (held bitwise to each
        # other) and the tie-count checks against the shipped K12's max
        picked.update({name: v for name, v in out.items() if v[0] in ("K11", "K13", "K18") and (
            name in SHIPPED.values() or name.endswith(("_parent", "_ties")))})
    return picked


def compile_all(srcs: dict, workdir: Path) -> tuple:
    """Build every distinct source text into workdir/<name>.so (named after its first build), all nvcc
    processes at once; ({name: ctypes.CDLL}, {name: the compiler's output})."""
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
        return name, (ctypes.CDLL(str(lib)), r.stdout + r.stderr)

    with ThreadPoolExecutor(len(first)) as ex:
        built = dict(ex.map(one, first.values()))
    return ({name: built[first[text]][0] for name, (_, text) in srcs.items()},
            {name: built[first[text]][1] for name, (_, text) in srcs.items()})


def ptxas_record(log: str, fn: str) -> dict:
    """What ``-Xptxas -v`` said of the kernel whose mangled name holds ``fn``: registers a thread, spill store
    and load bytes, static shared memory bytes."""
    for block in re.split(r"Compiling entry function", log)[1:]:
        if fn not in block.splitlines()[0]:
            continue
        num = lambda pat: int(m.group(1)) if (m := re.search(pat, block)) else None
        return dict(registers=num(r"Used (\d+) registers"), spill_stores=num(r"(\d+) bytes spill stores"),
                    spill_loads=num(r"(\d+) bytes spill loads"), smem=num(r"(\d+) bytes smem") or 0)
    return {}


# K5's rows through a warp's 768-byte buffer in shared memory, written out as 16-byte vectors
K5_STAGED = """__shared__ __align__(16) uint2 s_rows[kWarps][32 * 3];
uint2* srow = s_rows[warp];
uint4* dst = reinterpret_cast<uint4*>(out + pt.row * 12) + (u + h) * 48;
srow[3 * lane] = make_uint2(pack2(rx[h], ry[h]), pack2(rz[h], a0[h]));
srow[3 * lane + 1] = make_uint2(pack2(a1[h], a2[h]), pack2(rx[h], ry[h]));
srow[3 * lane + 2] = make_uint2(pack2(rz[h], c0[h]), pack2(c1[h], c2[h]));
__syncwarp();
dst[lane] = reinterpret_cast<const uint4*>(srow)[lane];
if (lane < 16) dst[32 + lane] = reinterpret_cast<const uint4*>(srow)[32 + lane];
__syncwarp();  // the buffer is rewritten by the next 32 slots
"""


# appended to each K5 build: the warps an SM holds of its kernel at N 2048 (the runtime's occupancy query at the
# launcher's shared memory; the first design's is the three planes)
K5_OCCUPANCY = """
extern "C" int unopose_k5_resident_warps(int n, int* warps) {
  const size_t smem = SMEM;
  cudaError_t err = cudaFuncSetAttribute(pe_channels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pe_channels_kernel, kThreads, smem);
  *warps = blocks * kThreads / 32;
  return (int)err;
}
"""


def with_occupancy(text: str) -> str:
    """A K5 source with ``unopose_k5_resident_warps`` appended."""
    smem = "smem_bytes(n)" if "size_t smem_bytes(int n)" in text else "(size_t)3 * n * sizeof(float)"
    return text + K5_OCCUPANCY.replace("SMEM", smem)


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


def channel_inputs(dev, rng, cloud: str, B2: int = 32, N: int = 2048, S2: int = 256) -> dict:
    """K5's arguments as ``pe_fused.pe_channels_cuda`` passes them: the plain twin's inputs on B2 clouds of N
    points grouped at budgets 64 / S2: ``cubes``, uniform in a 0.2 m cube in their global LRF, as chip_smoke.py
    makes them; ``surfaces`` (N 2048), the sphere surfaces that fill every 64-slot tier; ``cubes_total2_0``, the
    cubes with every seventh point's total2 set to 0. With the tier histogram."""
    from unopose_tpu_torch.configs import surface_clouds
    from unopose_tpu_torch.ops.ball_query import permutation, two_scale_group_first_k_packed_idx

    if cloud == "surfaces":
        perm, _ = permutation(N, "cpu")
        pts = torch.from_numpy(surface_clouds(rng, B2, perm.numpy())).to(dev)
    else:
        pts = rng.uniform(-0.1, 0.1, size=(B2, N, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
        pts = global_lrf(torch.from_numpy(pts).to(dev))
    planes, idx_p, w1, w2, total2, _ = two_scale_group_first_k_packed_idx(0.1, 64, 0.2, S2, pts)
    total2 = total2.to(torch.int32).contiguous()
    if cloud == "cubes_total2_0":
        total2[:, ::7] = 0
    hist = torch.bincount(pe_fused.chunks_needed(total2, S2).flatten(), minlength=5)[1:].tolist()
    args = (*(p.float().contiguous() for p in planes), idx_p.contiguous(),
            *(w.to(torch.bfloat16).contiguous() for w in (w1, w2)), total2,
            *(c.float().contiguous() for c in pts.unbind(-1)))
    return dict(args=args, B=B2, N=N, P=N, S2=S2, hist=hist)


# test_pe_train_odd_tiles' S at B 3 x P 37: odd counts of 16-slot m-tiles and ragged 64-slot tiles
ODD_S = (16, 48, 80, 112)


def train_inputs(dev, rng, S: int, odd: bool = False) -> dict:
    """K11-K14's and K18's arguments at B 8 x P 2048 x S as chip_smoke.py's phase 3 makes them
    (``configs.pe_train_chans``: a third of each point's slots distinct, the rest pads that tie;
    ``pe_train_weights`` at seed 0), or with ``odd`` at B 3 x P 37 x S as test_pe_train_odd_tiles makes them (each
    point's slots past S // 3 its first), with the plain passes' outputs, the references: the batch statistics
    (``bn``), the plain forward's max, the frozen variant's buffer (``fbn``, from seeded running statistics) and its
    plain max, and (``train_refs``; for ``odd`` once the shipped K12's max is known) the backward's."""
    from unopose_tpu_torch.configs import pe_train_chans, pe_train_weights
    from unopose_tpu_torch.ops import pe_train as pt

    B, P = (3, 37) if odd else (8, 2048)
    if odd:
        chans = torch.randn(B, 6, P, S, device=dev, generator=torch.Generator(device=dev).manual_seed(S)) * 0.3
        chans[..., S // 3:] = chans[..., :1]
        chans = chans.contiguous()
    else:
        chans = pe_train_chans(rng, dev, B, P, S)
    Ws, gammas, betas = pe_train_weights(dev, 0)
    gen = torch.Generator().manual_seed(19)
    means = [(0.1 * torch.randn(d, generator=gen)).to(dev) for d in pt.DIMS[1:]]
    vars_ = [(0.5 + torch.rand(d, generator=gen)).to(dev) for d in pt.DIMS[1:]]
    bn, gb = pt.stats_buffer(gammas, betas, dev)
    for depth in (1, 2, 3):
        pt.stats_plain(chans, Ws, gb, bn, depth, 1e-5)
    pooled, cnt = pt.fwd_plain(chans, Ws, bn)
    dpool = torch.from_numpy(rng.standard_normal((B, P, 128)).astype(np.float32)).to(dev)
    fbn = pt.frozen_buffer(gammas, betas, means, vars_, 1e-5, dev)
    fpooled, fcnt = pt.fwd_plain(chans, Ws, fbn)
    d = dict(B=B, P=P, S=S, chans=chans, ws=[W.float().contiguous() for W in Ws], gb=gb, bn=bn, fbn=fbn,
             dpool=dpool, fdpool=dpool, plain=dict(pooled=pooled, cnt=cnt, fpooled=fpooled, fcnt=fcnt))
    if not odd:
        train_refs(d)
    return d


def train_refs(d: dict) -> None:
    """The plain backward passes on d's cotangents (``dpool``, the frozen variant's ``fdpool``): the three layers'
    sums (``sums``, the buffer the backward passes read) and the dW, the frozen variant's sums and dW."""
    from unopose_tpu_torch.ops import pe_train as pt

    plain, ws = d["plain"], d["ws"]
    sums = d["bn"].clone()
    for layer in (3, 2, 1):
        pt.bwd_sums_plain(d["chans"], ws, sums, plain["pooled"], plain["cnt"], d["dpool"], layer)
    d["sums"] = sums
    plain["dws"] = pt.bwd_dw_plain(d["chans"], ws, sums, plain["pooled"], plain["cnt"], d["dpool"])
    plain["fsums"] = d["fbn"].clone()
    plain["fdws"] = pt.frozen_bwd_plain(d["chans"], ws, plain["fsums"], plain["fpooled"], plain["fcnt"], d["fdpool"])


def odd_cotangents(d: dict) -> None:
    """test_pe_train_odd_tiles' rule: each backward finds its max slots by an exact compare with its own forward's
    recompute, so at S 80 and 112 a point whose shipped K12 max moves from the plain forward's by more than 1e-5 of
    the largest (a bf16 rounding that can put the max on another slot) takes no cotangent on either side, and more
    than 2 such points raise; S 16 and 48 take the full cotangent. ``moved`` counts those points of each buffer."""
    d["moved"] = {}
    for key, out, ref in (("dpool", "k", "pooled"), ("fdpool", "kf", "fpooled")):
        got, want = d[out][0], d["plain"][ref]
        agree = ((got - want).abs() <= 1e-5 * want.abs().max()).all(dim=-1, keepdim=True)
        d["moved"][key] = int((~agree).sum())
        if d["S"] > 48:
            if d["moved"][key] > 2:
                raise RuntimeError(f"S {d['S']}: {d['moved'][key]} points' K12 max moved from the plain forward's")
            d[key] = d[key] * agree
    train_refs(d)


def rel_err(got, want) -> tuple:
    """(max, median) of |got - want| over the largest |want|."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().clamp_min(1e-30)
    return (d.max() / scale).item(), (d.median() / scale).item()


def train_check(kernel: str, key: str, outs, d: dict) -> dict:
    """A train kernel's outputs against the plain passes at chip_smoke.py's phase-3 gates: K11's mean and variance
    within 1e-4 of their max, the others' within 1e-2 of each tensor's max with the median under 1e-3 (K12 also
    its tie counts equal to the plain forward's)."""
    from unopose_tpu_torch.ops import pe_train as pt

    plain, depth = d["plain"], train_depth(kernel, key)
    if kernel == "K11":
        w = pt.DIMS[depth]
        errs = [rel_err(outs[0][row, :w], d["bn"][depth - 1, row, :w]) for row in (pt.MU, pt.VAR)]
        return dict(rel_plain=errs, within_gates=all(mx <= 1e-4 for mx, _ in errs))
    if kernel == "K12":
        errs = [rel_err(outs[0], plain["pooled"])]
        extra = dict(tie_counts_equal_plain=(outs[1] == plain["cnt"]).float().mean().item())
    elif kernel == "K13":
        w = pt.DIMS[depth]
        errs = [rel_err(outs[0][i, :w], d["sums"][depth - 1, row, :w]) for i, row in enumerate((pt.SG, pt.SGZ))]
        extra = {}
    elif kernel == "K14":
        errs = [rel_err(a, b) for a, b in zip(pt._split_dw(outs[0]), plain["dws"])]
        extra = {}
    else:
        errs = [rel_err(a, b) for a, b in zip(pt._split_dw(outs[0]), plain["fdws"])]
        errs += [rel_err(outs[1][l, i, :w], plain["fsums"][l, row, :w]) for l, w in enumerate(pt.DIMS[1:])
                 for i, row in enumerate((pt.SG, pt.SGZ))]
        extra = {}
    return dict(rel_plain=errs, within_gates=all(mx <= 1e-2 and med <= 1e-3 for mx, med in errs), **extra)


def gather_inputs(dev) -> dict:
    """K26's arguments: ``profile_compact_micro.script_inputs`` at seed 0 as (rows, ...) arrays, and those rows'
    first 1000 with every seventh bank index outside [0, 16) (16 and -1 in turns); each with the plain twin's
    output."""
    from unopose_tpu_torch.benchmarks import profile_compact_micro as cm

    d = {k: torch.from_numpy(v).to(dev) for k, v in cm.script_inputs(np.random.default_rng(0)).items()}
    x, li, bi = d["x"].view(-1, cm.C * cm.W), d["li"].view(-1, cm.K2), d["bi"].view(-1, cm.K2)
    bad = bi[:1000].clone()
    flat = bad.view(-1)
    flat[0::14], flat[7::14] = 16, -1
    cases = {f"{x.shape[0]} rows": (x, li, bi), "1000 rows, banks outside": (x[:1000], li[:1000], bad)}
    return {key: (*a, cm.compact_gather_plain(*a)) for key, a in cases.items()}


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
    srcs = {name: (kernel, with_occupancy(text) if kernel == "K5" else text) for name, (kernel, text) in srcs.items()}
    libs, logs = compile_all(srcs, build.BUILD_DIR / "variants")
    srcs = {name: v for name, v in srcs.items() if name in libs}
    stream = lambda: _P(torch.cuda.current_stream().cuda_stream)
    for name, lib in libs.items():
        entry = KERNELS[srcs[name][0]][1]
        getattr(lib, entry).argtypes = build._SIGNATURES[entry]
        if srcs[name][0] in TRAIN:
            lib.unopose_pe_train_fwd.argtypes = build._SIGNATURES["unopose_pe_train_fwd"]
            lib.unopose_pe_train_resident_warps.argtypes = [ctypes.c_int, ctypes.c_int, _P]
            if "_ties" in name:
                lib.unopose_pe_train_set_ties.argtypes = [_P]

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
    if "K5" in only:
        shapes["K5"] = {"32x2048 S2 256 cubes": channel_inputs(dev, rng, "cubes"),
                        "32x2048 S2 256 surfaces": channel_inputs(dev, rng, "surfaces"),
                        "32x2048 S2 256 cubes, total2 0": channel_inputs(dev, rng, "cubes_total2_0"),
                        "8x4096 S2 256 cubes": channel_inputs(dev, rng, "cubes", 8, 4096),
                        "32x2000 S2 128 cubes": channel_inputs(dev, rng, "cubes", 32, 2000, 128)}
    if "K26" in only:
        shapes["K26"] = gather_inputs(dev)
    if any(k in only for k in TRAIN):
        from unopose_tpu_torch.ops import pe_train as pt

        train = {S: train_inputs(dev, rng, S) for S in (256, 64)}
        odd = {S: train_inputs(dev, rng, S, odd=True) for S in ODD_S}
        # the kernel side's forward max and tie counts (each backward is fed its own side's): the shipped K12 on the
        # plain statistics and on the frozen buffer
        fwd = libs[SHIPPED[next(k for k in TRAIN if k in only)]].unopose_pe_train_fwd
        for d in (*train.values(), *odd.values()):
            for bn_key, out_key in (("bn", "k"), ("fbn", "kf")):
                pooled = torch.empty((d["B"], d["P"], 128), device=dev)
                cnt = torch.empty_like(pooled)
                if err := fwd(*(_P(x.data_ptr()) for x in (d["chans"], *d["ws"], d[bn_key], pooled, cnt)), d["B"],
                              d["P"], d["S"], stream()):
                    raise RuntimeError(f"the shipped pe_train_fwd failed to launch: cudaError_t {err}")
                d[out_key] = (pooled, cnt)
        for d in odd.values():
            odd_cotangents(d)
        runs = {f"{d['B']}x{d['P']}x{S}": d for S, d in (*train.items(), *odd.items())}
        shapes["K11"] = {f"{key} depth {depth}": d for key, d in runs.items() for depth in (1, 2, 3)}
        shapes["K12"] = dict(runs)
        shapes["K13"] = {f"{key} layer {layer}": d for key, d in runs.items() for layer in (3, 2, 1)}
        shapes["K14"] = dict(shapes["K12"])
        shapes["K18"] = dict(shapes["K12"])
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        cap = 4 * sms

    def run_case(name: str, key: str, grid_cap: int = 0):
        """(call, outputs) of one build at one shape; the call launches the kernel once (a train pass with scratch
        rows on at most ``grid_cap`` blocks, default ``cap``)."""
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
        elif kernel == "K5":
            d = shapes["K5"][key]
            out = torch.zeros((d["B"], d["P"], d["S2"], 12), dtype=torch.bfloat16, device=dev)
            ptrs = [_P(x.data_ptr()) for x in (*d["args"], out)]
            call = lambda: lib.unopose_pe_channels(*ptrs, d["B"], d["N"], d["P"], d["S2"], 0.1, 0.2, 1.0 / 0.1,
                                                   1.0 / 0.2, stream())
            outs = (out,)
        elif kernel == "K26":
            x, li, bi, _ = shapes["K26"][key]
            out = torch.zeros_like(li)
            ptrs = [_P(a.data_ptr()) for a in (x, li, bi, out)]
            call = lambda: lib.unopose_compact_gather(*ptrs, li.shape[0], stream())
            outs = (out,)
        elif kernel in TRAIN:
            d = shapes[kernel][key]
            B, P, S, depth = d["B"], d["P"], d["S"], train_depth(kernel, key)
            ptrs = lambda *xs: [_P(x.data_ptr()) for x in (d["chans"], *d["ws"], *xs)]
            if kernel == "K11":
                bn, partial = d["bn"].clone(), torch.empty(cap * 256, device=dev)
                call = lambda: lib.unopose_pe_train_stats(*ptrs(d["gb"], bn, partial), cap, B, P, S, depth, 1e-5,
                                                          stream())
                outs = (bn[depth - 1],)
            elif kernel == "K12":
                pooled = torch.empty((B, P, 128), device=dev)
                cnt = torch.empty_like(pooled)
                call = lambda: lib.unopose_pe_train_fwd(*ptrs(d["bn"], pooled, cnt), B, P, S, stream())
                outs = (pooled, cnt)
            elif kernel == "K13":
                bn, partial = d["sums"].clone(), torch.empty(cap * 256, device=dev)
                call = lambda: lib.unopose_pe_train_bwd_sums(*ptrs(bn, *d["k"], d["dpool"], partial), cap, B, P, S,
                                                             depth, stream())
                outs = (bn[depth - 1, pt.SG:pt.SGZ + 1],)
            else:  # K14, K18: the dW (K18 also every layer's sums)
                frozen = kernel == "K18"
                bn = (d["fbn"] if frozen else d["sums"]).clone()
                partial = torch.empty(cap * (pt.DW_SIZE + (pt.FROZEN_SUMS if frozen else 0)), device=dev)
                dw = torch.empty(pt.DW_SIZE, device=dev)
                entry = lib.unopose_pe_train_frozen_bwd if frozen else lib.unopose_pe_train_bwd_dw
                cot = d["fdpool" if frozen else "dpool"]
                call = lambda: entry(*ptrs(bn, *d["kf" if frozen else "k"], cot, partial), grid_cap or cap,
                                     _P(dw.data_ptr()), B, P, S, stream())
                outs = (dw, bn[:, pt.SG:pt.SGZ + 1]) if frozen else (dw,)
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
    ties_builds = [name for name in srcs if "_ties" in name]  # the train kernels' tie-count checks: not timed
    cases = [(name, key) for name in srcs if name not in ties_builds for key in shapes[srcs[name][0]]
             if not ((key.endswith("f32") or key.endswith("x40")) and name not in extra)]
    times = {c: [] for c in cases}
    heads = [x.reshape(B, N, H, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
    sdpa, gather = [], []
    if "K26" in only:
        x26, li26, bi26, _ = next(iter(shapes["K26"].values()))
        flat26 = (bi26 * 128 + li26).long()
    for order in (cases, cases[::-1], cases):
        if "K7" in only:
            sdpa.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads), args.reps))
        if "K26" in only:
            gather.append(cuda_ms(lambda: torch.gather(x26, 1, flat26), args.reps))
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
            if kernel == "K26":
                check["equal_plain"] = bool(torch.equal(outs[0], shapes["K26"][key][3]))
            if kernel == "K5":
                check["tiers"] = shapes["K5"][key]["hist"]
            if kernel in TRAIN:
                again = [o.clone() for o in outs]
                _, outs = run_case(name, key)
                torch.cuda.synchronize()
                check["deterministic"] = all(torch.equal(a, b) for a, b in zip(outs, again))
                check["max_abs_shipped"] = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, ref))
                check.update(train_check(kernel, key, outs, shapes[kernel][key]))
                if "moved" in shapes[kernel][key]:  # the odd shapes: the points whose K12 max moved
                    check["moved_points"] = shapes[kernel][key]["moved"]
                if kernel == "K14":
                    # the build's own spread: its dW on a grid capped at half the first design's blocks at this
                    # shape (a point a warp, 16 warps a block, one block an SM)
                    d = shapes[kernel][key]
                    _, half = run_case(name, key, grid_cap=max(1, min(-(-d["B"] * d["P"] // 16), sms) // 2))
                    torch.cuda.synchronize()
                    check["half_grid_max_abs"] = (half[0] - outs[0]).abs().max().item()
        if kernel in PTXAS_OF:
            check["ptxas"] = ptxas_record(logs[name], ptxas_fn(kernel, key, name))
            if kernel in TRAIN:
                warps = ctypes.c_int(0)
                if lib_err := libs[name].unopose_pe_train_resident_warps(int(kernel[1:]), train_depth(kernel, key),
                                                                         ctypes.byref(warps)):
                    raise RuntimeError(f"{name}: occupancy query failed: cudaError_t {lib_err}")
                check["resident_warps_per_sm"] = warps.value
            if kernel == "K5":
                warps = ctypes.c_int(0)
                if lib_err := libs[name].unopose_k5_resident_warps(2048, ctypes.byref(warps)):
                    raise RuntimeError(f"{name}: occupancy query failed: cudaError_t {lib_err}")
                check["resident_warps_per_sm"] = warps.value
        results.append(dict(build=name, kernel=kernel, shape=key, ms=float(np.median(times[(name, key)])),
                            **check))
    if "K7" in only:
        results.append(dict(build="scaled_dot_product_attention", kernel="K7", shape="32x261x768",
                            ms=float(np.median(sdpa))))
    if "K26" in only:
        results.append(dict(build="torch.gather", kernel="K26", shape=next(iter(shapes["K26"])),
                            ms=float(np.median(gather))))
    # the tie-count checks: per (point, channel), the slots whose recomputed y3 equals the forward's max against
    # K12's tie count, one launch a shape
    for name in ties_builds:
        kernel, lib = srcs[name][0], libs[name]
        for key, d in shapes[kernel].items():
            call, _ = run_case(name, key)
            ties = torch.zeros((d["B"], d["P"], 128), dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            lib.unopose_pe_train_set_ties(_P(ties.data_ptr()))
            err = call()
            torch.cuda.synchronize()
            lib.unopose_pe_train_set_ties(None)
            if err:
                raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
            cnt = d["kf" if kernel == "K18" else "k"][1]
            results.append(dict(build=name, kernel=kernel, shape=key, tie_mismatches=int((ties.float() != cnt).sum()),
                                ties_counted=int(ties.sum()), ties_forward=int(cnt.sum())))
    print(card)
    line = json.dumps({"card": card, "variants": results})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
