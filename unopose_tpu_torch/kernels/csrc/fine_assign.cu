// The fused fine soft assignment: three sweeps over the logits
// a = f1n f2n^T (bf16 operands, float32 accumulation) of each pair, rebuilt
// tile by tile on the tensor cores, so the (B, M1, M2) similarity matrix
// never exists in device memory.
//
//   K8 colstats: per column j, cm = max_i a_ij and cs = sum_i exp(a_ij - cm).
//   K9 labels:   per row i, rm = max_j a_ij and rs = sum_j exp(a_ij - rm)
//                (stored for K10), then pred = exp(a - rm) / rs *
//                exp(a - cm) / max(cs, 1e-30) * s1_i * s2_j, its first-
//                occurrence row argmax (label1) and column argmax (label2).
//   K10 accum:   per row i >= 1 with label1 > 0, the sums over the columns
//                j >= 1 with label2 > 0 of pred (the Procrustes weight) and
//                of pred * pts2[j - 1] (the numerator of the soft target).
//
// Replaces the TPU kernels unopose_tpu/ops/assignment_fused.py:
// _colstats_kernel (K8), _argmax_kernel (K9) and _accum_kernel (K10). The
// TPU walks the row tiles in order and carries the column statistics and
// the column argmax from one grid step to the next in its output block.
// Blocks on the card run in no order, so:
// - K8 takes one block per (pair, 64-column tile), the tile resident in
//   shared memory; the block loops over the 64-row tiles, and each row
//   group of 16 rows keeps the online max and sum-of-exp of its rows per
//   column in registers; the 4 row groups merge at the end (below).
// - K9 takes one block per (pair, 64-row tile) and sweeps the column tiles
//   twice: once for the row statistics, once for the labels. label1 is a
//   per-row reduction inside the block. label2 needs all row tiles: each
//   column's best (pred, row) is packed into one 64-bit key, the float bits
//   of pred >= 0 above M1 - 1 - row, reduced over each warp's rows by
//   shuffles, over the block's warps through per-warp slots and once per
//   column and block in device memory by atomicMax. The largest key is the
//   largest pred and, among equals, the smallest row, as the TPU's in-order
//   strict > gives; an all-zero column decodes to row 0.
// - K10 takes K9's block and ring for one sweep (below): a masked entry's
//   terms are selected away, so its sums are the parent loop's that skipped
//   them, bit for bit.
// K8 streams the row tiles of f1 past its resident column tile; K9 and K10
// hold their rows in registers and stream the column tiles of f2. In all
// three f1's rows are the A operand and f2's columns the B operand of the
// same sequence of mma.sync m16n8k16 k-steps, so their logits agree to the
// bit.
//
// Bound at the main shape (B = 16, M1 = M2 = 2049, C = 256): operations.
// One logit rebuild is 16 x 2049^2 x 256 x 2 = 34.4 GFLOP (34.8 us at 989
// TFLOP/s); K8 does one, K9 two, K10 one. The exponentials are 67 M per
// exponentiated matrix (1 in K8, 3 in K9, at most 2 in K10) at the 16 per
// clock per SM of the special function units: 48 us for K9's three, its
// bound. The operands are 33.6 MB. K9's time goes to the float32 work of
// its two sweeps (~15 and ~30 instructions per entry) and to streaming
// 2 ceil(M2 / 64) column tiles per block; its design overlaps the two.
// K10's one sweep is ~35 float32 instructions per entry of a live warp.

#include <cuda.h>  // CUtensorMap; its encoder is taken from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_div.cuh"

namespace {

constexpr int kTile = 64;      // rows and columns of a logit tile
constexpr int kMaxC = 256;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// ---------------------------------------------------------------- K9 labels
// One block per (pair, 16 kLabelWarps-row tile): kLabelWarps consumer warps
// of 16 rows, whose rows of f1 sit in registers as mma A fragments for the
// whole sweep, and one producer warp. The producer streams f2's 64-column
// tiles through a ring of kStages shared-memory slots (pass 1 and pass 2 as
// one sequence of 2 ceil(M2 / 64) tiles), each tile as c / 64 boxes that the
// copy engine loads through a tensor map, 128-byte swizzled so that the
// ldmatrix reads of B fragments are free of bank conflicts (32-byte boxes of
// 16 channels where 64 does not divide c), with each pass-2 tile's column
// scalars; a slot's full and empty mbarriers replace the block barrier, so
// each consumer warp runs on as soon as its next tile has landed and the
// warps' products, exponentials and loads overlap. The producer also
// reduces each pass-2 tile's column keys over the consumer warps and writes
// them to device memory once it finds the tile's slot released.
// Per row, pred's two quotients are fast_div.cuh's (IEEE's to the bit, from
// 1 / rs per row and 1 / cs per column) where M1, M2 < 4096, else the IEEE
// division.
constexpr int kLabelWarps = 4;
constexpr int kLabelThreads = 32 * (kLabelWarps + 1);
constexpr int kLabelBlocks = 2;  // blocks an SM: at most 168 registers a thread (3 warps of a quarter SM)
constexpr int kStages = 3;
constexpr int kMaxKs = kMaxC / 16;
// quotients of pred: the IEEE division, or fast_div.cuh's helpers (div_fast
// where every quotient's dividend is at least 2^-80, else div_exact)
enum Div { kIeee, kFast, kExact };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// one box of the (B, m2, c) tensor of f2 at (k0, row0, b) into shared memory by the copy engine (rows past m2
// zero-filled), counted on bar's transactions
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k0, int row0, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// bytes more of copies that this phase of bar waits for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
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

// The element offset of column n, channel k of a staged tile: the copy engine writes it as c / kKb boxes of
// 64 rows of kKb channels, each row's 16-byte chunks XOR-swizzled by the row (its 128-byte swizzle for
// kKb = 64, 32-byte for kKb = 16), so that the 8 rows an ldmatrix reads fall on 8 different bank groups.
template <int kKb>
__device__ __forceinline__ int tile_at(int n, int k) {
  const int q = (k % kKb) >> 3, x = kKb == 64 ? (n & 7) : ((n >> 2) & 1);
  return (k / kKb) * kTile * kKb + n * kKb + ((q ^ x) << 3) + (k & 7);
}

// B fragments of k-step ks for the n-tiles 2np and 2np + 1 (np = 0..3) of a staged column tile
template <int kKb>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4][4], const __nv_bfloat16* sB, int ks) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  // matrix i of an ldmatrix.x4: n-tile 2np + (i >> 1), k half i & 1
#pragma unroll
  for (int np = 0; np < 4; ++np)
    ldsm_x4(b[np], sB + tile_at<kKb>((2 * np + (i >> 1)) * 8 + (lane & 7), ks * 16 + (i & 1) * 8));
}

// the warp's logits against one staged column tile, the k-steps in ascending order; each k-step's B
// fragments are read while the previous one's products run
template <int kKb>
__device__ __forceinline__ void logits_reg(float (&acc)[8][4], const uint32_t (&a)[kMaxKs][4],
                                           const __nv_bfloat16* sB, int c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  uint32_t b[2][4][4];
  b_frags<kKb>(b[0], sB, 0);
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks) {
    if (ks * 16 >= c) break;
    if ((ks + 1) * 16 < c) b_frags<kKb>(b[(ks + 1) & 1], sB, ks + 1);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      mma_bf16(acc[2 * np], a[ks], b[ks & 1][np][0], b[ks & 1][np][1]);
      mma_bf16(acc[2 * np + 1], a[ks], b[ks & 1][np][2], b[ks & 1][np][3]);
    }
  }
}

template <int kDiv>
__device__ __forceinline__ float quot(float e, float l, float y) {
  if constexpr (kDiv == kIeee) return e / l;
  else if constexpr (kDiv == kFast) return div_fast(e, l, y);
  else return div_exact(e, l, y);
}

// pred of one entry, ((p_row * p_col) * s1) * s2 as the TPU kernel orders it, with the quotients of kDiv;
// yr, yc = 1 / rs, 1 / csj rounded to nearest
template <int kDiv>
__device__ __forceinline__ float pred_q(float x, float rm, float rs, float yr, float cmj, float csj, float yc,
                                        float s1, float s2) {
  const float p_row = quot<kDiv>(expf(x - rm), rs, yr);
  const float p_col = quot<kDiv>(expf(x - cmj), csj, yc);
  return p_row * p_col * s1 * s2;
}

// Pass 1 on one tile: the lane's online row max m_ and sum of exp l_ over its 16 columns in order, and the
// row's least logit lo. kFull: every column of the tile is below m2; else a column past m2 enters as kNeg to
// the max and -kNeg to the min, its term as 0: no change.
template <bool kFull>
__device__ __forceinline__ void row_stats(const float (&acc)[8][4], int c0, int m2, float (&m_)[2], float (&l_)[2],
                                          float (&lo)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float tm = kNeg;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = kFull || c0 + nt * 8 + 2 * t + e < m2;
        tm = fmaxf(tm, in ? acc[nt][2 * rr + e] : kNeg);
        lo[rr] = fminf(lo[rr], in ? acc[nt][2 * rr + e] : -kNeg);
      }
    }
    const float nm = fmaxf(m_[rr], tm);
    float ts = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = expf(acc[nt][2 * rr + e] - nm);
        ts = ts + (kFull || c0 + nt * 8 + 2 * t + e < m2 ? x : 0.0f);
      }
    }
    l_[rr] = l_[rr] * expf(m_[rr] - nm) + ts;
    m_[rr] = nm;
  }
}

// one round of the key reduce-scatter among the 8 lanes of a column group (lane bit off): a lane keeps the
// kHalf keys its bit selects and takes the max with its partner's
template <int kHalf>
__device__ __forceinline__ void key_round(unsigned long long (&key)[16], bool hi, int off) {
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const unsigned long long send = hi ? key[c] : key[c + kHalf];
    const unsigned long long keep = hi ? key[c + kHalf] : key[c];
    key[c] = umax64(keep, __shfl_xor_sync(kFull, send, off));
  }
}

// Pass 2 on one tile: pred, each row's first-occurrence best column, and each
// column's best key over the warp's 16 rows into its slot of sKey. Without a
// branch: a column past m2 has s2 = 0 and zero logits, so its pred is 0 (or
// NaN), which never beats a row's best, and its key is never read; a row past
// m1 keys as 0. rkey: m1 - 1 - row, or 0 past m1 (a lane's row g + 8 is past
// m1 wherever its row g is).
template <int kDiv>
__device__ __forceinline__ void labels_tile(const float (&acc)[8][4], const float4* sCol, unsigned long long* sKey,
                                            int c0, const unsigned (&rkey)[2], const bool (&valid)[2],
                                            const float (&m_)[2], const float (&l_)[2], const float (&yr)[2],
                                            const float (&s1v)[2], float (&best_v)[2], int (&best_j)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned long long key[16];  // column nt * 8 + 2t + e at 2 nt + e
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * t + e, j = c0 + col;
      const float4 cj = sCol[col];  // cm, cs, 1 / cs, s2
      float p[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        p[rr] = pred_q<kDiv>(acc[nt][2 * rr + e], m_[rr], l_[rr], yr[rr], cj.x, cj.y, cj.z, s1v[rr], cj.w);
        if (p[rr] > best_v[rr]) best_v[rr] = p[rr], best_j[rr] = j;
      }
      // the column's key over the lane's two rows: the second (later) row only where it is valid and larger
      const bool second = valid[1] && p[1] > p[0];
      const float pb = valid[0] ? (second ? p[1] : p[0]) : 0.0f;
      key[2 * nt + e] = ((unsigned long long)__float_as_uint(pb) << 32) | (second ? rkey[1] : rkey[0]);
    }
  }
  // the max over the warp's 16 rows: lane g ends with the keys 2 nt + e = c + 2 (g >> 2 & 1) + 4 (g >> 1 & 1)
  // + 8 (g & 1), c = 0, 1
  key_round<8>(key, g & 1, 4);
  key_round<4>(key, g & 2, 8);
  key_round<2>(key, g & 4, 16);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = c + 2 * ((g >> 2) & 1) + 4 * ((g >> 1) & 1) + 8 * (g & 1);
    sKey[(i >> 1) * 8 + 2 * t + (i & 1)] = key[c];
  }
}

template <bool kHelper, int kKb>
__global__ void __launch_bounds__(kLabelThreads, kLabelBlocks)
labels_kernel(const __nv_bfloat16* __restrict__ f1, const __grid_constant__ CUtensorMap f2_map,
              const float* __restrict__ cm, const float* __restrict__ cs, const float* __restrict__ s1,
              const float* __restrict__ s2, float* __restrict__ rm_out, float* __restrict__ rs_out,
              int* __restrict__ label1, unsigned long long* __restrict__ keys, int m1, int m2, int c) {
  extern __shared__ uint4 smem[];
  // [kStages][64 c] tiles at a 1024-byte boundary (the 128-byte swizzle's period)
  __nv_bfloat16* sRing = reinterpret_cast<__nv_bfloat16*>(smem) + ((1024 - smem_addr(smem) % 1024) % 1024) / 2;
  unsigned long long* sKey =  // [kStages][warp][64]
      reinterpret_cast<unsigned long long*>(sRing + kStages * kTile * c);
  uint64_t* full = reinterpret_cast<uint64_t*>(sKey + kStages * kLabelWarps * kTile);  // [kStages]
  uint64_t* empty = full + kStages;                                                    // [kStages]
  float4* sCol = reinterpret_cast<float4*>(full + 2 * kStages);  // [kStages][64] (cm, cs, 1 / cs, s2)
  float* sMax = reinterpret_cast<float*>(sCol + kStages * kTile);  // [kLabelWarps + 1]
  const int b = blockIdx.y, r0 = blockIdx.x * 16 * kLabelWarps;
  // the warp index as the compiler can see it is uniform in the warp (the shuffles need no divergence guard)
  const int warp = __shfl_sync(kFull, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = min(kLabelWarps, (m1 - r0 + 15) / 16);  // consumer warps with rows
  cm += (long long)b * m2;
  cs += (long long)b * m2;
  s2 += (long long)b * m2;
  keys += (long long)b * m2;
  const int tiles = (m2 + kTile - 1) / kTile, sweep = 2 * tiles;
  const int slot = kTile * c;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                // the producer's lanes, once the tile's copies have landed
      mbar_init(&empty[s], 32 * kLabelWarps);  // every consumer lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the largest column max, for the choice of division
  float cmx = kNeg;
  for (int j = threadIdx.x; j < m2; j += kLabelThreads) cmx = fmaxf(cmx, cm[j]);
  for (int off = 16; off > 0; off >>= 1) cmx = fmaxf(cmx, __shfl_xor_sync(kFull, cmx, off));
  if (lane == 0) sMax[warp] = cmx;
  __syncthreads();

  if (warp == kLabelWarps) {  // the producer
    float4 col[2];  // the column scalars of the next pass-2 tile, (cm, cs, 1 / cs, s2), read a tile ahead
    for (int u = 0; u < sweep + kStages; ++u) {
      const int s = u % kStages;
      if (u >= kStages) mbar_wait(&empty[s], (u / kStages - 1) & 1);  // tile u - kStages is consumed
      if (u < sweep && lane == 0) {
        mbar_expect(&full[s], kTile * c * 2);
        for (int k0 = 0; k0 < c; k0 += kKb)
          tma_load(sRing + s * slot + k0 * kTile, &f2_map, k0, (u % tiles) * kTile, b, &full[s]);
      }
      const int tp = u - kStages - tiles;  // the keys of tile u - kStages are final: reduce them over the warps
      for (int cl = lane; tp >= 0 && cl < kTile; cl += 32) {
        unsigned long long key = 0ull;
        for (int w = 0; w < warps; ++w) key = umax64(key, sKey[(s * kLabelWarps + w) * kTile + cl]);
        if (tp * kTile + cl < m2 && key) atomicMax(keys + tp * kTile + cl, key);
      }
      if (u >= sweep) continue;
      for (int h = 0; h < 2 && u >= tiles; ++h) sCol[s * kTile + lane + 32 * h] = col[h];
      const int cn = (u + 1 - tiles) * kTile;  // the next pass-2 tile's first column
      for (int h = 0; h < 2 && u + 1 >= tiles && u + 1 < sweep; ++h) {
        const int j = cn + lane + 32 * h;
        const float l = j < m2 ? fmaxf(cs[j], 1e-30f) : 1.0f;
        col[h] = make_float4(j < m2 ? cm[j] : 0.0f, l, __frcp_rn(l), j < m2 ? s2[j] : 0.0f);
      }
      mbar_arrive(&full[s]);
    }
  } else {  // a consumer: 16 rows
    const int wr = r0 + warp * 16;
    const bool live = wr < m1;
    const int row[2] = {wr + g, wr + g + 8};
    const bool valid[2] = {row[0] < m1, row[1] < m1};
    const unsigned rkey[2] = {valid[0] ? (unsigned)(m1 - 1 - row[0]) : 0u, valid[1] ? (unsigned)(m1 - 1 - row[1]) : 0u};
    // the warp's A fragments, zero past m1
    uint32_t a[kMaxKs][4];
    {
      const __nv_bfloat16* a0 = f1 + ((long long)b * m1 + row[0]) * c + 2 * t;
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks) {
        const bool in = ks * 16 < c;
        a[ks][0] = in && valid[0] ? ld32(a0 + ks * 16) : 0u;
        a[ks][1] = in && valid[1] ? ld32(a0 + 8 * c + ks * 16) : 0u;
        a[ks][2] = in && valid[0] ? ld32(a0 + ks * 16 + 8) : 0u;
        a[ks][3] = in && valid[1] ? ld32(a0 + 8 * c + ks * 16 + 8) : 0u;
      }
    }
    float m_[2] = {kNeg, kNeg}, l_[2] = {0.0f, 0.0f}, lo[2] = {-kNeg, -kNeg}, yr[2] = {0.0f, 0.0f};
    float s1v[2] = {0.0f, 0.0f}, best_v[2] = {-1.0f, -1.0f};
    int best_j[2] = {0, 0};
    bool fast = false;
    for (int u = 0; u < sweep; ++u) {
      const int s = u % kStages, tp = u - tiles;  // tp: the pass-2 tile
      mbar_wait(&full[s], (u / kStages) & 1);
      if (tp == 0) {  // pass 1 is done: merge the row statistics across the quad
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          for (int off = 1; off < 4; off <<= 1) {
            const float om = __shfl_xor_sync(kFull, m_[rr], off), ol = __shfl_xor_sync(kFull, l_[rr], off);
            const float nm = fmaxf(m_[rr], om);
            l_[rr] = l_[rr] * expf(m_[rr] - nm) + ol * expf(om - nm);
            m_[rr] = nm;
            lo[rr] = fminf(lo[rr], __shfl_xor_sync(kFull, lo[rr], off));
          }
          if (t == 0 && valid[rr]) {
            rm_out[(long long)b * m1 + row[rr]] = m_[rr];
            rs_out[(long long)b * m1 + row[rr]] = l_[rr];
          }
          s1v[rr] = valid[rr] ? s1[(long long)b * m1 + row[rr]] : 0.0f;
          yr[rr] = __frcp_rn(l_[rr]);
        }
        // expf(-55) > 2^-80: with no logit that far below its row's max or the largest column max, every
        // dividend of the warp's quotients is in div_fast's range
        float cmax = sMax[0];
        for (int w = 1; w <= kLabelWarps; ++w) cmax = fmaxf(cmax, sMax[w]);
        const float far = fmaxf(cmax, fmaxf(valid[0] ? m_[0] : kNeg, valid[1] ? m_[1] : kNeg));
        fast = __all_sync(kFull, fminf(valid[0] ? lo[0] : -kNeg, valid[1] ? lo[1] : -kNeg) - far >= -55.0f);
      }
      if (live) {
        float acc[8][4];
        logits_reg<kKb>(acc, a, sRing + s * slot, c);
        const int c0 = (u % tiles) * kTile;
        if (tp < 0) {  // pass 1: row max and sum of exp, online over the column tiles
          if (c0 + kTile <= m2) row_stats<true>(acc, c0, m2, m_, l_, lo);
          else row_stats<false>(acc, c0, m2, m_, l_, lo);
        } else {  // pass 2: pred, label1 (first-occurrence row argmax), label2 keys
          const float4* col = sCol + s * kTile;
          unsigned long long* key = sKey + (s * kLabelWarps + warp) * kTile;
          if constexpr (kHelper) {
            if (fast) labels_tile<kFast>(acc, col, key, c0, rkey, valid, m_, l_, yr, s1v, best_v, best_j);
            else labels_tile<kExact>(acc, col, key, c0, rkey, valid, m_, l_, yr, s1v, best_v, best_j);
          } else {
            labels_tile<kIeee>(acc, col, key, c0, rkey, valid, m_, l_, yr, s1v, best_v, best_j);
          }
        }
      }
      mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(kFull, best_v[rr], off);
        const int oj = __shfl_xor_sync(kFull, best_j[rr], off);
        if (ov > best_v[rr] || (ov == best_v[rr] && oj < best_j[rr])) best_v[rr] = ov, best_j[rr] = oj;
      }
      if (t == 0 && valid[rr]) label1[(long long)b * m1 + row[rr]] = best_j[rr];
    }
  }
}

// ---------------------------------------------------------------- K10 accum
// K9's block and ring in one pass of ceil(M2 / 64) column tiles: kLabelWarps
// consumer warps of 16 rows, their rows of f1 as A fragments in registers,
// and one producer warp that streams f2's column tiles through the kStages
// slots by the tensor map. The producer reads each tile's column scalars a
// tile ahead, the column mask folded in as the plain twin folds it (cm 0, cs
// 1, s2 0 and pts2 0 on a masked column, cs clamped at 1e-30 on a live one),
// skips a tile with no live column, and ends the sweep with a slot whose
// head says -1. Each consumer warp sums, per row, pred and pred * pts2 over
// its 16 columns of each tile in the order of the loop that skipped masked
// entries: a masked entry's pred is replaced by 0 with a select, never
// multiplied by 0 (its exponentials may be inf, and inf x 0 is NaN), and
// every sum starts at +0, so adding +0 (or -0) leaves its bits unchanged.
// A warp with no live row does no products and a block with none returns
// at once. Per tile, the warp takes fast_div.cuh's div_fast where no logit of
// its kept rows lies 55 below its row's max or the tile's largest live
// column max (every dividend of a live entry >= 2^-80), else div_exact; past
// M 4096 the IEEE division.
struct AccumHead {
  int c0;      // the tile's first column, -1 past the last live tile
  float cmax;  // the largest cm among its live columns
};

// column j's scalars as a consumer reads them: (cm, cs, 1 / cs, s2) and (x, y, z, 1) of pts2[j - 1], masked as
// the plain twin masks them; pts2 is the pair's (m2 - 1, 3) rows
__device__ __forceinline__ void accum_column(const float* __restrict__ cm, const float* __restrict__ cs,
                                             const float* __restrict__ s2, const int* __restrict__ label2,
                                             const float* __restrict__ pts2, int j, int m2, float4& col,
                                             float4& pt) {
  const bool on = j >= 1 && j < m2 && label2[j] > 0;
  const float l = on ? fmaxf(cs[j], 1e-30f) : 1.0f;
  col = make_float4(on ? cm[j] : 0.0f, l, __frcp_rn(l), on ? s2[j] : 0.0f);
  const float* p = pts2 + (on ? (long long)(j - 1) * 3 : 0);
  pt = on ? make_float4(p[0], p[1], p[2], 1.0f) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One tile's terms into the lane's sums, in the parent's order: n-tile, element, row.
template <int kDiv>
__device__ __forceinline__ void accum_tile(const float (&acc)[8][4], const float4* sCol, const float4* sPts,
                                           const bool (&keep)[2], const float (&rmv)[2], const float (&rsv)[2],
                                           const float (&yr)[2], const float (&s1v)[2], float (&w)[2],
                                           float (&nx)[2], float (&ny)[2], float (&nz)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * t + e;
      const float4 cj = sCol[col], pj = sPts[col];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float p = pred_q<kDiv>(acc[nt][2 * rr + e], rmv[rr], rsv[rr], yr[rr], cj.x, cj.y, cj.z, s1v[rr], cj.w);
        p = keep[rr] && pj.w != 0.0f ? p : 0.0f;
        w[rr] = w[rr] + p;
        nx[rr] = nx[rr] + p * pj.x;
        ny[rr] = ny[rr] + p * pj.y;
        nz[rr] = nz[rr] + p * pj.z;
      }
    }
  }
}

template <bool kHelper, int kKb>
__global__ void __launch_bounds__(kLabelThreads, kLabelBlocks)
accum_kernel(const __nv_bfloat16* __restrict__ f1, const __grid_constant__ CUtensorMap f2_map,
             const float* __restrict__ cm, const float* __restrict__ cs, const float* __restrict__ s1,
             const float* __restrict__ s2, const float* __restrict__ rm, const float* __restrict__ rs,
             const int* __restrict__ label1, const int* __restrict__ label2, const float* __restrict__ pts2,
             float* __restrict__ wsum, float* __restrict__ num, int m1, int m2, int c) {
  extern __shared__ uint4 smem[];
  // [kStages][64 c] tiles at a 1024-byte boundary (the 128-byte swizzle's period)
  __nv_bfloat16* sRing = reinterpret_cast<__nv_bfloat16*>(smem) + ((1024 - smem_addr(smem) % 1024) % 1024) / 2;
  float4* sCol = reinterpret_cast<float4*>(sRing + kStages * kTile * c);  // [kStages][64] (cm, cs, 1 / cs, s2)
  float4* sPts = sCol + kStages * kTile;                                  // [kStages][64] (x, y, z, live)
  AccumHead* sHead = reinterpret_cast<AccumHead*>(sPts + kStages * kTile);  // [kStages]
  uint64_t* full = reinterpret_cast<uint64_t*>(sHead + kStages);          // [kStages]
  uint64_t* empty = full + kStages;                                       // [kStages]
  const int b = blockIdx.y, r0 = blockIdx.x * 16 * kLabelWarps;
  // the warp index as the compiler can see it is uniform in the warp (the shuffles need no divergence guard)
  const int warp = __shfl_sync(kFull, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  bool keep[2];
  float rmv[2], rsv[2], s1v[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = (long long)b * m1 + row[rr];
    keep[rr] = warp < kLabelWarps && row[rr] >= 1 && row[rr] < m1 && label1[i] > 0;
    rmv[rr] = keep[rr] ? rm[i] : 0.0f;
    rsv[rr] = keep[rr] ? rs[i] : 1.0f;
    s1v[rr] = keep[rr] ? s1[i] : 0.0f;
  }
  const bool live = __any_sync(kFull, keep[0] || keep[1]);
  const int lives = __syncthreads_count(lane == 0 && live);  // consumer warps with a live row
  if (lives == 0) {
    const int r = r0 + threadIdx.x;
    if (threadIdx.x < 16 * kLabelWarps && r < m1) {
      wsum[(long long)b * m1 + r] = 0.0f;
      num[((long long)b * m1 + r) * 3] = num[((long long)b * m1 + r) * 3 + 1] =
          num[((long long)b * m1 + r) * 3 + 2] = 0.0f;
    }
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);             // the producer's lanes, once the tile's copies have landed
      mbar_init(&empty[s], 32 * lives);    // every lane of the live consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slot = kTile * c;

  if (warp == kLabelWarps) {  // the producer
    cm += (long long)b * m2;
    cs += (long long)b * m2;
    s2 += (long long)b * m2;
    label2 += (long long)b * m2;
    pts2 += (long long)b * (m2 - 1) * 3;
    const int tiles = (m2 + kTile - 1) / kTile;
    float4 col[2], pt[2];  // this tile's column scalars; the next tile's are read while it is issued
    for (int h = 0; h < 2; ++h) accum_column(cm, cs, s2, label2, pts2, lane + 32 * h, m2, col[h], pt[h]);
    int u = 0;  // slots filled
    for (int ti = 0; ti < tiles; ++ti) {
      float4 ncol[2], npt[2];
      for (int h = 0; h < 2; ++h) {
        ncol[h] = col[h], npt[h] = pt[h];
        if (ti + 1 < tiles) accum_column(cm, cs, s2, label2, pts2, (ti + 1) * kTile + lane + 32 * h, m2, ncol[h], npt[h]);
      }
      if (__any_sync(kFull, pt[0].w != 0.0f || pt[1].w != 0.0f)) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(&empty[s], (u / kStages - 1) & 1);  // tile u - kStages is consumed
        if (lane == 0) {
          mbar_expect(&full[s], kTile * c * 2);
          for (int k0 = 0; k0 < c; k0 += kKb) tma_load(sRing + s * slot + k0 * kTile, &f2_map, k0, ti * kTile, b, &full[s]);
        }
        float cmax = fmaxf(pt[0].w != 0.0f ? col[0].x : kNeg, pt[1].w != 0.0f ? col[1].x : kNeg);
        for (int off = 16; off > 0; off >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, off));
        for (int h = 0; h < 2; ++h) {
          sCol[s * kTile + lane + 32 * h] = col[h];
          sPts[s * kTile + lane + 32 * h] = pt[h];
        }
        if (lane == 0) sHead[s] = AccumHead{ti * kTile, cmax};
        mbar_arrive(&full[s]);
        ++u;
      }
      for (int h = 0; h < 2; ++h) col[h] = ncol[h], pt[h] = npt[h];
    }
    const int s = u % kStages;  // the end of the sweep
    if (u >= kStages) mbar_wait(&empty[s], (u / kStages - 1) & 1);
    if (lane == 0) sHead[s] = AccumHead{-1, 0.0f};
    mbar_arrive(&full[s]);
    return;
  }

  float w[2] = {0.0f, 0.0f}, nx[2] = {0.0f, 0.0f}, ny[2] = {0.0f, 0.0f}, nz[2] = {0.0f, 0.0f};
  if (live) {
    // the warp's A fragments, zero past m1
    uint32_t a[kMaxKs][4];
    {
      const bool valid[2] = {row[0] < m1, row[1] < m1};
      const __nv_bfloat16* a0 = f1 + ((long long)b * m1 + row[0]) * c + 2 * t;
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks) {
        const bool in = ks * 16 < c;
        a[ks][0] = in && valid[0] ? ld32(a0 + ks * 16) : 0u;
        a[ks][1] = in && valid[1] ? ld32(a0 + 8 * c + ks * 16) : 0u;
        a[ks][2] = in && valid[0] ? ld32(a0 + ks * 16 + 8) : 0u;
        a[ks][3] = in && valid[1] ? ld32(a0 + 8 * c + ks * 16 + 8) : 0u;
      }
    }
    const float yr[2] = {__frcp_rn(rsv[0]), __frcp_rn(rsv[1])};
    for (int u = 0;; ++u) {
      const int s = u % kStages;
      mbar_wait(&full[s], (u / kStages) & 1);
      const AccumHead head = sHead[s];
      if (head.c0 < 0) break;
      float acc[8][4];
      logits_reg<kKb>(acc, a, sRing + s * slot, c);
      const float4* col = sCol + s * kTile;
      const float4* pts = sPts + s * kTile;
      if constexpr (kHelper) {
        // the least logit of each kept row against its row max and the tile's largest live column max
        float lo = -kNeg;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float x = acc[0][2 * rr];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) x = fminf(x, fminf(acc[nt][2 * rr], acc[nt][2 * rr + 1]));
          lo = fminf(lo, keep[rr] ? x - fmaxf(rmv[rr], head.cmax) : -kNeg);
        }
        if (__all_sync(kFull, lo >= -55.0f)) accum_tile<kFast>(acc, col, pts, keep, rmv, rsv, yr, s1v, w, nx, ny, nz);
        else accum_tile<kExact>(acc, col, pts, keep, rmv, rsv, yr, s1v, w, nx, ny, nz);
      } else {
        accum_tile<kIeee>(acc, col, pts, keep, rmv, rsv, yr, s1v, w, nx, ny, nz);
      }
      mbar_arrive(&empty[s]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    for (int off = 1; off < 4; off <<= 1) {
      w[rr] = w[rr] + __shfl_xor_sync(kFull, w[rr], off);
      nx[rr] = nx[rr] + __shfl_xor_sync(kFull, nx[rr], off);
      ny[rr] = ny[rr] + __shfl_xor_sync(kFull, ny[rr], off);
      nz[rr] = nz[rr] + __shfl_xor_sync(kFull, nz[rr], off);
    }
    if (t == 0 && row[rr] < m1) {
      const long long i = (long long)b * m1 + row[rr];
      wsum[i] = w[rr];
      num[i * 3] = nx[rr];
      num[i * 3 + 1] = ny[rr];
      num[i * 3 + 2] = nz[rr];
    }
  }
}

// ---------------------------------------------------------------- K8 colstats
// One block per (pair, 64-column tile): kColWarps consumer warps and one
// producer warp. The producer has the copy engine load the block's column
// tile of f2 once (the resident B operand) and stream f1's 64-row tiles
// through a ring of kColStages slots by the tensor map of f1, each slot's
// full and empty mbarriers in place of a block barrier, so copies overlap
// the products. Two slots, so that two blocks fit an SM's shared memory
// (three 32 KB tiles each at C 256): 16 consumer warps an SM, which hide the
// epilogue's shuffle and exponential latencies better than a deeper ring
// with one block. A tile's rows fall in 4 row groups of 16 (rows 16 rg ..) and
// its columns in 8 n-tiles; a consumer warp takes a row group against kColNt
// n-tiles of every row tile, its A and B fragments read by ldmatrix. Per
// column and row tile, a row
// group's max and sum of exp over its 16 rows come from the same shuffle
// trees, merged online in row-tile order; the 4 row groups merge at the end
// in order. Each column's statistics are therefore those of one warp taking
// all 64 columns of each row group (the first design), bit for bit.
constexpr int kColNt = 4;                     // n-tiles a consumer warp takes
constexpr int kColWarps = 4 * (8 / kColNt);   // consumer warps: 4 row groups x 8 / kColNt column groups
constexpr int kColStages = 2;
constexpr int kColBlocks = 2;                 // blocks an SM
constexpr int kColThreads = 32 * (kColWarps + 1);

// A fragments of k-step ks for the 16 rows r0 .. r0 + 15 of a staged row tile
template <int kKb>
__device__ __forceinline__ void a_frags(uint32_t (&a)[4], const __nv_bfloat16* sA, int r0, int ks) {
  const int lane = threadIdx.x & 31, i = lane >> 3;  // matrix i: rows + 8 (i & 1), k half i >> 1
  ldsm_x4(a, sA + tile_at<kKb>(r0 + (lane & 7) + 8 * (i & 1), ks * 16 + 8 * (i >> 1)));
}

// B fragments of k-step ks for the n-tiles nt0 + 2np, + 1 of the resident column tile
template <int kKb>
__device__ __forceinline__ void b_frags_of(uint32_t (&b)[kColNt / 2][4], const __nv_bfloat16* sB, int nt0, int ks) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
#pragma unroll
  for (int np = 0; np < kColNt / 2; ++np)
    ldsm_x4(b[np], sB + tile_at<kKb>((nt0 + 2 * np + (i >> 1)) * 8 + (lane & 7), ks * 16 + (i & 1) * 8));
}

// rows r0 .. r0 + 15 of a staged row tile against the n-tiles nt0 .. of the resident column tile, the k-steps
// in ascending order; the next k-step's fragments are read while one's products run
template <int kKb>
__device__ __forceinline__ void logits_cols(float (&acc)[kColNt][4], const __nv_bfloat16* sA, int r0,
                                            const __nv_bfloat16* sB, int nt0, int c) {
#pragma unroll
  for (int nt = 0; nt < kColNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  uint32_t a[2][4], b[2][kColNt / 2][4];
  a_frags<kKb>(a[0], sA, r0, 0);
  b_frags_of<kKb>(b[0], sB, nt0, 0);
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks) {
    if (ks * 16 >= c) break;
    if ((ks + 1) * 16 < c) {
      a_frags<kKb>(a[(ks + 1) & 1], sA, r0, ks + 1);
      b_frags_of<kKb>(b[(ks + 1) & 1], sB, nt0, ks + 1);
    }
#pragma unroll
    for (int np = 0; np < kColNt / 2; ++np) {
      mma_bf16(acc[2 * np], a[ks & 1], b[ks & 1][np][0], b[ks & 1][np][1]);
      mma_bf16(acc[2 * np + 1], a[ks & 1], b[ks & 1][np][2], b[ks & 1][np][3]);
    }
  }
}

template <int kKb>
__global__ void __launch_bounds__(kColThreads, kColBlocks)
colstats_kernel(const __grid_constant__ CUtensorMap f1_map, const __grid_constant__ CUtensorMap f2_map,
                float* __restrict__ cm, float* __restrict__ cs, int m1, int m2, int c) {
  extern __shared__ uint4 smem[];
  // the resident column tile, then [kColStages] row tiles, each 64 c at a 1024-byte boundary
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem) + ((1024 - smem_addr(smem) % 1024) % 1024) / 2;
  __nv_bfloat16* sRing = sB + kTile * c;
  uint64_t* full = reinterpret_cast<uint64_t*>(sRing + kColStages * kTile * c);  // [kColStages]
  uint64_t* empty = full + kColStages;                                           // [kColStages]
  uint64_t* resident = empty + kColStages;
  float* sMax = reinterpret_cast<float*>(resident + 1);  // [4 row groups][64]
  float* sSum = sMax + 4 * kTile;
  const int b = blockIdx.y, c0 = blockIdx.x * kTile;
  // the warp index as the compiler can see it is uniform in the warp (the shuffles need no divergence guard)
  const int warp = __shfl_sync(kFull, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles = (m1 + kTile - 1) / kTile, slot = kTile * c;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kColStages; ++s) {
      mbar_init(&full[s], 1);                // the producer, once the tile's copies have landed
      mbar_init(&empty[s], 32 * kColWarps);  // every consumer lane
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kColWarps) {  // the producer
    if (lane == 0) {
      mbar_expect(resident, kTile * c * 2);
      for (int k0 = 0; k0 < c; k0 += kKb) tma_load(sB + k0 * kTile, &f2_map, k0, c0, b, resident);
      mbar_arrive(resident);
      for (int u = 0; u < tiles; ++u) {
        const int s = u % kColStages;
        if (u >= kColStages) mbar_wait(&empty[s], (u / kColStages - 1) & 1);  // tile u - kColStages is consumed
        mbar_expect(&full[s], kTile * c * 2);
        for (int k0 = 0; k0 < c; k0 += kKb) tma_load(sRing + s * slot + k0 * kTile, &f1_map, k0, u * kTile, b, &full[s]);
        mbar_arrive(&full[s]);
      }
    }
    __syncwarp();
  } else {  // a consumer: row group rg, n-tiles nt0 ..
    const int rg = warp % 4, nt0 = (warp / 4) * kColNt;
    float mx[kColNt][2], sm[kColNt][2];
#pragma unroll
    for (int nt = 0; nt < kColNt; ++nt) mx[nt][0] = mx[nt][1] = kNeg, sm[nt][0] = sm[nt][1] = 0.0f;
    mbar_wait(resident, 0);
    for (int u = 0; u < tiles; ++u) {
      const int s = u % kColStages, wr = u * kTile + rg * 16;
      mbar_wait(&full[s], (u / kColStages) & 1);
      float acc[kColNt][4];
      if (wr < m1) logits_cols<kKb>(acc, sRing + s * slot, rg * 16, sB, nt0, c);
      mbar_arrive(&empty[s]);
      if (wr >= m1) continue;
      const bool v0 = wr + g < m1, v1 = wr + g + 8 < m1;
      float nm[kColNt][2], ts[kColNt][2];
#pragma unroll
      for (int nt = 0; nt < kColNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x0 = v0 ? acc[nt][e] : kNeg, x1 = v1 ? acc[nt][2 + e] : kNeg;
          float tm = fmaxf(x0, x1);
          for (int off = 4; off < 32; off <<= 1) tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, off));
          nm[nt][e] = fmaxf(mx[nt][e], tm);
          float x = expf(x0 - nm[nt][e]);
          x = x + expf(x1 - nm[nt][e]);
          for (int off = 4; off < 32; off <<= 1) x = x + __shfl_xor_sync(kFull, x, off);
          ts[nt][e] = x;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kColNt; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sm[nt][e] = sm[nt][e] * expf(mx[nt][e] - nm[nt][e]) + ts[nt][e], mx[nt][e] = nm[nt][e];
    }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < kColNt; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sMax[rg * kTile + (nt0 + nt) * 8 + 2 * t + e] = mx[nt][e];
          sSum[rg * kTile + (nt0 + nt) * 8 + 2 * t + e] = sm[nt][e];
        }
    }
  }
  __syncthreads();
  const int j = c0 + threadIdx.x;
  if (threadIdx.x < kTile && j < m2) {
    float M = sMax[threadIdx.x];
    for (int w = 1; w < 4; ++w) M = fmaxf(M, sMax[w * kTile + threadIdx.x]);
    float S = 0.0f;
    for (int w = 0; w < 4; ++w) S = S + sSum[w * kTile + threadIdx.x] * expf(sMax[w * kTile + threadIdx.x] - M);
    cm[(long long)b * m2 + j] = M;
    cs[(long long)b * m2 + j] = S;
  }
}

// the driver's cuTensorMapEncodeTiled, found at run time (the library does not link the driver)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

bool bad_shape(int B, int m1, int m2, int c) {
  return B <= 0 || B > 65535 || m1 < 1 || m2 < 2 || c < 16 || c > kMaxC || c % 16 != 0;
}

// an operand as the copy engine reads it for K8-K10, (B, m, c) bf16 (f1 in K8, f2 in all three): boxes of 64
// rows and kb channels, 128-byte swizzle (kb 64) or 32-byte (kb 16)
cudaError_t operand_tensor_map(CUtensorMap* map, const void* x, int B, int m, int c, int kb) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)m, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)m * c * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kb, (cuuint32_t)kTile, 1u}, unit[3] = {1u, 1u, 1u};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, kb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// f1 (B, m1, c), f2 (B, m2, c) bf16 contiguous (16-byte aligned rows);
// cm, cs (B, m2) float32 out.
extern "C" int unopose_fine_colstats(const void* f1, const void* f2, float* cm, float* cs, int B, int m1, int m2,
                                     int c, cudaStream_t stream) {
  if (bad_shape(B, m1, m2, c)) return (int)cudaErrorInvalidValue;
  const int kb = c % 64 == 0 ? 64 : 16;
  CUtensorMap map1, map2;
  cudaError_t err = operand_tensor_map(&map1, f1, B, m1, c, kb);
  if (err == cudaSuccess) err = operand_tensor_map(&map2, f2, B, m2, c, kb);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 1024 + (size_t)(1 + kColStages) * kTile * c * sizeof(__nv_bfloat16) +
                      (2 * kColStages + 1) * sizeof(uint64_t) + 2 * 4 * kTile * sizeof(float);
  const auto kernel = kb == 64 ? colstats_kernel<64> : colstats_kernel<16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((m2 + kTile - 1) / kTile, B), kColThreads, smem, stream>>>(map1, map2, cm, cs, m1, m2, c);
  return (int)cudaGetLastError();
}

// s1 (B, m1), s2 (B, m2) float32 (a leading 1 for the bg row and column);
// rm, rs (B, m1) float32 and label1 (B, m1) int32 out; keys (B, m2) uint64
// zeroed by the caller, each (pred bits << 32 | m1 - 1 - row) of its column's
// best row.
extern "C" int unopose_fine_labels(const void* f1, const void* f2, const float* cm, const float* cs, const float* s1,
                                   const float* s2, float* rm, float* rs, int* label1, unsigned long long* keys, int B,
                                   int m1, int m2, int c, cudaStream_t stream) {
  if (bad_shape(B, m1, m2, c)) return (int)cudaErrorInvalidValue;
  const int kb = c % 64 == 0 ? 64 : 16;
  CUtensorMap map;
  cudaError_t err = operand_tensor_map(&map, f2, B, m2, c, kb);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 1024 + (size_t)kStages * kTile * c * sizeof(__nv_bfloat16) +
                      kStages * kLabelWarps * kTile * sizeof(unsigned long long) + 2 * kStages * sizeof(uint64_t) +
                      kStages * kTile * sizeof(float4) + (kLabelWarps + 1) * sizeof(float);
  // fast_div.cuh needs 1 <= l < 2^12: a row sum holds at most m2 terms of at most 1, a column sum m1
  const bool helper = m1 < 4096 && m2 < 4096;
  const auto kernel = helper ? (kb == 64 ? labels_kernel<true, 64> : labels_kernel<true, 16>)
                             : (kb == 64 ? labels_kernel<false, 64> : labels_kernel<false, 16>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * kLabelWarps;
  kernel<<<dim3((m1 + rows - 1) / rows, B), kLabelThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), map, cm, cs, s1, s2, rm, rs, label1, keys, m1, m2, c);
  return (int)cudaGetLastError();
}

// label1 (B, m1) and label2 (B, m2) int32 (label2: the row each key of
// unopose_fine_labels encodes); pts2 (B, m2 - 1, 3) float32; wsum (B, m1)
// and num (B, m1, 3) float32 out (row 0, the bg row, gets zeros).
extern "C" int unopose_fine_accum(const void* f1, const void* f2, const float* cm, const float* cs, const float* s1,
                                  const float* s2, const float* rm, const float* rs, const int* label1,
                                  const int* label2, const float* pts2, float* wsum, float* num, int B, int m1, int m2,
                                  int c, cudaStream_t stream) {
  if (bad_shape(B, m1, m2, c)) return (int)cudaErrorInvalidValue;
  const int kb = c % 64 == 0 ? 64 : 16;
  CUtensorMap map;
  cudaError_t err = operand_tensor_map(&map, f2, B, m2, c, kb);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 1024 + (size_t)kStages * kTile * c * sizeof(__nv_bfloat16) + 2 * kStages * kTile * sizeof(float4) +
                      kStages * sizeof(AccumHead) + 2 * kStages * sizeof(uint64_t);
  // fast_div.cuh needs 1 <= l < 2^12: a row sum holds at most m2 terms of at most 1, a column sum m1
  const bool helper = m1 < 4096 && m2 < 4096;
  const auto kernel = helper ? (kb == 64 ? accum_kernel<true, 64> : accum_kernel<true, 16>)
                             : (kb == 64 ? accum_kernel<false, 64> : accum_kernel<false, 16>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * kLabelWarps;
  kernel<<<dim3((m1 + rows - 1) / rows, B), kLabelThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), map, cm, cs, s1, s2, rm, rs, label1, label2, pts2, wsum, num, m1, m2, c);
  return (int)cudaGetLastError();
}
