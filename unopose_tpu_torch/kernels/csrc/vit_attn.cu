// Fused multi-head self-attention of the production ViT: per image and head,
// softmax(q k^T * hd^-0.5) v with float32 scores, the exact row max and sum
// over all keys, p / l rounded to v's dtype, a float32-accumulated P V, and
// the output in q's dtype. q, k and v are read in place from the (B, N, 3D)
// qkv output through their batch and row strides (heads packed along the
// features: columns h*hd .. h*hd+hd-1 of each are head h).
//
// Replaces the TPU kernel unopose_tpu/ops/vit_attn.py:_attn_kernel. The TPU
// runs one image per grid step with all heads' (261, 261) float32 scores in
// VMEM; here one head's (261, 261) float32 scores (272 KB) exceed the 227 KB
// of shared memory a block may use, so they live in registers, a warp's 16
// rows at a time.
//
// Bound at the main shape (B = 32, N = 261, D = 768, 12 heads): bytes. q, k,
// v and o move 51.3 MB (15.3 us at 3.35 TB/s); the products are 6.7 GFLOP
// (6.8 us at 989 TFLOP/s); the 2.2 M exponentials 0.5 us at the SFU rate.
// What holds this design above that is the softmax's float32 work on the
// CUDA cores, an exact expf and a correctly rounded division per score, and
// registers: a warp holds its tile's 136 scores within the 168 a thread that
// three blocks an SM leave. What the design does:
//  - one block per (image, head), 384 blocks at the main shape, stages the
//    head's K and V once (cp.async 16-byte copies; rows of hd 64 and 128
//    XOR-swizzled by 16-byte chunk, others padded by one chunk, so that the
//    ldmatrix reads are free of bank conflicts: 70 KB at hd 64, three blocks
//    an SM, one wave) and keeps them for all its rows; V stays key-major and
//    its B fragments come from ldmatrix.trans;
//  - its 4 warps walk 16-row query tiles (17 at N = 261), so a ragged end
//    costs one 16-row tile, not a block; the first tile's scores and
//    softmax run while V is still in flight;
//  - a warp computes its 16 x N scores once, on mma.sync m16n8k16 (bf16
//    operands, float32 accumulators), and holds them in registers; it takes
//    the row max, overwrites each score with expf(s - max) once, sums,
//    divides and packs to bf16 straight into the A fragments of O = P V.
//    Every tile runs all 17 16-key steps (N <= 272; the keys past N staged
//    as zeros and masked): with loop bounds known at compile time nothing
//    spills, where bounds of ceil(N / 16) spilled (3.3 times the time on
//    one H100, tools/kernel_variants.py);
//  - the division is IEEE's to the bit without its slow path (div_fast,
//    div_exact of fast_div.cuh), whose call alone took 1.6 times the time;
//  - a row too long for the registers (N > 272) recomputes the scores per
//    pass, once for the max, once for the sum, once for P, with V
//    transposed into shared memory as the first version kept it (K's rows
//    as here): no more bytes, so every N the first version took fits.
// tools/kernel_variants.py times the first version (a block per 64-row
// tile, the scores computed three times, each exponential twice) and the
// variants these choices replaced beside this kernel (PERF.md). No wgmma,
// TMA or clusters: at hd 64 and N 261 the tiles are too small for them to
// pay.
//
// float32 inputs (the tiny float32 configs) take a scalar variant with the
// same rounding points: one thread per query row, K and V in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fast_div.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 17;     // 16-key steps of a row whose scores a warp holds in registers: N <= 272
constexpr int kRows = 64;      // query rows per block of the float32 variant

// volatile, as the ldmatrix reads: the products and reads issue in program order, which sets how far
// ahead the fragments are read (without it the compiler hoists every read and runs out of registers)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, zero-filled when bytes is 0
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Row length of the staged K and V tiles in bf16, and the element offset of
// 16-byte chunk c of row r in them: the 8 rows an ldmatrix reads must fall
// on 8 different 16-byte bank groups. A row of a multiple of 8 chunks
// (hd 64, 128) keeps its length and XORs its chunks with the row's low 3
// bits; any other row is padded by one chunk.
template <int HD>
__host__ __device__ constexpr int kv_ld() {
  return HD % 64 == 0 ? HD : HD + 8;
}

template <int HD>
__device__ __forceinline__ int kv_at(int r, int c) {
  return HD % 64 == 0 ? r * HD + ((c ^ (r & 7)) << 3) : r * (HD + 8) + c * 8;
}

// Q's A fragments of this warp's 16 rows from row0 on (zero past n), read in place
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HD / 16][4], const __nv_bfloat16* q, int row0, int n,
                                       long long sn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = r0 < n ? ld32(q + r0 * sn + c) : 0u;
    qa[ks][1] = r1 < n ? ld32(q + r1 * sn + c) : 0u;
    qa[ks][2] = r0 < n ? ld32(q + r0 * sn + c + 8) : 0u;
    qa[ks][3] = r1 < n ? ld32(q + r1 * sn + c + 8) : 0u;
  }
}

// Scale two 8-key score tiles (2p and 2p+1) and set the keys past n to -inf:
// s[0], s[1] row g, keys 2t, 2t+1; s[2], s[3] row g+8. lo0, lo1 take the
// rows' least scaled score before the mask (0 for a key past n, whose K row
// is zero).
__device__ __forceinline__ void scale_mask(float (&sa)[4], float (&sb)[4], int p, int n, float scale, float& lo0,
                                           float& lo1) {
  const int key = p * 16 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sa[e] = sa[e] * scale;
    sb[e] = sb[e] * scale;
  }
  lo0 = fminf(lo0, fminf(fminf(sa[0], sa[1]), fminf(sb[0], sb[1])));
  lo1 = fminf(lo1, fminf(fminf(sa[2], sa[3]), fminf(sb[2], sb[3])));
  if (key >= n) sa[0] = sa[2] = -INFINITY;
  if (key + 1 >= n) sa[1] = sa[3] = -INFINITY;
  if (key + 8 >= n) sb[0] = sb[2] = -INFINITY;
  if (key + 9 >= n) sb[1] = sb[3] = -INFINITY;
}

// K's B fragments of one 16-dim step ks for tiles 2p and 2p+1, by ldmatrix from its staged rows
template <int HD>
__device__ __forceinline__ void k_frags(uint32_t (&b)[4], const __nv_bfloat16* sK, int p, int ks) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldsm_x4(b, sK + kv_at<HD>((2 * p + (i >> 1)) * 8 + (lane & 7), 2 * ks + (i & 1)));
}

// Scores of the warp's 16 rows against the keys of 8-key tiles 2p and 2p+1
// (the three-pass path), scaled and masked
template <int HD>
__device__ __forceinline__ void score_pair(float (&sa)[4], float (&sb)[4], const uint32_t (&qa)[HD / 16][4],
                                           const __nv_bfloat16* sK, int p, int n, float scale) {
  sa[0] = sa[1] = sa[2] = sa[3] = sb[0] = sb[1] = sb[2] = sb[3] = 0.0f;
  uint32_t b[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) k_frags<HD>(b[ks], sK, p, ks);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    mma_bf16(sa, qa[ks], b[ks][0], b[ks][1]);
    mma_bf16(sb, qa[ks], b[ks][2], b[ks][3]);
  }
  float lo0 = 0.0f, lo1 = 0.0f;
  scale_mask(sa, sb, p, n, scale, lo0, lo1);
}

__device__ __forceinline__ void quad_max(float& m0, float& m1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
}

__device__ __forceinline__ void quad_sum(float& l0, float& l1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 = l0 + __shfl_xor_sync(0xffffffffu, l0, off);
    l1 = l1 + __shfl_xor_sync(0xffffffffu, l1, off);
  }
}

// P = e / l of two score tiles, packed as the A fragment of one 16-key step
// of P V; y0, y1 = 1 / l0, 1 / l1. kExact: any e (div_exact), else e >= 2^-80.
template <bool kExact>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4], const float (&ea)[4], const float (&eb)[4], float l0,
                                       float l1, float y0, float y1) {
  auto div = [](float e, float l, float y) { return kExact ? div_exact(e, l, y) : div_fast(e, l, y); };
  pa[0] = pack_bf16(div(ea[0], l0, y0), div(ea[1], l0, y0));
  pa[1] = pack_bf16(div(ea[2], l1, y1), div(ea[3], l1, y1));
  pa[2] = pack_bf16(div(eb[0], l0, y0), div(eb[1], l0, y0));
  pa[3] = pack_bf16(div(eb[2], l1, y1), div(eb[3], l1, y1));
}

// V's B fragments of one 16-key step kk, by ldmatrix.trans from its key-major rows
template <int HD>
__device__ __forceinline__ void v_frags(uint32_t (&b)[HD / 16][4], const __nv_bfloat16* sV, int kk) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  const int row = kk * 16 + (i & 1) * 8 + (lane & 7);
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) ldsm_x4_trans(b[np], sV + kv_at<HD>(row, 2 * np + (i >> 1)));
}

// O += P V for one 16-key step from its V fragments
template <int HD>
__device__ __forceinline__ void pv_mma(float (&o)[HD / 8][4], const uint32_t (&pa)[4],
                                       const uint32_t (&b)[HD / 16][4]) {
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    mma_bf16(o[2 * np], pa, b[np][0], b[np][1]);
    mma_bf16(o[2 * np + 1], pa, b[np][2], b[np][3]);
  }
}

// The register path's softmax of one 16-row tile: every score computed once
// and held, P packed into pa. It runs all kSteps 16-key steps whatever n
// (K and V are staged zero-filled up to kSteps * 16 keys, whose scores past
// n are masked): bounds known at compile time keep the scores in registers,
// where a bound of ceil(n / 16) spilled them (3.3 times the time at N 261).
template <int HD>
__device__ __forceinline__ void tile_probs(uint32_t (&pa)[kSteps][4], const uint32_t (&qa)[HD / 16][4],
                                           const __nv_bfloat16* sK, int n, float scale) {
  float s[2 * kSteps][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
  for (int p = 0; p < kSteps; ++p) {
    uint32_t b[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) k_frags<HD>(b[ks], sK, p, ks);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      mma_bf16(s[2 * p], qa[ks], b[ks][0], b[ks][1]);
      mma_bf16(s[2 * p + 1], qa[ks], b[ks][2], b[ks][3]);
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY, lo0 = INFINITY, lo1 = INFINITY;
#pragma unroll
  for (int p = 0; p < kSteps; ++p) {
    scale_mask(s[2 * p], s[2 * p + 1], p, n, scale, lo0, lo1);
    m0 = fmaxf(m0, fmaxf(fmaxf(s[2 * p][0], s[2 * p][1]), fmaxf(s[2 * p + 1][0], s[2 * p + 1][1])));
    m1 = fmaxf(m1, fmaxf(fmaxf(s[2 * p][2], s[2 * p][3]), fmaxf(s[2 * p + 1][2], s[2 * p + 1][3])));
  }
  quad_max(m0, m1);
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt) {
    s[nt][0] = expf(s[nt][0] - m0);
    s[nt][1] = expf(s[nt][1] - m0);
    s[nt][2] = expf(s[nt][2] - m1);
    s[nt][3] = expf(s[nt][3] - m1);
    l0 = l0 + s[nt][0];
    l0 = l0 + s[nt][1];
    l1 = l1 + s[nt][2];
    l1 = l1 + s[nt][3];
  }
  quad_sum(l0, l1);
  const float y0 = 1.0f / l0, y1 = 1.0f / l1;
  // expf(-55) > 2^-80: a warp with no score that far below its row's max divides by div_fast alone
  if (__any_sync(0xffffffffu, m0 - lo0 > 55.0f || m1 - lo1 > 55.0f)) {
#pragma unroll
    for (int p = 0; p < kSteps; ++p) pack_p<true>(pa[p], s[2 * p], s[2 * p + 1], l0, l1, y0, y1);
  } else {
#pragma unroll
    for (int p = 0; p < kSteps; ++p) pack_p<false>(pa[p], s[2 * p], s[2 * p + 1], l0, l1, y0, y1);
  }
}

template <int HD>
__device__ __forceinline__ void store_o(float (&o)[HD / 8][4], __nv_bfloat16* out, int row0, int n,
                                        long long heads_d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    if (r0 < n) *reinterpret_cast<uint32_t*>(out + r0 * heads_d + nd * 8 + 2 * t) = pack_bf16(o[nd][0], o[nd][1]);
    if (r1 < n) *reinterpret_cast<uint32_t*>(out + r1 * heads_d + nd * 8 + 2 * t) = pack_bf16(o[nd][2], o[nd][3]);
  }
}

// O += P V for one 16-key step kk from V transposed in shared memory (the
// three-pass path's layout, [HD][npad + 8])
template <int HD>
__device__ __forceinline__ void pv_step_t(float (&o)[HD / 8][4], const uint32_t (&pa)[4], const __nv_bfloat16* sVt,
                                          int ldv, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* vr = sVt + g * ldv + kk * 16 + 2 * t;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) mma_bf16(o[nd], pa, ld32(vr + nd * 8 * ldv), ld32(vr + nd * 8 * ldv + 8));
}

// Shared memory of one block, in bf16: K in padded rows, and V in padded
// rows (kReg) or transposed with padded rows (the three-pass path, which
// thus takes every N the first version took)
template <int HD, bool kReg>
__host__ __device__ constexpr long long smem_elems(int npad) {
  return kReg ? 2LL * 16 * kSteps * kv_ld<HD>() : (long long)npad * kv_ld<HD>() + (long long)HD * (npad + 8);
}

// One block per (image, head): K and V staged once, 16-row tiles over the
// warps. kReg: the scores in registers (N <= 288), else three passes.
template <int HD, bool kReg>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 2)
mha_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int n, long long sb,
                long long sn, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kVec = HD / 8;  // 16-byte chunks a row
  const int npad = (n + 15) & ~15;
  const int rows = kReg ? 16 * kSteps : npad;  // staged keys, zero past n
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [rows][kv_ld]
  __nv_bfloat16* sV = sK + rows * kv_ld<HD>();                  // [rows][kv_ld], or V^T [HD][npad + 8]
  const int h = blockIdx.x, b = blockIdx.y;
  const long long base = b * sb + (long long)h * HD;
  const long long heads_d = gridDim.x * (long long)HD;  // D: the output is (B, N, D) contiguous
  __nv_bfloat16* orow = out + (long long)b * n * heads_d + (long long)h * HD;

  // K, then V, each its own group of 16-byte copies, the rows past n zero-filled
#pragma unroll 1
  for (int m = 0; m < (kReg ? 2 : 1); ++m) {
    const __nv_bfloat16* src = (m ? v : k) + base;
    __nv_bfloat16* dst = m ? sV : sK;
    for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
      const int key = i / kVec, c = (i % kVec) * 8;
      cp_async16(dst + kv_at<HD>(key, c / 8), src + (key < n ? key : 0) * sn + c, key < n ? 16 : 0);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int tiles = (n + 15) >> 4;  // 16-row query tiles, and 16-key steps
  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
  auto zero_o = [&]() {
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  };
  if constexpr (kReg) {
    auto values = [&](const uint32_t (&pa)[kSteps][4], int row0) {
      zero_o();
      uint32_t b[2][HD / 16][4];  // V's fragments read a step ahead of their products
      v_frags<HD>(b[0], sV, 0);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (kk + 1 < kSteps) v_frags<HD>(b[(kk + 1) & 1], sV, kk + 1);
        pv_mma<HD>(o, pa[kk], b[kk & 1]);
      }
      store_o<HD>(o, orow, row0, n, heads_d);
    };
    {  // the first tile's scores and softmax while V is in flight
      uint32_t pa[kSteps][4];
      if (warp < tiles) load_q<HD>(qa, q + base, warp * 16, n, sn);
      cp_async_wait<1>();
      __syncthreads();
      if (warp < tiles) tile_probs<HD>(pa, qa, sK, n, scale);
      cp_async_wait<0>();
      __syncthreads();
      if (warp < tiles) values(pa, warp * 16);
    }
#pragma unroll 1
    for (int tile = warp + kWarps; tile < tiles; tile += kWarps) {
      uint32_t pa[kSteps][4];
      load_q<HD>(qa, q + base, tile * 16, n, sn);
      tile_probs<HD>(pa, qa, sK, n, scale);
      values(pa, tile * 16);
    }
  } else {
    // V transposed by 2-byte stores while K is in flight
    const int ldv = npad + 8;
    for (int i = threadIdx.x; i < npad * kVec; i += kThreads) {
      const int key = i / kVec, c = (i % kVec) * 8;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < n) vv = *reinterpret_cast<const uint4*>(v + base + key * sn + c);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sV[(c + e) * ldv + key] = ve[e];
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int tile = warp; tile < tiles; tile += kWarps) {
      load_q<HD>(qa, q + base, tile * 16, n, sn);
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll 1
      for (int p = 0; p < tiles; ++p) {  // pass 1: the exact row max over all keys
        float sa[4], sc[4];
        score_pair<HD>(sa, sc, qa, sK, p, n, scale);
        m0 = fmaxf(m0, fmaxf(fmaxf(sa[0], sa[1]), fmaxf(sc[0], sc[1])));
        m1 = fmaxf(m1, fmaxf(fmaxf(sa[2], sa[3]), fmaxf(sc[2], sc[3])));
      }
      quad_max(m0, m1);
      float l0 = 0.0f, l1 = 0.0f;
#pragma unroll 1
      for (int p = 0; p < tiles; ++p) {  // pass 2: the row sum of exp(s - max), in the register path's order
        float sa[4], sc[4];
        score_pair<HD>(sa, sc, qa, sK, p, n, scale);
        l0 = l0 + expf(sa[0] - m0);
        l0 = l0 + expf(sa[1] - m0);
        l1 = l1 + expf(sa[2] - m1);
        l1 = l1 + expf(sa[3] - m1);
        l0 = l0 + expf(sc[0] - m0);
        l0 = l0 + expf(sc[1] - m0);
        l1 = l1 + expf(sc[2] - m1);
        l1 = l1 + expf(sc[3] - m1);
      }
      quad_sum(l0, l1);
      const float y0 = 1.0f / l0, y1 = 1.0f / l1;
      zero_o();
#pragma unroll 1
      for (int p = 0; p < tiles; ++p) {  // pass 3: P = exp(s - max) / sum in bf16, O = P V in float32
        float sa[4], sc[4];
        score_pair<HD>(sa, sc, qa, sK, p, n, scale);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sa[e] = expf(sa[e] - (e < 2 ? m0 : m1));
          sc[e] = expf(sc[e] - (e < 2 ? m0 : m1));
        }
        uint32_t pa[4];
        pack_p<true>(pa, sa, sc, l0, l1, y0, y1);
        pv_step_t<HD>(o, pa, sV, ldv, p);
      }
      store_o<HD>(o, orow, tile * 16, n, heads_d);
    }
  }
}

// float32 variant: one thread per query row, the same passes and rounding points.
template <int HD>
__global__ void __launch_bounds__(kRows)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               float* __restrict__ out, int n, long long sb, long long sn, float scale) {
  extern __shared__ float fsmem[];
  float* sK = fsmem;        // [n][HD]
  float* sV = fsmem + n * HD;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * kRows + threadIdx.x;
  const long long base = b * sb + (long long)h * HD;
  for (int i = threadIdx.x; i < n * HD; i += kRows) {
    const int key = i / HD, c = i % HD;
    sK[i] = k[base + key * sn + c];
    sV[i] = v[base + key * sn + c];
  }
  __syncthreads();
  if (r >= n) return;
  float qr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) qr[c] = q[base + r * sn + c];
  auto score = [&](int key) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc = acc + qr[c] * sK[key * HD + c];
    return acc * scale;
  };
  float m = -INFINITY;
  for (int key = 0; key < n; ++key) m = fmaxf(m, score(key));
  float l = 0.0f;
  for (int key = 0; key < n; ++key) l = l + expf(score(key) - m);
  float o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.0f;
  for (int key = 0; key < n; ++key) {
    const float p = expf(score(key) - m) / l;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = o[c] + p * sV[key * HD + c];
  }
  const long long heads_d = gridDim.y * (long long)HD;
  float* orow = out + (long long)b * n * heads_d + r * heads_d + (long long)h * HD;
#pragma unroll
  for (int c = 0; c < HD; ++c) orow[c] = o[c];
}

// An N whose K and V do not fit in one block's shared memory fails here, in
// cudaFuncSetAttribute; the runtime's last error is reset so that later
// launches do not report it.
int clear(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int n, int heads, long long sb,
           long long sn, int bf16, float scale, cudaStream_t stream) {
  cudaError_t err;
  if (bf16) {
    const int npad = (n + 15) & ~15;
    const bool reg = npad <= 16 * kSteps;
    const size_t smem = (reg ? smem_elems<HD, true>(npad) : smem_elems<HD, false>(npad)) * sizeof(__nv_bfloat16);
    const auto kernel = reg ? mha_bf16_kernel<HD, true> : mha_bf16_kernel<HD, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return clear(err);
    kernel<<<dim3(heads, B), kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), n, sb, sn, scale);
  } else {
    const dim3 grid((n + kRows - 1) / kRows, heads, B);
    const size_t smem = (size_t)2 * n * HD * sizeof(float);
    err = cudaFuncSetAttribute(mha_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return clear(err);
    mha_f32_kernel<HD><<<grid, kRows, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                      static_cast<const float*>(v), static_cast<float*>(out), n,
                                                      sb, sn, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, n, heads * hd) views sharing the batch and row strides sb, sn
// (in elements, unit feature stride); out: (B, n, heads * hd) contiguous.
// scale: hd^-0.5 as the caller rounds it to float32.
extern "C" int unopose_mha_fused(const void* q, const void* k, const void* v, void* out, int B, int n, int heads,
                                 int hd, long long sb, long long sn, int bf16, float scale, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || heads <= 0 || heads > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 32: return launch<32>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 48: return launch<48>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 64: return launch<64>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 80: return launch<80>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 96: return launch<96>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 112: return launch<112>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 128: return launch<128>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
