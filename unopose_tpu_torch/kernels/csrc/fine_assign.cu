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
// - K8 takes one block per (pair, 64-column tile); the block loops over the
//   64-row tiles and each warp keeps the online max and sum-of-exp of its
//   16 rows per column in registers; the 4 warps merge at the end.
// - K9 takes one block per (pair, 64-row tile) and sweeps the column tiles
//   twice: once for the row statistics, once for the labels. label1 is a
//   per-row reduction inside the block. label2 needs all row tiles: each
//   column's best (pred, row) is packed into one 64-bit key, the float bits
//   of pred >= 0 above M1 - 1 - row, and reduced with atomicMax (first in
//   shared memory per block, then once per column in device memory). The
//   largest key is the largest pred and, among equals, the smallest row, as
//   the TPU's in-order strict > gives; an all-zero column decodes to row 0.
// - K10 takes one block per (pair, 64-row tile) and skips the exponentials of
//   entries whose row or column mask is 0.
// Every logit tile is a 64 x 64 block: both operand tiles staged in shared
// memory (rows padded by 8 bf16, conflict-free fragment loads; 68 KB at
// C = 256), each warp 16 rows on mma.sync m16n8k16. K9 and K10 build the
// same tiles in the same order, so their logits agree to the bit.
//
// Bound at the main shape (B = 16, M1 = M2 = 2049, C = 256): operations.
// One logit rebuild is 16 x 2049^2 x 256 x 2 = 34.4 GFLOP (34.8 us at 989
// TFLOP/s); K8 does one, K9 two, K10 one. The exponentials (67 M per
// exponentiated matrix: 1 in K8, 3 in K9, at most 2 in K10) take less at the
// 16 per clock per SM of the special function units. The operands are 33.6
// MB. This first version uses mma.sync without wgmma, TMA or a pipeline, and
// stages each tile with a barrier on either side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps of 16 rows
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

// rows [r0, r0 + 64) of a (m, c) bf16 matrix into shared memory at row
// stride c + 8; rows past m are zero
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int m, int c) {
  const int vecs = c / 8;
  for (int i = threadIdx.x; i < kTile * vecs; i += kThreads) {
    const int r = i / vecs, col = (i % vecs) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < m) x = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * c + col);
    *reinterpret_cast<uint4*>(dst + r * (c + 8) + col) = x;
  }
}

// This warp's 16 rows (sA, already offset) against the 64 staged columns:
// acc[nt][0..1] row g, columns nt*8 + 2t, +1; acc[nt][2..3] row g + 8.
__device__ __forceinline__ void logits(float (&acc)[8][4], const __nv_bfloat16* sA, const __nv_bfloat16* sB,
                                       int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, ld = c + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const __nv_bfloat16* a0 = sA + g * ld + 2 * t;
  const __nv_bfloat16* b0 = sB + g * ld + 2 * t;
  for (int ks = 0; ks < c / 16; ++ks) {
    const uint32_t a[4] = {ld32(a0 + ks * 16), ld32(a0 + 8 * ld + ks * 16), ld32(a0 + ks * 16 + 8),
                           ld32(a0 + 8 * ld + ks * 16 + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* br = b0 + nt * 8 * ld + ks * 16;
      mma_bf16(acc[nt], a, ld32(br), ld32(br + 8));
    }
  }
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
colstats_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ f2, float* __restrict__ cm,
                float* __restrict__ cs, int m1, int m2, int c) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sA = sB + kTile * (c + 8);
  float* sMax = reinterpret_cast<float*>(sA + kTile * (c + 8));  // [4][64]
  float* sSum = sMax + 4 * kTile;
  const int b = blockIdx.y, c0 = blockIdx.x * kTile;
  const __nv_bfloat16* A = f1 + (long long)b * m1 * c;
  stage(sB, f2 + (long long)b * m2 * c, c0, m2, c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float mx[8][2], sm[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mx[nt][0] = mx[nt][1] = kNeg, sm[nt][0] = sm[nt][1] = 0.0f;

  for (int r0 = 0; r0 < m1; r0 += kTile) {
    __syncthreads();
    stage(sA, A, r0, m1, c);
    __syncthreads();
    const int wr = r0 + warp * 16;
    if (wr >= m1) continue;
    float acc[8][4];
    logits(acc, sA + warp * 16 * (c + 8), sB, c);
    const bool v0 = wr + g < m1, v1 = wr + g + 8 < m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x0 = v0 ? acc[nt][e] : kNeg, x1 = v1 ? acc[nt][2 + e] : kNeg;
        float tm = fmaxf(x0, x1);
        for (int off = 4; off < 32; off <<= 1) tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, off));
        const float nm = fmaxf(mx[nt][e], tm);
        float ts = expf(x0 - nm);
        ts = ts + expf(x1 - nm);
        for (int off = 4; off < 32; off <<= 1) ts = ts + __shfl_xor_sync(kFull, ts, off);
        sm[nt][e] = sm[nt][e] * expf(mx[nt][e] - nm) + ts;
        mx[nt][e] = nm;
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sMax[warp * kTile + nt * 8 + 2 * t + e] = mx[nt][e];
        sSum[warp * kTile + nt * 8 + 2 * t + e] = sm[nt][e];
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

// pred of one entry: ((p_row * p_col) * s1) * s2, as the TPU kernel orders it
__device__ __forceinline__ float pred_of(float x, float rm, float rs, float cmj, float csj, float s1, float s2) {
  const float p_row = expf(x - rm) / rs;
  const float p_col = expf(x - cmj) / csj;
  return p_row * p_col * s1 * s2;
}

__global__ void __launch_bounds__(kThreads)
labels_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ f2,
              const float* __restrict__ cm, const float* __restrict__ cs, const float* __restrict__ s1,
              const float* __restrict__ s2, float* __restrict__ rm_out, float* __restrict__ rs_out,
              int* __restrict__ label1, unsigned long long* __restrict__ keys, int m1, int m2, int c) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kTile * (c + 8);
  unsigned long long* sKey = reinterpret_cast<unsigned long long*>(sB + kTile * (c + 8));
  float* sCm = reinterpret_cast<float*>(sKey + kTile);
  float* sCs = sCm + kTile;
  float* sS2 = sCs + kTile;
  const int b = blockIdx.y, r0 = blockIdx.x * kTile;
  const __nv_bfloat16* Bm = f2 + (long long)b * m2 * c;
  stage(sA, f1 + (long long)b * m1 * c, r0, m1, c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = r0 + warp * 16;
  const bool live = wr < m1;
  const int row[2] = {wr + g, wr + g + 8};
  const bool valid[2] = {row[0] < m1, row[1] < m1};
  const __nv_bfloat16* sAw = sA + warp * 16 * (c + 8);

  // pass 1: row max and sum of exp, online over the column tiles
  float m_[2] = {kNeg, kNeg}, l_[2] = {0.0f, 0.0f};
  for (int c0 = 0; c0 < m2; c0 += kTile) {
    __syncthreads();
    stage(sB, Bm, c0, m2, c);
    __syncthreads();
    if (!live) continue;
    float acc[8][4];
    logits(acc, sAw, sB, c);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float tm = kNeg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = c0 + nt * 8 + 2 * t;
        if (j < m2) tm = fmaxf(tm, acc[nt][2 * rr]);
        if (j + 1 < m2) tm = fmaxf(tm, acc[nt][2 * rr + 1]);
      }
      const float nm = fmaxf(m_[rr], tm);
      float ts = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = c0 + nt * 8 + 2 * t;
        if (j < m2) ts = ts + expf(acc[nt][2 * rr] - nm);
        if (j + 1 < m2) ts = ts + expf(acc[nt][2 * rr + 1] - nm);
      }
      l_[rr] = l_[rr] * expf(m_[rr] - nm) + ts;
      m_[rr] = nm;
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(kFull, m_[rr], off), ol = __shfl_xor_sync(kFull, l_[rr], off);
      const float nm = fmaxf(m_[rr], om);
      l_[rr] = l_[rr] * expf(m_[rr] - nm) + ol * expf(om - nm);
      m_[rr] = nm;
    }
    if (t == 0 && valid[rr]) {
      rm_out[(long long)b * m1 + row[rr]] = m_[rr];
      rs_out[(long long)b * m1 + row[rr]] = l_[rr];
    }
  }

  // pass 2: pred, label1 (first-occurrence row argmax), label2 keys
  float s1v[2], best_v[2] = {-1.0f, -1.0f};
  int best_j[2] = {0, 0};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) s1v[rr] = valid[rr] ? s1[(long long)b * m1 + row[rr]] : 0.0f;
  for (int c0 = 0; c0 < m2; c0 += kTile) {
    __syncthreads();
    stage(sB, Bm, c0, m2, c);
    if (threadIdx.x < kTile) {
      const int j = c0 + threadIdx.x;
      const bool in = j < m2;
      sCm[threadIdx.x] = in ? cm[(long long)b * m2 + j] : 0.0f;
      sCs[threadIdx.x] = in ? fmaxf(cs[(long long)b * m2 + j], 1e-30f) : 1.0f;
      sS2[threadIdx.x] = in ? s2[(long long)b * m2 + j] : 0.0f;
      sKey[threadIdx.x] = 0ull;
    }
    __syncthreads();
    if (live) {
      float acc[8][4];
      logits(acc, sAw, sB, c);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e, j = c0 + col;
          unsigned long long key = 0ull;
          if (j < m2) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              if (!valid[rr]) continue;
              const float p = pred_of(acc[nt][2 * rr + e], m_[rr], l_[rr], sCm[col], sCs[col], s1v[rr], sS2[col]);
              if (p > best_v[rr]) best_v[rr] = p, best_j[rr] = j;
              key = umax64(key, ((unsigned long long)__float_as_uint(p) << 32) | (unsigned)(m1 - 1 - row[rr]));
            }
          }
          for (int off = 4; off < 32; off <<= 1) key = umax64(key, __shfl_xor_sync(kFull, key, off));
          if (g == 0 && j < m2) atomicMax(&sKey[col], key);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < kTile && c0 + threadIdx.x < m2)
      atomicMax(&keys[(long long)b * m2 + c0 + threadIdx.x], sKey[threadIdx.x]);
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

__global__ void __launch_bounds__(kThreads)
accum_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ f2,
             const float* __restrict__ cm, const float* __restrict__ cs, const float* __restrict__ s1,
             const float* __restrict__ s2, const float* __restrict__ rm, const float* __restrict__ rs,
             const int* __restrict__ label1, const int* __restrict__ label2, const float* __restrict__ pts2,
             float* __restrict__ wsum, float* __restrict__ num, int m1, int m2, int c) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kTile * (c + 8);
  float* sCol = reinterpret_cast<float*>(sB + kTile * (c + 8));  // cm, cs, s2, w2, x, y, z: [7][64]
  const int b = blockIdx.y, r0 = blockIdx.x * kTile;
  const __nv_bfloat16* Bm = f2 + (long long)b * m2 * c;
  stage(sA, f1 + (long long)b * m1 * c, r0, m1, c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  bool keep[2];
  float rmv[2], rsv[2], s1v[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = (long long)b * m1 + row[rr];
    keep[rr] = row[rr] >= 1 && row[rr] < m1 && label1[i] > 0;
    rmv[rr] = keep[rr] ? rm[i] : 0.0f;
    rsv[rr] = keep[rr] ? rs[i] : 1.0f;
    s1v[rr] = keep[rr] ? s1[i] : 0.0f;
  }
  const bool live = __any_sync(kFull, keep[0] || keep[1]);
  const __nv_bfloat16* sAw = sA + warp * 16 * (c + 8);
  float w[2] = {0.0f, 0.0f}, nx[2] = {0.0f, 0.0f}, ny[2] = {0.0f, 0.0f}, nz[2] = {0.0f, 0.0f};
  for (int c0 = 0; c0 < m2; c0 += kTile) {
    __syncthreads();
    stage(sB, Bm, c0, m2, c);
    if (threadIdx.x < kTile) {
      const int j = c0 + threadIdx.x;
      const long long jj = (long long)b * m2 + j;
      const bool w2 = j >= 1 && j < m2 && label2[jj] > 0;
      const long long p = w2 ? ((long long)b * (m2 - 1) + j - 1) * 3 : 0;  // pts2 row of column j
      sCol[threadIdx.x] = w2 ? cm[jj] : 0.0f;
      sCol[kTile + threadIdx.x] = w2 ? fmaxf(cs[jj], 1e-30f) : 1.0f;
      sCol[2 * kTile + threadIdx.x] = w2 ? s2[jj] : 0.0f;
      sCol[3 * kTile + threadIdx.x] = w2 ? 1.0f : 0.0f;
      sCol[4 * kTile + threadIdx.x] = w2 ? pts2[p] : 0.0f;
      sCol[5 * kTile + threadIdx.x] = w2 ? pts2[p + 1] : 0.0f;
      sCol[6 * kTile + threadIdx.x] = w2 ? pts2[p + 2] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    float acc[8][4];
    logits(acc, sAw, sB, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        if (sCol[3 * kTile + col] == 0.0f) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (!keep[rr]) continue;
          const float p = pred_of(acc[nt][2 * rr + e], rmv[rr], rsv[rr], sCol[col], sCol[kTile + col], s1v[rr],
                                  sCol[2 * kTile + col]);
          w[rr] = w[rr] + p;
          nx[rr] = nx[rr] + p * sCol[4 * kTile + col];
          ny[rr] = ny[rr] + p * sCol[5 * kTile + col];
          nz[rr] = nz[rr] + p * sCol[6 * kTile + col];
        }
      }
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

size_t tiles_smem(int c) { return (size_t)2 * kTile * (c + 8) * sizeof(__nv_bfloat16); }

bool bad_shape(int B, int m1, int m2, int c) {
  return B <= 0 || B > 65535 || m1 < 1 || m2 < 2 || c < 16 || c > kMaxC || c % 16 != 0;
}

}  // namespace

// f1 (B, m1, c), f2 (B, m2, c) bf16 contiguous (16-byte aligned rows);
// cm, cs (B, m2) float32 out.
extern "C" int unopose_fine_colstats(const void* f1, const void* f2, float* cm, float* cs, int B, int m1, int m2,
                                     int c, cudaStream_t stream) {
  if (bad_shape(B, m1, m2, c)) return (int)cudaErrorInvalidValue;
  const size_t smem = tiles_smem(c) + 2 * 4 * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(colstats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  colstats_kernel<<<dim3((m2 + kTile - 1) / kTile, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2), cm, cs, m1, m2, c);
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
  const size_t smem = tiles_smem(c) + kTile * sizeof(unsigned long long) + 3 * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  labels_kernel<<<dim3((m1 + kTile - 1) / kTile, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2), cm, cs, s1, s2, rm, rs, label1,
      keys, m1, m2, c);
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
  const size_t smem = tiles_smem(c) + 7 * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  accum_kernel<<<dim3((m1 + kTile - 1) / kTile, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2), cm, cs, s1, s2, rm, rs, label1,
      label2, pts2, wsum, num, m1, m2, c);
  return (int)cudaGetLastError();
}
