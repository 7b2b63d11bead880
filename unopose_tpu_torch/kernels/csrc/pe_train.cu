// Fine-PE train stack: per cloud and scale, the shared MLP 6 -> 32 -> 64 ->
// 128 with batch-statistics BatchNorm (flax's: biased fast variance
// E[z^2] - E[z]^2 clipped at 0, eps 1e-5) and ReLU after each layer, then
// the max over each point's S slots, forward and backward. Five kernels,
// one template body:
//
//   K11 pe_train_stats (depth d = 1, 2, 3): recompute the chain to layer d
//       with the affines of the layers above, sum z and z^2 per channel;
//   K12 pe_train_fwd: the whole chain, the max over the slots and its tie
//       count per (point, channel);
//   K13 pe_train_bwd_sums (layer L = 3, 2, 1): recompute the chain, the
//       pool backward (ties split evenly) and the BN backward of the layers
//       below L, then sum g and g * zhat of layer L (its dbeta and dgamma);
//   K14 pe_train_bwd_dw: recompute everything, every layer's dz, and the
//       weight gradients dW_l = y_{l-1}^T dz_l;
//   K18 pe_train_frozen_bwd: the backward of the frozen-BN variant, whose BN
//       normalises with the running statistics (constants): one sweep that
//       recomputes the chain, takes the pool backward and, per layer, g =
//       dy relu', dz = a g (a = gamma / sigma, no batch-statistics terms),
//       the sums of g (dbeta) and g zhat (dgamma), and K14's dW; its
//       forward is K12 on an affine filled from the running statistics.
//
// Replaces the TPU kernels of unopose_tpu/ops/pe_train.py:
// pe_mlp_bn_pool_train (_kernel_stats, _kernel_fwd, _kernel_bwdA,
// _kernel_bwdB) and pe_mlp_bn_pool_frozen (_kernel_fwd,
// _kernel_bwd_frozen), with the same pass structure and rounding points: chans,
// W, the post-ReLU activations and dz are rounded to bf16 before each
// product, products accumulate in float32 (mma.sync m16n8k16), and the
// statistics, zhat and the affines are float32.
//
// What differs from the TPU kernels: no 128-lane padding of the widths (the
// first layer's K of 6 is padded to the mma's 16, nothing else), and no
// sequential grid carrying the sums. A persistent grid of blocks loops over
// the points; each warp owns one point at a time and runs its S slots 16 at
// a time through the three layers in registers (a layer's float32
// accumulator fragment, affine'd, ReLU'd and packed to bf16 pairs, is the
// next layer's A fragment, as in pe_mlp_pool.cu). Each block writes its
// partial sums to a scratch row, and a second kernel of the same launch
// adds the rows in block order (in double) and finishes the statistics, so
// a run is deterministic. The tie count that the pool backward needs is
// counted by the forward kernel (an online max with a count, merged across
// the row groups by shuffles) and read back by the backward kernels, whose
// recomputed y3 is bit for bit the forward's, so they need no extra pass
// over a point's slots. The weight gradients contract over the slots: K14's
// warps stage their 16-slot tiles of chans, y1, y2, dz1, dz2 and dz3 in
// shared memory transposed (feature rows, slot columns), and after a block
// barrier each warp multiplies its share of the dW tiles over the block's
// 128 staged slots, accumulating in registers for the whole run.
//
// Bound: operations. A chain is 10,432 MACs a slot: at B = 8, P = 2048,
// S = 256 (4.19 M slots) 87.5 GFLOP, 0.088 ms at 989 TFLOP/s; K11 at depth
// 1 and 2 is bound by reading the 100 MB of float32 chans (0.030 ms), K14
// does 62,208 FLOP a slot (0.26 ms). This first version uses mma.sync from
// registers without wgmma or TMA and reads chans in its (B, 6, P, S)
// float32 layout in every pass; the bf16 rounding, affine and gating of
// every element run on the CUDA cores beside the products.
//
// K18 is K14 plus the three layers' sums: per 16-slot tile and 8-channel
// n-tile, each lane adds its two rows, the warp's eight row groups are
// added by a fixed shuffle tree (a reduce-scatter over the row group's lane
// bits), and the result goes to the warp's row of sums in shared memory;
// the block adds its warps' rows in order, the second pass the blocks'.
// Its bound is K14's, 0.26 ms at the shapes above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum Mode { kStats = 0, kFwd = 1, kBwdSums = 2, kBwdDw = 3, kBwdFrozen = 4 };
// rows of the per-layer statistics buffer bn (3, kBnRows, 128), ops/pe_train.py
enum BnRow { kMu = 0, kVar = 1, kInv = 2, kA = 3, kB = 4, kSg = 5, kSgz = 6, kBnRows = 8 };
// bf16 weights in shared memory: forward (out, in) rows with layer 1's K padded 6 -> 16, backward
// (in, out) rows of W2 and W3; each row padded by 8 bf16 for conflict-free fragment loads
constexpr int kLdF0 = 16 + 8, kLdF1 = 32 + 8, kLdF2 = 64 + 8, kLdB1 = 64 + 8, kLdB2 = 128 + 8;
constexpr int kOffF1 = 32 * kLdF0;
constexpr int kOffF2 = kOffF1 + 64 * kLdF1;
constexpr int kOffB1 = kOffF2 + 128 * kLdF2;
constexpr int kOffB2 = kOffB1 + 32 * kLdB1;
constexpr int kWElems = kOffB2 + 64 * kLdB2;
// float constants per layer and channel: a, b, mu, inv, sum g / n, sum g zhat / n
enum CRow { cA = 0, cB = 1, cMu = 2, cInv = 3, cG = 4, cGz = 5, kCRows = 6 };
constexpr int kConsts = 3 * kCRows * 128;
// K14's staging: feature rows x (8 warps x 16 slots) bf16, transposed
constexpr int kLdS = kWarps * 16 + 8;
constexpr int kSChans = 0, kSY1 = 16, kSY2 = 48, kSD1 = 112, kSD2 = 144, kSD3 = 208, kSRows = 336;
constexpr int kDW = 6 * 32 + 32 * 64 + 64 * 128;
constexpr int kDW2 = 6 * 32, kDW3 = 6 * 32 + 32 * 64;  // offsets of dW2 and dW3 in a dW row
// K18's sums of g and g zhat per layer (32, 64, 128 channels), each layer's g then its g zhat
constexpr int kSums = 2 * (32 + 64 + 128);
__host__ __device__ constexpr int sums_base(int layer) { return layer == 1 ? 0 : layer == 2 ? 64 : 192; }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// a bf16 pair, low half = lower column
__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the ReLU gate of a packed post-ReLU activation (y > 0; -0 is not positive)
__device__ __forceinline__ bool pos_lo(uint32_t v) { return (v & 0x7fffu) != 0u; }
__device__ __forceinline__ bool pos_hi(uint32_t v) { return (v & 0x7fff0000u) != 0u; }

// write a packed A fragment's bf16 pairs transposed into the staging rows: feature f, f + 1 at slot s
__device__ __forceinline__ void put(uint16_t* st, int f, int s, uint32_t v) {
  st[f * kLdS + s] = (uint16_t)(v & 0xffffu);
  st[(f + 1) * kLdS + s] = (uint16_t)(v >> 16);
}

template <int kTiles>
__device__ __forceinline__ void stage(uint16_t* st, int row0, const uint32_t (&a)[kTiles][4], int col, int g, int t) {
#pragma unroll
  for (int kt = 0; kt < kTiles; ++kt) {
    put(st, row0 + kt * 16 + 2 * t, col + g, a[kt][0]);
    put(st, row0 + kt * 16 + 2 * t, col + g + 8, a[kt][1]);
    put(st, row0 + kt * 16 + 8 + 2 * t, col + g, a[kt][2]);
    put(st, row0 + kt * 16 + 8 + 2 * t, col + g + 8, a[kt][3]);
  }
}

// online max with a tie count
__device__ __forceinline__ void max_count(float& m, float& c, float v) {
  if (v > m) {
    m = v;
    c = 1.0f;
  } else if (v == m) {
    c += 1.0f;
  }
}

__host__ __device__ constexpr int width_of(int layer) { return layer == 1 ? 32 : layer == 2 ? 64 : 128; }

// K18: one n-tile's column sums of g and g zhat (columns col and col + 1, rows g and g + 8 of each lane),
// reduced over the warp's 8 row groups by a fixed tree (lane bits 4, 3, 2: each step keeps half the
// values and hands the other half to the partner), then added to the warp's sums in shared memory
__device__ __forceinline__ void frozen_col_sums(float* sums, int layer, int col, const float (&gv)[4],
                                                const float (&zh)[4], int lane) {
  const float v0 = gv[0] + gv[2], v1 = gv[1] + gv[3];
  const float v2 = gv[0] * zh[0] + gv[2] * zh[2], v3 = gv[1] * zh[1] + gv[3] * zh[3];
  const bool hi16 = (lane & 16) != 0, hi8 = (lane & 8) != 0;
  float k0 = hi16 ? v2 : v0, k1 = hi16 ? v3 : v1;
  k0 += __shfl_xor_sync(0xffffffffu, hi16 ? v0 : v2, 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi16 ? v1 : v3, 16);
  float k = hi8 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
  k += __shfl_xor_sync(0xffffffffu, k, 4);
  if ((lane & 4) == 0) sums[sums_base(layer) + (hi16 ? width_of(layer) : 0) + col + (hi8 ? 1 : 0)] += k;
}

template <int kMode, int kDepth>
__global__ void __launch_bounds__(kThreads)
pe_train_kernel(const float* __restrict__ chans, const float* __restrict__ w0, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ bn, const float* __restrict__ pooled_in,
                const float* __restrict__ cnt_in, const float* __restrict__ dpool, float* __restrict__ pooled_out,
                float* __restrict__ cnt_out, float* __restrict__ partial, int B, int P, int S) {
  // the layer whose per-channel sums K11 / K13 accumulate, and its n-tiles of 8 channels
  constexpr int kSumTiles = (kMode == kStats || kMode == kBwdSums) ? width_of(kDepth) / 8 : 1;
  constexpr bool kBackward = kMode == kBwdSums || kMode == kBwdDw || kMode == kBwdFrozen;
  constexpr bool kDw = kMode == kBwdDw || kMode == kBwdFrozen;  // the weight gradients, over staged tiles
  constexpr bool kFrozen = kMode == kBwdFrozen;
  constexpr int kLowest = kDw ? 0 : kDepth;  // the lowest layer the backward reaches

  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_c = reinterpret_cast<float*>(s_w + kWElems);
  float* s_pool = s_c + kConsts;           // per warp: the point's max (128), then (1 / count) * dpool (128)
  float* s_red = s_pool + kWarps * 256;    // per warp: two rows of 128 channel sums
  float* s_sums = s_red + kWarps * 256;    // K18, per warp: the three layers' sums of g and g zhat
  uint16_t* s_st = reinterpret_cast<uint16_t*>(s_sums + (kFrozen ? kWarps * kSums : 0));

  for (int i = threadIdx.x; i < 32 * kLdF0; i += kThreads) {
    const int o = i / kLdF0, k = i % kLdF0;
    s_w[i] = __float2bfloat16_rn(k < 6 ? w0[k * 32 + o] : 0.0f);
  }
  for (int i = threadIdx.x; i < 64 * kLdF1; i += kThreads) {
    const int o = i / kLdF1, k = i % kLdF1;
    s_w[kOffF1 + i] = __float2bfloat16_rn(k < 32 ? w1[k * 64 + o] : 0.0f);
  }
  for (int i = threadIdx.x; i < 128 * kLdF2; i += kThreads) {
    const int o = i / kLdF2, k = i % kLdF2;
    s_w[kOffF2 + i] = __float2bfloat16_rn(k < 64 ? w2[k * 128 + o] : 0.0f);
  }
  if (kBackward) {
    for (int i = threadIdx.x; i < 32 * kLdB1; i += kThreads) {
      const int r = i / kLdB1, o = i % kLdB1;
      s_w[kOffB1 + i] = __float2bfloat16_rn(o < 64 ? w1[r * 64 + o] : 0.0f);
    }
    for (int i = threadIdx.x; i < 64 * kLdB2; i += kThreads) {
      const int r = i / kLdB2, o = i % kLdB2;
      s_w[kOffB2 + i] = __float2bfloat16_rn(o < 128 ? w2[r * 128 + o] : 0.0f);
    }
  }
  const float inv_n = (float)(1.0 / ((double)B * (double)P * (double)S));
  for (int i = threadIdx.x; i < 3 * 128; i += kThreads) {
    const int l = i / 128, c = i % 128;
    const float* r = bn + l * kBnRows * 128 + c;
    float* d = s_c + l * kCRows * 128 + c;
    d[cA * 128] = r[kA * 128];
    d[cB * 128] = r[kB * 128];
    d[cMu * 128] = r[kMu * 128];
    d[cInv * 128] = r[kInv * 128];
    d[cG * 128] = r[kSg * 128] * inv_n;
    d[cGz * 128] = r[kSgz * 128] * inv_n;
  }
  if (kDw) {
    for (int i = threadIdx.x; i < kSRows * kLdS; i += kThreads) s_st[i] = 0;
  }
  if (kFrozen) {
    for (int i = threadIdx.x; i < kWarps * kSums; i += kThreads) s_sums[i] = 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group
  const long long points = (long long)B * P;
  const long long plane = (long long)P * S;  // one channel of one cloud
  const int mtiles = S >> 4;
  const float* C1 = s_c;
  const float* C2 = s_c + kCRows * 128;
  const float* C3 = s_c + 2 * kCRows * 128;
  float* pool = s_pool + warp * 256;
  float* sums = s_sums + warp * kSums;

  float sum1[kSumTiles][2], sum2[kSumTiles][2];  // K11: z, z^2; K13: g, g zhat
#pragma unroll
  for (int nt = 0; nt < kSumTiles; ++nt) sum1[nt][0] = sum1[nt][1] = sum2[nt][0] = sum2[nt][1] = 0.0f;
  float dw3[8][4], dw2[2][4], dw1[4];  // K14's share of the dW tiles
#pragma unroll
  for (int j = 0; j < 8; ++j) dw3[j][0] = dw3[j][1] = dw3[j][2] = dw3[j][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) dw2[j][0] = dw2[j][1] = dw2[j][2] = dw2[j][3] = 0.0f;
  dw1[0] = dw1[1] = dw1[2] = dw1[3] = 0.0f;

  for (long long base = (long long)blockIdx.x * kWarps; base < points; base += (long long)gridDim.x * kWarps) {
    const long long pt = base + warp;
    const bool active = pt < points;
    if (!kDw && !active) break;
    const long long b = active ? pt / P : 0, p = active ? pt % P : 0;
    const float* cb = chans + (b * 6 * P + p) * S;
    if (kBackward) {
      __syncwarp();
      if (active) {
        for (int c = lane; c < 128; c += 32) {
          pool[c] = pooled_in[pt * 128 + c];
          pool[128 + c] = (1.0f / cnt_in[pt * 128 + c]) * dpool[pt * 128 + c];
        }
      }
      __syncwarp();
    }
    float mx[16][2], ct[16][2];  // K12: running max and tie count per channel
    if (kMode == kFwd) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        mx[nt][0] = mx[nt][1] = __int_as_float(0xff800000);  // -inf
        ct[nt][0] = ct[nt][1] = 0.0f;
      }
    }

#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      uint32_t a1[4] = {0u, 0u, 0u, 0u};  // chans (bf16), K 6 padded to 16
      uint32_t a2[2][4], a3[4][4];         // y1, y2 (bf16)
      uint32_t d1[2][4], d2[4][4], d3[8][4];  // dz1, dz2, dz3 (bf16)
      if (kDw) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a2[i >> 1][i & 1] = a2[i >> 1][(i & 1) + 2] = d1[i >> 1][i & 1] = d1[i >> 1][(i & 1) + 2] = 0u;
          a3[i][0] = a3[i][1] = a3[i][2] = a3[i][3] = d2[i][0] = d2[i][1] = d2[i][2] = d2[i][3] = 0u;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) d3[i][0] = d3[i][1] = d3[i][2] = d3[i][3] = 0u;
      }
      if (active) {
        const int s0 = mt * 16;
        if (t < 3) {
          const float* c0 = cb + (2 * t) * plane + s0;
          const float* c1 = c0 + plane;
          a1[0] = pack(c0[g], c1[g]);
          a1[1] = pack(c0[g + 8], c1[g + 8]);
        }
        // layer 1: 6 -> 32
        float z1[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          z1[nt][0] = z1[nt][1] = z1[nt][2] = z1[nt][3] = 0.0f;
          const __nv_bfloat16* wr = s_w + (nt * 8 + g) * kLdF0 + 2 * t;
          mma_bf16(z1[nt], a1, ld32(wr), ld32(wr + 8));
        }
        if (kMode == kStats && kDepth == 1) {
#pragma unroll
          for (int nt = 0; nt < kSumTiles; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sum1[nt][j] += z1[nt][j] + z1[nt][j + 2];
              sum2[nt][j] += z1[nt][j] * z1[nt][j] + z1[nt][j + 2] * z1[nt][j + 2];
            }
          }
          continue;
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = nt * 8 + 2 * t;
          const float A0 = C1[cA * 128 + col], A1 = C1[cA * 128 + col + 1];
          const float B0 = C1[cB * 128 + col], B1 = C1[cB * 128 + col + 1];
          a2[nt >> 1][(nt & 1) * 2] = pack(fmaxf(A0 * z1[nt][0] + B0, 0.0f), fmaxf(A1 * z1[nt][1] + B1, 0.0f));
          a2[nt >> 1][(nt & 1) * 2 + 1] = pack(fmaxf(A0 * z1[nt][2] + B0, 0.0f), fmaxf(A1 * z1[nt][3] + B1, 0.0f));
        }
        // layer 2: 32 -> 64
        float z2[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          z2[nt][0] = z2[nt][1] = z2[nt][2] = z2[nt][3] = 0.0f;
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
            const __nv_bfloat16* wr = s_w + kOffF1 + (nt * 8 + g) * kLdF1 + kt * 16 + 2 * t;
            mma_bf16(z2[nt], a2[kt], ld32(wr), ld32(wr + 8));
          }
        }
        if (kMode == kStats && kDepth == 2) {
#pragma unroll
          for (int nt = 0; nt < kSumTiles; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sum1[nt][j] += z2[nt][j] + z2[nt][j + 2];
              sum2[nt][j] += z2[nt][j] * z2[nt][j] + z2[nt][j + 2] * z2[nt][j + 2];
            }
          }
          continue;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + 2 * t;
          const float A0 = C2[cA * 128 + col], A1 = C2[cA * 128 + col + 1];
          const float B0 = C2[cB * 128 + col], B1 = C2[cB * 128 + col + 1];
          a3[nt >> 1][(nt & 1) * 2] = pack(fmaxf(A0 * z2[nt][0] + B0, 0.0f), fmaxf(A1 * z2[nt][1] + B1, 0.0f));
          a3[nt >> 1][(nt & 1) * 2 + 1] = pack(fmaxf(A0 * z2[nt][2] + B0, 0.0f), fmaxf(A1 * z2[nt][3] + B1, 0.0f));
        }
        // layer 3: 64 -> 128, one n-tile of 8 channels at a time
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kt = 0; kt < 4; ++kt) {
            const __nv_bfloat16* wr = s_w + kOffF2 + (nt * 8 + g) * kLdF2 + kt * 16 + 2 * t;
            mma_bf16(z, a3[kt], ld32(wr), ld32(wr + 8));
          }
          if (kMode == kStats) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sum1[nt % kSumTiles][j] += z[j] + z[j + 2];
              sum2[nt % kSumTiles][j] += z[j] * z[j] + z[j + 2] * z[j + 2];
            }
            continue;
          }
          float dz[4], gvs[4], zhs[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = nt * 8 + 2 * t + (j & 1);
            const float pre = C3[cA * 128 + col] * z[j] + C3[cB * 128 + col];
            const float y = fmaxf(pre, 0.0f);
            if (kMode == kFwd) {
              max_count(mx[nt][j & 1], ct[nt][j & 1], y);
            } else {
              float gv = y == pool[col] ? pool[128 + col] : 0.0f;  // the pool backward, ties split evenly
              gv = pre > 0.0f ? gv : 0.0f;
              const float zh = (z[j] - C3[cMu * 128 + col]) * C3[cInv * 128 + col];
              if (kMode == kBwdSums && kDepth == 3) {
                sum1[nt % kSumTiles][j & 1] += gv;
                sum2[nt % kSumTiles][j & 1] += gv * zh;
              }
              gvs[j] = gv;
              zhs[j] = zh;
              dz[j] = kFrozen ? C3[cA * 128 + col] * gv
                              : C3[cA * 128 + col] * ((gv - C3[cG * 128 + col]) - zh * C3[cGz * 128 + col]);
            }
          }
          if (kFrozen) frozen_col_sums(sums, 3, nt * 8 + 2 * t, gvs, zhs, lane);
          if (kLowest < 3) {
            d3[nt >> 1][(nt & 1) * 2] = pack(dz[0], dz[1]);
            d3[nt >> 1][(nt & 1) * 2 + 1] = pack(dz[2], dz[3]);
          }
        }
        if (kLowest < 3) {
          // dy2 = dz3 W3^T, gated by y2 > 0
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            float dy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < 8; ++kt) {
              const __nv_bfloat16* wr = s_w + kOffB2 + (nt * 8 + g) * kLdB2 + kt * 16 + 2 * t;
              mma_bf16(dy, d3[kt], ld32(wr), ld32(wr + 8));
            }
            const uint32_t y_g = a3[nt >> 1][(nt & 1) * 2], y_g8 = a3[nt >> 1][(nt & 1) * 2 + 1];
            const bool on[4] = {pos_lo(y_g), pos_hi(y_g), pos_lo(y_g8), pos_hi(y_g8)};
            float dz[4], gvs[4], zhs[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = nt * 8 + 2 * t + (j & 1);
              const float gv = on[j] ? dy[j] : 0.0f;
              const float zh = (z2[nt][j] - C2[cMu * 128 + col]) * C2[cInv * 128 + col];
              if (kMode == kBwdSums && kDepth == 2) {
                sum1[nt % kSumTiles][j & 1] += gv;
                sum2[nt % kSumTiles][j & 1] += gv * zh;
              }
              gvs[j] = gv;
              zhs[j] = zh;
              dz[j] = kFrozen ? C2[cA * 128 + col] * gv
                              : C2[cA * 128 + col] * ((gv - C2[cG * 128 + col]) - zh * C2[cGz * 128 + col]);
            }
            if (kFrozen) frozen_col_sums(sums, 2, nt * 8 + 2 * t, gvs, zhs, lane);
            if (kLowest < 2) {
              d2[nt >> 1][(nt & 1) * 2] = pack(dz[0], dz[1]);
              d2[nt >> 1][(nt & 1) * 2 + 1] = pack(dz[2], dz[3]);
            }
          }
        }
        if (kLowest < 2) {
          // dy1 = dz2 W2^T, gated by y1 > 0
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float dy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < 4; ++kt) {
              const __nv_bfloat16* wr = s_w + kOffB1 + (nt * 8 + g) * kLdB1 + kt * 16 + 2 * t;
              mma_bf16(dy, d2[kt], ld32(wr), ld32(wr + 8));
            }
            const uint32_t y_g = a2[nt >> 1][(nt & 1) * 2], y_g8 = a2[nt >> 1][(nt & 1) * 2 + 1];
            const bool on[4] = {pos_lo(y_g), pos_hi(y_g), pos_lo(y_g8), pos_hi(y_g8)};
            float dz[4], gvs[4], zhs[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = nt * 8 + 2 * t + (j & 1);
              const float gv = on[j] ? dy[j] : 0.0f;
              const float zh = (z1[nt][j] - C1[cMu * 128 + col]) * C1[cInv * 128 + col];
              if (kMode == kBwdSums && kDepth == 1) {
                sum1[nt % kSumTiles][j & 1] += gv;
                sum2[nt % kSumTiles][j & 1] += gv * zh;
              }
              gvs[j] = gv;
              zhs[j] = zh;
              dz[j] = kFrozen ? C1[cA * 128 + col] * gv
                              : C1[cA * 128 + col] * ((gv - C1[cG * 128 + col]) - zh * C1[cGz * 128 + col]);
            }
            if (kFrozen) frozen_col_sums(sums, 1, nt * 8 + 2 * t, gvs, zhs, lane);
            if (kLowest < 1) {
              d1[nt >> 1][(nt & 1) * 2] = pack(dz[0], dz[1]);
              d1[nt >> 1][(nt & 1) * 2 + 1] = pack(dz[2], dz[3]);
            }
          }
        }
      }
      if (kDw) {
        // stage this warp's 16 slots, then every warp takes its dW tiles over the block's 128 slots
        const int col = warp * 16;
        put(s_st, kSChans + 2 * t, col + g, a1[0]);
        put(s_st, kSChans + 2 * t, col + g + 8, a1[1]);
        stage(s_st, kSY1, a2, col, g, t);
        stage(s_st, kSY2, a3, col, g, t);
        stage(s_st, kSD1, d1, col, g, t);
        stage(s_st, kSD2, d2, col, g, t);
        stage(s_st, kSD3, d3, col, g, t);
        __syncthreads();
        const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(s_st);
#pragma unroll
        for (int ks = 0; ks < kWarps; ++ks) {
          const int k0 = ks * 16 + 2 * t;
          {  // dW3 (64 x 128): row tile warp % 4, column tiles 8 (warp / 4) ..
            const __nv_bfloat16* ar = st + (kSY2 + (warp & 3) * 16 + g) * kLdS + k0;
            const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * kLdS), ld32(ar + 8), ld32(ar + 8 * kLdS + 8)};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const __nv_bfloat16* br = st + (kSD3 + ((warp >> 2) * 8 + j) * 8 + g) * kLdS + k0;
              mma_bf16(dw3[j], a, ld32(br), ld32(br + 8));
            }
          }
          {  // dW2 (32 x 64): row tile warp % 2, column tiles 2 (warp / 2) ..
            const __nv_bfloat16* ar = st + (kSY1 + (warp & 1) * 16 + g) * kLdS + k0;
            const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * kLdS), ld32(ar + 8), ld32(ar + 8 * kLdS + 8)};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const __nv_bfloat16* br = st + (kSD2 + ((warp >> 1) * 2 + j) * 8 + g) * kLdS + k0;
              mma_bf16(dw2[j], a, ld32(br), ld32(br + 8));
            }
          }
          if (warp < 4) {  // dW1 (6 x 32, rows padded to 16): column tile warp
            const __nv_bfloat16* ar = st + (kSChans + g) * kLdS + k0;
            const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * kLdS), ld32(ar + 8), ld32(ar + 8 * kLdS + 8)};
            const __nv_bfloat16* br = st + (kSD1 + warp * 8 + g) * kLdS + k0;
            mma_bf16(dw1, a, ld32(br), ld32(br + 8));
          }
        }
        __syncthreads();
      }
    }

    if (kMode == kFwd) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float m = mx[nt][j], c = ct[nt][j];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, m, off);
            const float oc = __shfl_xor_sync(0xffffffffu, c, off);
            if (om > m) {
              m = om;
              c = oc;
            } else if (om == m) {
              c += oc;
            }
          }
          if (g == 0) {
            pooled_out[pt * 128 + nt * 8 + 2 * t + j] = m;
            cnt_out[pt * 128 + nt * 8 + 2 * t + j] = c;
          }
        }
      }
    }
  }

  if (kMode == kStats || kMode == kBwdSums) {
    // per block: the row groups by shuffles, the warps in order through shared memory
    float* red = s_red + warp * 256;
#pragma unroll
    for (int nt = 0; nt < kSumTiles; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v1 = sum1[nt][j], v2 = sum2[nt][j];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          v1 += __shfl_xor_sync(0xffffffffu, v1, off);
          v2 += __shfl_xor_sync(0xffffffffu, v2, off);
        }
        if (g == 0) {
          red[nt * 8 + 2 * t + j] = v1;
          red[128 + nt * 8 + 2 * t + j] = v2;
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 256; c += kThreads) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += s_red[w * 256 + c];
      partial[(long long)blockIdx.x * 256 + c] = (c & 127) < kSumTiles * 8 ? v : 0.0f;
    }
  }
  if (kDw) {
    float* out = partial + (long long)blockIdx.x * (kFrozen ? kDW + kSums : kDW);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = (warp & 3) * 16 + g, c = ((warp >> 2) * 8 + j) * 8 + 2 * t;
      out[kDW3 + r * 128 + c] = dw3[j][0];
      out[kDW3 + r * 128 + c + 1] = dw3[j][1];
      out[kDW3 + (r + 8) * 128 + c] = dw3[j][2];
      out[kDW3 + (r + 8) * 128 + c + 1] = dw3[j][3];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (warp & 1) * 16 + g, c = ((warp >> 1) * 2 + j) * 8 + 2 * t;
      out[kDW2 + r * 64 + c] = dw2[j][0];
      out[kDW2 + r * 64 + c + 1] = dw2[j][1];
      out[kDW2 + (r + 8) * 64 + c] = dw2[j][2];
      out[kDW2 + (r + 8) * 64 + c + 1] = dw2[j][3];
    }
    if (warp < 4 && g < 6) {
      out[g * 32 + warp * 8 + 2 * t] = dw1[0];
      out[g * 32 + warp * 8 + 2 * t + 1] = dw1[1];
    }
    if (kFrozen) {  // the warps' sums, added in warp order, after the dW row
      __syncthreads();
      for (int c = threadIdx.x; c < kSums; c += kThreads) {
        float v = 0.0f;
        for (int w = 0; w < kWarps; ++w) v += s_sums[w * kSums + c];
        out[kDW + c] = v;
      }
    }
  }
}

// second pass of K11: add the blocks' rows in order, then flax's batch statistics and the affine
__global__ void stats_finish(const float* __restrict__ partial, int blocks, const float* __restrict__ gb,
                             float* __restrict__ bn, int width, float n, float eps) {
  const int c = threadIdx.x;
  if (c >= width) return;
  double s1 = 0.0, s2 = 0.0;
  for (int i = 0; i < blocks; ++i) {
    s1 += partial[(long long)i * 256 + c];
    s2 += partial[(long long)i * 256 + 128 + c];
  }
  const float sz = (float)s1, sz2 = (float)s2;
  const float mu = sz / n;
  const float var = fmaxf(sz2 / n - mu * mu, 0.0f);
  const float inv = 1.0f / sqrtf(var + eps);
  const float gam = gb[c], bet = gb[128 + c];
  bn[kMu * 128 + c] = mu;
  bn[kVar * 128 + c] = var;
  bn[kInv * 128 + c] = inv;
  bn[kA * 128 + c] = gam * inv;
  bn[kB * 128 + c] = bet - gam * mu * inv;
}

// second pass of K13: sum g (dbeta) and sum g zhat (dgamma) of the layer
__global__ void sums_finish(const float* __restrict__ partial, int blocks, float* __restrict__ bn, int width) {
  const int c = threadIdx.x;
  if (c >= width) return;
  double s1 = 0.0, s2 = 0.0;
  for (int i = 0; i < blocks; ++i) {
    s1 += partial[(long long)i * 256 + c];
    s2 += partial[(long long)i * 256 + 128 + c];
  }
  bn[kSg * 128 + c] = (float)s1;
  bn[kSgz * 128 + c] = (float)s2;
}

// second pass of K14: the three dW, in the (in, out) layout, one after the other
__global__ void dw_finish(const float* __restrict__ partial, int blocks, float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kDW) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * kDW + i];
  dw[i] = (float)s;
}

// second pass of K18: K14's dW, then each layer's sum g (dbeta) and sum g zhat (dgamma) into bn
__global__ void frozen_finish(const float* __restrict__ partial, int blocks, float* __restrict__ dw,
                              float* __restrict__ bn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kDW + kSums) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * (kDW + kSums) + i];
  if (i < kDW) {
    dw[i] = (float)s;
    return;
  }
  const int j = i - kDW;
  const int layer = j < sums_base(2) ? 1 : j < sums_base(3) ? 2 : 3;
  const int k = j - sums_base(layer), w = width_of(layer);
  bn[((layer - 1) * kBnRows + (k < w ? kSg : kSgz)) * 128 + k % w] = (float)s;
}

template <int kMode, int kDepth>
cudaError_t launch(const float* chans, const float* w0, const float* w1, const float* w2, const float* bn,
                   const float* pooled_in, const float* cnt_in, const float* dpool, float* pooled_out,
                   float* cnt_out, float* partial, int cap, int B, int P, int S, int* blocks_out,
                   cudaStream_t stream) {
  auto kernel = pe_train_kernel<kMode, kDepth>;
  const size_t smem = (size_t)kWElems * 2 + (size_t)(kConsts + 2 * kWarps * 256) * 4 +
                      (kMode == kBwdDw || kMode == kBwdFrozen ? (size_t)kSRows * kLdS * 2 : 0) +
                      (kMode == kBwdFrozen ? (size_t)kWarps * kSums * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long points = (long long)B * P;
  long long blocks = (points + kWarps - 1) / kWarps;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (cap > 0 && blocks > cap) blocks = cap;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(chans, w0, w1, w2, bn, pooled_in, cnt_in, dpool, pooled_out,
                                                        cnt_out, partial, B, P, S);
  *blocks_out = (int)blocks;
  return cudaGetLastError();
}

bool bad_shape(int B, int P, int S) { return B <= 0 || P <= 0 || S <= 0 || S % 16 != 0; }

}  // namespace

// K11. chans (B, 6, P, S) float32; w0 (6, 32), w1 (32, 64), w2 (64, 128) float32; gb (3, 2, 128) gammas
// and betas; bn (3, 8, 128): reads the affines of the layers above depth, writes mu, var, inv, a, b of
// layer depth; partial: cap x 256 floats of scratch.
extern "C" int unopose_pe_train_stats(const float* chans, const float* w0, const float* w1, const float* w2,
                                      const float* gb, float* bn, float* partial, int cap, int B, int P, int S,
                                      int depth, float eps, cudaStream_t stream) {
  if (bad_shape(B, P, S) || depth < 1 || depth > 3 || cap <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err;
  if (depth == 1) {
    err = launch<kStats, 1>(chans, w0, w1, w2, bn, nullptr, nullptr, nullptr, nullptr, nullptr, partial, cap, B, P, S,
                            &blocks, stream);
  } else if (depth == 2) {
    err = launch<kStats, 2>(chans, w0, w1, w2, bn, nullptr, nullptr, nullptr, nullptr, nullptr, partial, cap, B, P, S,
                            &blocks, stream);
  } else {
    err = launch<kStats, 3>(chans, w0, w1, w2, bn, nullptr, nullptr, nullptr, nullptr, nullptr, partial, cap, B, P, S,
                            &blocks, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int width = depth == 1 ? 32 : depth == 2 ? 64 : 128;
  stats_finish<<<1, 128, 0, stream>>>(partial, blocks, gb + (depth - 1) * 256, bn + (depth - 1) * kBnRows * 128,
                                      width, (float)((double)B * P * S), eps);
  return (int)cudaGetLastError();
}

// K12. pooled and cnt (B, P, 128) float32: the max over the slots of the last layer's ReLU output, and
// how many slots reach it.
extern "C" int unopose_pe_train_fwd(const float* chans, const float* w0, const float* w1, const float* w2,
                                    const float* bn, float* pooled, float* cnt, int B, int P, int S,
                                    cudaStream_t stream) {
  if (bad_shape(B, P, S)) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  return (int)launch<kFwd, 3>(chans, w0, w1, w2, bn, nullptr, nullptr, nullptr, pooled, cnt, nullptr, 0, B, P, S,
                              &blocks, stream);
}

// K13. dpool (B, P, 128) float32, the cotangent of pooled; bn: every layer's statistics and affine, and
// the sums of the layers below depth; writes sum g and sum g zhat of layer depth.
extern "C" int unopose_pe_train_bwd_sums(const float* chans, const float* w0, const float* w1, const float* w2,
                                         float* bn, const float* pooled, const float* cnt, const float* dpool,
                                         float* partial, int cap, int B, int P, int S, int depth,
                                         cudaStream_t stream) {
  if (bad_shape(B, P, S) || depth < 1 || depth > 3 || cap <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err;
  if (depth == 3) {
    err = launch<kBwdSums, 3>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B, P, S,
                              &blocks, stream);
  } else if (depth == 2) {
    err = launch<kBwdSums, 2>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B, P, S,
                              &blocks, stream);
  } else {
    err = launch<kBwdSums, 1>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B, P, S,
                              &blocks, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int width = depth == 1 ? 32 : depth == 2 ? 64 : 128;
  sums_finish<<<1, 128, 0, stream>>>(partial, blocks, bn + (depth - 1) * kBnRows * 128, width);
  return (int)cudaGetLastError();
}

// K14. dw: 6 * 32 + 32 * 64 + 64 * 128 floats, dW1, dW2, dW3 each (in, out) row-major; partial: cap x
// that many floats of scratch.
extern "C" int unopose_pe_train_bwd_dw(const float* chans, const float* w0, const float* w1, const float* w2,
                                       const float* bn, const float* pooled, const float* cnt, const float* dpool,
                                       float* partial, int cap, float* dw, int B, int P, int S, cudaStream_t stream) {
  if (bad_shape(B, P, S) || cap <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = launch<kBwdDw, 0>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B,
                                      P, S, &blocks, stream);
  if (err != cudaSuccess) return (int)err;
  dw_finish<<<(kDW + 255) / 256, 256, 0, stream>>>(partial, blocks, dw);
  return (int)cudaGetLastError();
}

// K18. The frozen-BN backward: bn holds every layer's mu, inv and affine (from the running statistics);
// writes dw as K14 does and each layer's sum g (row kSg) and sum g zhat (row kSgz) into bn; partial: cap x
// (dW floats + 448) floats of scratch.
extern "C" int unopose_pe_train_frozen_bwd(const float* chans, const float* w0, const float* w1, const float* w2,
                                           float* bn, const float* pooled, const float* cnt, const float* dpool,
                                           float* partial, int cap, float* dw, int B, int P, int S,
                                           cudaStream_t stream) {
  if (bad_shape(B, P, S) || cap <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = launch<kBwdFrozen, 0>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap,
                                          B, P, S, &blocks, stream);
  if (err != cudaSuccess) return (int)err;
  frozen_finish<<<(kDW + kSums + 255) / 256, 256, 0, stream>>>(partial, blocks, dw, bn);
  return (int)cudaGetLastError();
}
