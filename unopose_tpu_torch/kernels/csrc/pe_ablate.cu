// The packed PE's fast path with parts of its work dropped (row 20): the
// timing ablation of benchmarks/profile_pe_ablate.py. Per point of a
// (B, P, S2) materialised grouping, only its first S2 / 2 slots: rel xyz,
// each scale's LRF weighted by its bf16 multiset weights (w1 at r1, w2 at
// r2), the 12 channels rounded to bf16, each scale's folded MLP 6 -> 32 ->
// 64 -> 128 (bf16 operands, float32 accumulation, bias, ReLU and a bf16 cast
// after each layer) and the max over the slots of the features multiplied by
// the 0/1 mask w > 0. Output (B, P, 256) float32, scale 1 then scale 2.
//
// Replaces the TPU kernel benchmarks/profile_pe_ablate.py:kernel (its
// pallas_call at :150), which takes a set of parts to drop; this kernel
// takes each of the seven sets its main() runs as a template flag, and
// repeats what the script computes then, its numbers deliberately wrong:
//  - lrf dropped: the frame channels are rel xyz at scale 1, 2 x rel xyz at
//    scale 2;
//  - stack dropped: all 12 channels of every slot are the rel x of the
//    first slot of the first point of the point's 64-point block (the
//    script's p_blk, which these two sets make part of the function);
//  - mlp dropped: every feature of a slot, both scales, is 0.5 x its bf16
//    rel-x channel;
//  - pool dropped: output row i of a 64-point block is the features of the
//    block's first point's slot i (no mask, no max);
//  - the pool multiplies by the mask and takes no -inf: a point with no
//    kept slot gives 0, and with the MLP dropped a masked slot gives 0
//    among negative features.
//
// Design: pe_packed.cu's (K19) fast path. One warp owns one point at a time
// (one 64-point block at a time where the pool is dropped: it computes the
// block's first point only); its lanes hold slots lane, lane + 32, ... in
// registers; the frames are pe_common.cuh's masked_lrf; each scale's kept
// slots are staged as bf16 rows in the warp's shared buffer and run through
// the MLP on mma.sync m16n8k16 tiles (staged_pool: a ReLU output is >= 0, so
// the max over the kept rows from 0 is the multiply-masked max); with the
// pool dropped the 64 rows go through the same layers (mlp_rows) and each
// row is stored. The TPU kernel's block-diagonal weights pad its matrix
// unit; their zero blocks add exact zeros, and here each scale runs its own
// MLP. A masked slot takes no MLP tile.
//
// Bound: operations for the full set, 2 x (6*32 + 32*64 + 64*128) = 20.9
// kFLOP of bf16 products a slot and scale on each point's S2 / 2 slots
// (tools/tpu_profile_bounds.py), against 16 bytes read a slot. This first
// version uses mma.sync from registers, without wgmma or TMA.

#include "pe_common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 64;           // the script's p_blk
constexpr int kPL = kPerLane / 2;    // slots a lane holds of the first S2 / 2 <= 128
constexpr int kDropLrf = 1, kDropStack = 2, kDropMlp = 4, kDropPool = 8;
constexpr int kStage = kPL * 32 * kRow > kBlock * 12 ? kPL * 32 * kRow : kBlock * 12;  // bf16 a warp

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The 12 channels of one point's first 32 * nu slots (ch[c][u]: rel xyz,
// frame 1, rel xyz, frame 2) and its weights m1 / m2, as the drop set makes
// them; blk0 is the first point of its 64-point block.
template <int DROP>
__device__ __forceinline__ void channels(const float* __restrict__ gx, const float* __restrict__ gy,
                                         const float* __restrict__ gz, const __nv_bfloat16* __restrict__ w1,
                                         const __nv_bfloat16* __restrict__ w2, const float* __restrict__ cx,
                                         const float* __restrict__ cy, const float* __restrict__ cz, long long pt,
                                         long long blk0, int s2, int nu, float r1, float r2, float inv_r1,
                                         float inv_r2, float (&ch)[12][kPL], float (&m1)[kPL], float (&m2)[kPL]) {
  const int lane = threadIdx.x & 31;
  const float px = cx[pt], py = cy[pt], pz = cz[pt];
  const long long row = pt * s2;
#pragma unroll
  for (int u = 0; u < kPL; ++u) {
    const bool in = u < nu;
    const long long s = row + u * 32 + lane;
    ch[0][u] = ch[6][u] = in ? gx[s] - px : 0.0f;
    ch[1][u] = ch[7][u] = in ? gy[s] - py : 0.0f;
    ch[2][u] = ch[8][u] = in ? gz[s] - pz : 0.0f;
    m1[u] = in ? __bfloat162float(w1[s]) : 0.0f;
    m2[u] = in ? __bfloat162float(w2[s]) : 0.0f;
  }
  if (DROP & kDropLrf) {
#pragma unroll
    for (int u = 0; u < kPL; ++u) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ch[3 + c][u] = ch[c][u];
        ch[9 + c][u] = ch[c][u] * 2.0f;
      }
    }
  } else {
    masked_lrf(ch[0], ch[1], ch[2], m1, nu, r1, inv_r1, ch[3], ch[4], ch[5]);
    masked_lrf(ch[0], ch[1], ch[2], m2, nu, r2, inv_r2, ch[9], ch[10], ch[11]);
  }
  if (DROP & kDropStack) {
    const float sv = gx[blk0 * s2] - cx[blk0];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
#pragma unroll
      for (int u = 0; u < kPL; ++u) ch[c][u] = sv;
    }
  }
}

// staged_pool's MLP on one 16-row tile, each row's 128 outputs (the ReLU
// output of the last layer rounded to bf16) stored to o0 (the lane's row
// mt * 16 + g) and o1 (that row + 8): mlp_tile's layers, no max.
__device__ __forceinline__ void mlp_rows(const uint32_t (&a1)[4], const __nv_bfloat16* W0, const float* B0,
                                         float* __restrict__ o0, float* __restrict__ o1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* W1 = W0 + kW0;
  const __nv_bfloat16* W2 = W1 + kW1;
  const float* B1 = B0 + 32;
  const float* B2 = B1 + 64;
  uint32_t a2[2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const __nv_bfloat16* wr = W0 + (nt * 8 + g) * kLd0 + 2 * t;
    mma_bf16(c, a1, ld32(wr), ld32(wr + 8));
    const int col = nt * 8 + 2 * t;
    a2[nt >> 1][(nt & 1) * 2] = relu_pack(c[0] + B0[col], c[1] + B0[col + 1]);
    a2[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[2] + B0[col], c[3] + B0[col + 1]);
  }
  uint32_t a3[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const __nv_bfloat16* wr = W1 + (nt * 8 + g) * kLd1 + kt * 16 + 2 * t;
      mma_bf16(c, a2[kt], ld32(wr), ld32(wr + 8));
    }
    const int col = nt * 8 + 2 * t;
    a3[nt >> 1][(nt & 1) * 2] = relu_pack(c[0] + B1[col], c[1] + B1[col + 1]);
    a3[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[2] + B1[col], c[3] + B1[col + 1]);
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const __nv_bfloat16* wr = W2 + (nt * 8 + g) * kLd2 + kt * 16 + 2 * t;
      mma_bf16(c, a3[kt], ld32(wr), ld32(wr + 8));
    }
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(o0 + col) = make_float2(relu_bf16(c[0] + B2[col]), relu_bf16(c[1] + B2[col + 1]));
    *reinterpret_cast<float2*>(o1 + col) = make_float2(relu_bf16(c[2] + B2[col]), relu_bf16(c[3] + B2[col + 1]));
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int DROP>
__global__ void __launch_bounds__(kThreads)
pe_ablate_kernel(const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
                 const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
                 const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
                 const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack, float* __restrict__ out,
                 long long points, int s2, float r1, float r2, float inv_r1, float inv_r2) {
  constexpr bool kMlp = !(DROP & kDropMlp);
  constexpr bool kPool = !(DROP & kDropPool);
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  __nv_bfloat16* s_stage = reinterpret_cast<__nv_bfloat16*>(s_b + 2 * kBScale);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nu = s2 / 64;  // slots per lane of the first S2 / 2
  __nv_bfloat16* stage = s_stage + warp * kStage;
  float ch[12][kPL], m1[kPL], m2[kPL];
  if (kPool) {
    for (long long pt = (long long)blockIdx.x * kWarps + warp; pt < points; pt += (long long)gridDim.x * kWarps) {
      channels<DROP>(gx, gy, gz, w1, w2, cx, cy, cz, pt, pt - pt % kBlock, s2, nu, r1, r2, inv_r1, inv_r2, ch, m1,
                     m2);
      if (kMlp) {
        bool k1[kPL], k2[kPL];
#pragma unroll
        for (int u = 0; u < kPL; ++u) {
          k1[u] = m1[u] > 0.0f;
          k2[u] = m2[u] > 0.0f;
        }
        staged_pool(ch[0], ch[1], ch[2], ch[3], ch[4], ch[5], k1, nu, s_w, s_b, stage, out + pt * 256);
        staged_pool(ch[6], ch[7], ch[8], ch[9], ch[10], ch[11], k2, nu, s_w + kWScale, s_b + kBScale, stage,
                    out + pt * 256 + 128);
      } else {  // every feature 0.5 x the bf16 rel-x channel, times the mask, maxed
        float f1 = -INFINITY, f2 = -INFINITY;
#pragma unroll
        for (int u = 0; u < kPL; ++u) {
          if (u < nu) {
            const float v = 0.5f * bf16_round(ch[0][u]);
            f1 = fmaxf(f1, m1[u] > 0.0f ? v : v * 0.0f);
            f2 = fmaxf(f2, m2[u] > 0.0f ? v : v * 0.0f);
          }
        }
        f1 = warp_max(f1);
        f2 = warp_max(f2);
        for (int c = lane; c < 256; c += 32) out[pt * 256 + c] = c < 128 ? f1 : f2;
      }
    }
    return;
  }
  // pool dropped: output row i of a block = the block's first point's slot i
  const long long blocks = points / kBlock;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (long long blk = (long long)blockIdx.x * kWarps + warp; blk < blocks; blk += (long long)gridDim.x * kWarps) {
    const long long p0 = blk * kBlock;
    channels<DROP>(gx, gy, gz, w1, w2, cx, cy, cz, p0, p0, s2, nu, r1, r2, inv_r1, inv_r2, ch, m1, m2);
    if (kMlp) {
#pragma unroll
      for (int u = 0; u < kBlock / 32; ++u) {  // slots 0..63 as rows of 12 bf16 channels
        uint2* o = reinterpret_cast<uint2*>(stage + (u * 32 + lane) * 12);
        o[0] = make_uint2(pack2(ch[0][u], ch[1][u]), pack2(ch[2][u], ch[3][u]));
        o[1] = make_uint2(pack2(ch[4][u], ch[5][u]), pack2(ch[6][u], ch[7][u]));
        o[2] = make_uint2(pack2(ch[8][u], ch[9][u]), pack2(ch[10][u], ch[11][u]));
      }
      __syncwarp();
#pragma unroll 1
      for (int sc = 0; sc < 2; ++sc) {
#pragma unroll 1
        for (int mt = 0; mt < kBlock / 16; ++mt) {
          const int r0 = mt * 16 + g, rr1 = r0 + 8;
          uint32_t a1[4] = {0u, 0u, 0u, 0u};
          if (t < 3) {
            a1[0] = ld32(stage + r0 * 12 + 6 * sc + 2 * t);
            a1[1] = ld32(stage + rr1 * 12 + 6 * sc + 2 * t);
          }
          mlp_rows(a1, s_w + sc * kWScale, s_b + sc * kBScale, out + (p0 + r0) * 256 + sc * 128,
                   out + (p0 + rr1) * 256 + sc * 128);
        }
      }
      __syncwarp();  // the buffer is rewritten by the next block
    } else {
#pragma unroll
      for (int u = 0; u < kBlock / 32; ++u) {
        const float v = 0.5f * bf16_round(ch[0][u]);
        for (int i = 0; i < 32; ++i) {
          const float vi = __shfl_sync(0xffffffffu, v, i);
          for (int c = lane; c < 256; c += 32) out[(p0 + u * 32 + i) * 256 + c] = vi;
        }
      }
    }
  }
}

template <int DROP>
int launch(const float* gx, const float* gy, const float* gz, const void* w1, const void* w2, const float* cx,
           const float* cy, const float* cz, const void* wpack, const float* bpack, float* out, long long points,
           int s2, float r1, float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      (size_t)kWarps * kStage * sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(pe_ablate_kernel<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_ablate_kernel<DROP>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (DROP & kDropPool) ? points / kBlock : points;  // warps' work items
  long long blocks = (units + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_ablate_kernel<DROP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      gx, gy, gz, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), cx, cy, cz,
      static_cast<const __nv_bfloat16*>(wpack), bpack, out, points, s2, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}

}  // namespace

// slot planes (B, P, S2) float32, multiset weights (B, P, S2) bf16, centres
// (B, P) float32; wpack / bpack: both scales' weights as
// ops/pe_fused.py:pack_mlp lays them out. S2 in {128, 192, 256}, P a
// multiple of 64; drop: the set's bits (1 lrf, 2 stack, 4 mlp, 8 pool), one
// of the seven sets of the script (0, 1, 2, 4, 8, 15, 11).
extern "C" int unopose_pe_ablate(const float* gx, const float* gy, const float* gz, const void* w1, const void* w2,
                                 const float* cx, const float* cy, const float* cz, const void* wpack,
                                 const float* bpack, float* out, int batch, int np, int s2, int drop, float r1,
                                 float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  if (s2 % 64 != 0 || s2 < 2 * kBlock || s2 > 2 * 32 * kPL || np % kBlock != 0) return (int)cudaErrorInvalidValue;
  const long long points = (long long)batch * np;
  if (points == 0) return 0;
#define UNOPOSE_ABLATE(D)                                                                                        \
  case D:                                                                                                        \
    return launch<D>(gx, gy, gz, w1, w2, cx, cy, cz, wpack, bpack, out, points, s2, r1, r2, inv_r1, inv_r2, stream);
  switch (drop) {
    UNOPOSE_ABLATE(0)
    UNOPOSE_ABLATE(1)
    UNOPOSE_ABLATE(2)
    UNOPOSE_ABLATE(4)
    UNOPOSE_ABLATE(8)
    UNOPOSE_ABLATE(15)
    UNOPOSE_ABLATE(11)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef UNOPOSE_ABLATE
}
