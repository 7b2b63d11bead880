// Fine-PE MLP and pool: per point and scale, the folded-BatchNorm MLP
// 6 -> 32 -> 64 -> 128 (bf16 operands, float32 accumulation, bias + ReLU and
// a bf16 cast after each layer) over the point's slots, then the max over
// the slots whose multiset weight is > 0. Output (B, P, 256) float32: scale 1
// in channels 0-127, scale 2 in 128-255, ahead of the PE's output Dense.
//
// Replaces the TPU kernel B of unopose_tpu/ops/pe_fused.py:pe_fused_v5
// (_pe_kernel_mlp_v5). The TPU kernel packs both scales into one
// block-diagonal 12 -> 64 -> 128 -> 256 MLP to fill its 128 x 128 matrix unit
// and runs it on 64-slot chunks of 128 points. Here the two scales run
// separately, which halves the products (the off-diagonal blocks contribute
// exact zeros), on the tensor cores with mma.sync m16n8k16 bf16: one warp
// owns one point, takes its slots 16 at a time as the A operand (read
// straight from the (B, P, S2, 12) channels), and chains the three layers
// in registers, since a layer's float32 accumulator fragment, biased,
// ReLU'd and packed to bf16 pairs, is the next layer's A fragment. The last
// layer's 16 column tiles go straight into a running max (4 lanes per
// column pair, reduced across the 8 row groups by shuffles at the end). The
// weights of both scales, transposed to (out, in) with K padded to 16 for the
// first layer and each row padded by 8 bf16 (conflict-free fragment loads),
// sit in shared memory (51 KB) for a persistent grid of blocks.
//
// A point runs ceil(total2 / 64) 64-slot chunks (at least one), the slots
// the channels kernel (pe_channels.cu) wrote: every slot past total2 has
// weight 0 in both scales, and with ReLU outputs >= 0 a masked slot never
// raises the max, so the pool equals the TPU kernel's over its block tier.
//
// Bound: operations. 2 x (6*32 + 32*64 + 64*128) x 2 = 41.7 kFLOP of bf16
// products per needed slot (~175 GFLOP at B = 32, N = 2048 and one 64-slot
// tier per point, ~0.18 ms at 989 TFLOP/s) against 24 + 4 bytes read per
// slot. This first version uses mma.sync from registers, without wgmma or
// TMA; its padding of the first layer (K 6 -> 16) is not counted in the
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLd0 = 16 + 8;  // row strides of the transposed weights, in bf16
constexpr int kLd1 = 32 + 8;
constexpr int kLd2 = 64 + 8;
constexpr int kW0 = 32 * kLd0;
constexpr int kW1 = 64 * kLd1;
constexpr int kW2 = 128 * kLd2;
constexpr int kWScale = kW0 + kW1 + kW2;  // ops/pe_fused.py:pack_mlp
constexpr int kBScale = 32 + 64 + 128;
constexpr int kMaxSlots = 256;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// bias + ReLU, rounded to a bf16 pair (low half = lower column)
__device__ __forceinline__ uint32_t relu_pack(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(x, 0.0f), fmaxf(y, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float relu_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(fmaxf(x, 0.0f))); }

__global__ void __launch_bounds__(kThreads)
pe_mlp_pool_kernel(const __nv_bfloat16* __restrict__ chans, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2, const int* __restrict__ total2,
                   const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack,
                   float* __restrict__ out, long long points, int s2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group
  for (long long pt = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); pt < points;
       pt += (long long)gridDim.x * kWarps) {
    const int chunks = max(1, min((total2[pt] + 63) >> 6, s2 >> 6));
    const __nv_bfloat16* ch = chans + pt * s2 * 12;
#pragma unroll 1
    for (int sc = 0; sc < 2; ++sc) {
      const __nv_bfloat16* W0 = s_w + sc * kWScale;
      const __nv_bfloat16* W1 = W0 + kW0;
      const __nv_bfloat16* W2 = W1 + kW1;
      const float* B0 = s_b + sc * kBScale;
      const float* B1 = B0 + 32;
      const float* B2 = B1 + 64;
      const __nv_bfloat16* wm = (sc ? w2 : w1) + pt * s2;
      float mx[16][2];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) mx[nt][0] = mx[nt][1] = 0.0f;  // ReLU outputs are >= 0

#pragma unroll 1
      for (int mt = 0; mt < 4 * chunks; ++mt) {
        const int r0 = mt * 16 + g, r1 = r0 + 8;  // the two slots (rows) this lane holds
        const bool keep0 = __bfloat162float(wm[r0]) > 0.0f;
        const bool keep1 = __bfloat162float(wm[r1]) > 0.0f;
        // layer 1: K = the scale's 6 channels, zero-padded to 16
        uint32_t a1[4] = {0u, 0u, 0u, 0u};
        if (t < 3) {
          a1[0] = ld32(ch + r0 * 12 + 6 * sc + 2 * t);
          a1[1] = ld32(ch + r1 * 12 + 6 * sc + 2 * t);
        }
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
        // layer 2: 32 -> 64
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
        // layer 3: 64 -> 128, straight into the masked running max
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kt = 0; kt < 4; ++kt) {
            const __nv_bfloat16* wr = W2 + (nt * 8 + g) * kLd2 + kt * 16 + 2 * t;
            mma_bf16(c, a3[kt], ld32(wr), ld32(wr + 8));
          }
          const int col = nt * 8 + 2 * t;
          const float h0 = keep0 ? relu_bf16(c[0] + B2[col]) : 0.0f;
          const float h1 = keep0 ? relu_bf16(c[1] + B2[col + 1]) : 0.0f;
          const float h2 = keep1 ? relu_bf16(c[2] + B2[col]) : 0.0f;
          const float h3 = keep1 ? relu_bf16(c[3] + B2[col + 1]) : 0.0f;
          mx[nt][0] = fmaxf(mx[nt][0], fmaxf(h0, h2));
          mx[nt][1] = fmaxf(mx[nt][1], fmaxf(h1, h3));
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
          mx[nt][j] = v;
        }
        if (g == 0) {
          *reinterpret_cast<float2*>(out + pt * 256 + sc * 128 + nt * 8 + 2 * t) = make_float2(mx[nt][0], mx[nt][1]);
        }
      }
    }
  }
}

}  // namespace

// wpack: both scales' transposed, padded bf16 weights (2 x kWScale); bpack:
// their float32 biases (2 x kBScale)
extern "C" int unopose_pe_mlp_pool(const void* chans, const void* w1, const void* w2, const int* total2,
                                   const void* wpack, const float* bpack, float* out, long long points, int s2,
                                   cudaStream_t stream) {
  if (s2 > kMaxSlots || s2 % 64 != 0 || s2 == 0) return (int)cudaErrorInvalidValue;
  if (points == 0) return 0;
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pe_mlp_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_mlp_pool_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (points + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_mlp_pool_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(chans), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), total2, static_cast<const __nv_bfloat16*>(wpack), bpack, out, points,
      s2);
  return (int)cudaGetLastError();
}
