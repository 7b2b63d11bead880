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
// sit in shared memory (51 KB) for a persistent grid of blocks. The
// per-point work (point_pool, with mlp_tile and store_max) is
// pe_common.cuh's, shared with pe_gather_fused.cu (K21).
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

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

  for (long long pt = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); pt < points;
       pt += (long long)gridDim.x * kWarps) {
    const int chunks = max(1, min((total2[pt] + 63) >> 6, s2 >> 6));
    point_pool(chans + pt * s2 * 12, w1 + pt * s2, w2 + pt * s2, 4 * chunks, s_w, s_b, out + pt * 256);
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
