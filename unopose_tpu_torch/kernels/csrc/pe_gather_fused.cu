// Grouping-fused fine PE (row 12, PE-v4): PE-v5's function in one launch.
// Per point: gather its slots' coordinates from the cloud's permuted planes
// through the int16 slot indices, both scales' weighted local frames, the
// 12 bf16 channels, the folded-BatchNorm MLP 6 -> 32 -> 64 -> 128 (bf16
// operands, float32 accumulation, bias + ReLU and a bf16 cast after each
// layer) and each scale's max over the slots of weight > 0. Output
// (B, P, 256) float32: scale 1 in channels 0-127, scale 2 in 128-255.
//
// Replaces the TPU kernel unopose_tpu/ops/pe_fused.py:pe_fused_gather_t
// (_pe_kernel_gather_t). The TPU kernel gathers from 128-lane banks of the
// permuted planes, lays slots on sublanes and points on lanes, and runs a
// 64/128/S2-slot tier per block of 128 points through one block-diagonal
// cross-scale MLP; the JAX package holds it bitwise equal to PE-v5
// (tests/test_model.py). So is this kernel to pe_channels.cu (K5) followed
// by pe_mlp_pool.cu (K6) on the same inputs: it runs their per-point code,
// pe_common.cuh's point_channels and point_pool, in the same order, with
// the 12 channels of the point's slots staged in the warp's shared buffer
// (24 bytes a slot, the layout K5 writes to device memory) instead of
// device memory. The tier, which this kernel follows, is 64, 128 or S2 slots
// for every point of its 128-point block, the least that holds the block's
// largest hit count; K5 and K6 take 64 * ceil(total2 / 64) slots per point.
// A tier past one window of 512 slots (S2 > 512) is walked window by window
// (pe_common.cuh's point_channels_pool_windowed): both frames first, the
// LRF sums carried across windows in the lane's slot order, then each
// window's channels and pool, the max carried in the output.
// The slots between the two carry weight 0 in both scales: in the LRF sums
// they add exact zeros, and in the max they are masked to 0, which never
// raises it, so both give the same bits. A block stages its cloud's
// planes (24 KB at N = 2048) and both scales' weights in shared memory.
//
// Bound: operations. Per slot of the tier: ~160 float32 operations of
// gather and LRF (both scales) and 2 x 2 x (6*32 + 32*64 + 64*128) = 41.7
// kFLOP of bf16 products; it reads 2 index and 4 weight bytes a slot, the
// planes and centres, and writes 1 KB a point. This first version uses
// mma.sync from registers, without wgmma or TMA; its padding of the first
// layer (K 6 -> 16) is not counted in the bound.

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 128;  // points per tier decision, one thread block
constexpr int kMaxN = 4096;

// the staged planes' floats, rounded up to keep the channel buffer behind them 16-byte aligned
__host__ __device__ __forceinline__ int planes_floats(int n) { return (3 * n + 3) & ~3; }

template <int PL>
__global__ void __launch_bounds__(kThreads)
pe_gather_fused_kernel(const float* __restrict__ xp, const float* __restrict__ yp, const float* __restrict__ zp,
                       const int16_t* __restrict__ idx, const __nv_bfloat16* __restrict__ w1,
                       const __nv_bfloat16* __restrict__ w2, const int* __restrict__ total2,
                       const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
                       const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack,
                       float* __restrict__ out, int n, int np, int s2, float r1, float r2, float inv_r1,
                       float inv_r2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  float* s_planes = s_b + 2 * kBScale;  // x, y, z planes of the cloud, n each
  __nv_bfloat16* s_stage = reinterpret_cast<__nv_bfloat16*>(s_planes + planes_floats(n));
  const int blocks_per_cloud = np / kBlock;
  const int b = blockIdx.x / blocks_per_cloud;
  const int p0 = (blockIdx.x % blocks_per_cloud) * kBlock;
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  for (int j = threadIdx.x; j < n; j += kThreads) {
    s_planes[j] = xp[(size_t)b * n + j];
    s_planes[n + j] = yp[(size_t)b * n + j];
    s_planes[2 * n + j] = zp[(size_t)b * n + j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  __nv_bfloat16* stage = s_stage + warp * min(s2, kWindow) * 12;
  const int bmax = warp_max_of(total2 + (size_t)b * np + p0, kBlock);
  const int tier = bmax <= 64 ? 64 : (bmax <= 128 ? 128 : s2);
  for (int p = p0 + warp; p < p0 + kBlock; p += kWarps) {
    const size_t pt = (size_t)b * np + p;
    if (tier > kWindow) {
      point_channels_pool_windowed<PL>(s_planes, n, idx + pt * s2, w1 + pt * s2, w2 + pt * s2, tier / 32, cx[pt],
                                       cy[pt], cz[pt], r1, r2, inv_r1, inv_r2, stage, s_w, s_b, out + pt * 256);
      continue;
    }
    point_channels<PL>(s_planes, n, idx + pt * s2, w1 + pt * s2, w2 + pt * s2, tier / 32, cx[pt], cy[pt], cz[pt],
                       r1, r2, inv_r1, inv_r2, stage);
    __syncwarp();
    point_pool(stage, w1 + pt * s2, w2 + pt * s2, tier / 16, s_w, s_b, out + pt * 256);
    __syncwarp();  // the buffer is rewritten by the next point
  }
}

template <int PL>
int launch(const float* xp, const float* yp, const float* zp, const int16_t* idx, const void* w1, const void* w2,
           const int* total2, const float* cx, const float* cy, const float* cz, const void* wpack,
           const float* bpack, float* out, int batch, int n, int np, int s2, float r1, float r2, float inv_r1,
           float inv_r2, cudaStream_t stream) {
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      (size_t)planes_floats(n) * sizeof(float) +
                      (size_t)kWarps * min(s2, kWindow) * 12 * sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(pe_gather_fused_kernel<PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pe_gather_fused_kernel<PL><<<(unsigned)(batch * (np / kBlock)), kThreads, smem, stream>>>(
      xp, yp, zp, idx, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), total2, cx,
      cy, cz, static_cast<const __nv_bfloat16*>(wpack), bpack, out, n, np, s2, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}

}  // namespace

// permuted planes (B, N) float32, slot indices (B, P, S2) int16, weights
// (B, P, S2) bf16, total2 (B, P) int32, centres (B, P); wpack / bpack: both
// scales' weights as ops/pe_fused.py:pack_mlp lays them out. S2: a multiple
// of 256 up to N (at most kMaxSlotsPacked).
extern "C" int unopose_pe_gather_fused(const float* xp, const float* yp, const float* zp, const int16_t* idx,
                                       const void* w1, const void* w2, const int* total2, const float* cx,
                                       const float* cy, const float* cz, const void* wpack, const float* bpack,
                                       float* out, int batch, int n, int np, int s2, float r1, float r2,
                                       float inv_r1, float inv_r2, cudaStream_t stream) {
  if (n <= 0 || n > kMaxN || s2 % 256 != 0 || s2 <= 0 || s2 > kMaxSlotsPacked || s2 > n || np % kBlock != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || np == 0) return 0;
  return s2 <= kMaxSlots ? launch<kPerLane>(xp, yp, zp, idx, w1, w2, total2, cx, cy, cz, wpack, bpack, out, batch, n,
                                            np, s2, r1, r2, inv_r1, inv_r2, stream)
                         : launch<kPerLaneMax>(xp, yp, zp, idx, w1, w2, total2, cx, cy, cz, wpack, bpack, out, batch,
                                               n, np, s2, r1, r2, inv_r1, inv_r2, stream);
}
