// Row 10's two-scale MLP and max-pool with no bias (row 24): per point, its
// S2 slots as materialised (B, N, S2) planes, a (B, N, S2) float32 0/1 mask
// and the centre; each scale's channels (rel xyz, then the frame
// coordinates) through its own MLP 6 -> 32 -> 64 -> 128 (bf16 operands,
// float32 accumulation, ReLU and a bf16 cast after each layer, no bias) and
// the max over the slots. Output (B, N, 256) float32: scale 1 in channels
// 0-127, its max over the slots whose mask is > 0 (bf16 -inf where a point
// has none), scale 2 in 128-255, its max over every slot.
//
// Replaces the TPU kernel benchmarks/profile_r9.py:kern (built by
// mk_variant, its pallas_call at :166), in the two modes its main() runs:
//  - matmul_only: no frame; both scales' frame channels are the rel xyz;
//  - full_nobias: scale 1's frame from the mask-weighted LRF at radius R1,
//    scale 2's from the LRF over every slot (a mask of ones) at R2.
// Its third mode, lrf_only, stores an (S2, p_blk, 256) value into a
// (p_blk, 256) block and does not trace; main() never runs it. p_blk, which
// the script sweeps, tiles the TPU's grid: every output is per point.
//
// Design: pe_packed.cu's (K19) point-major warp. One warp owns one point at
// a time; its lanes hold slots lane, lane + 32, ... in registers; the frame
// is pe_common.cuh's masked_lrf (butterfly sums, the acos-free Newton
// eigenvector); each scale's slots of the max are staged as bf16 rows in the
// warp's shared buffer and run through the MLP on mma.sync m16n8k16 tiles
// (staged_pool), both scales' weights in shared memory for a persistent
// grid. The TPU kernel's block-diagonal weights (blkdiag4) pad its 128 x 128
// matrix unit; their zero blocks add exact zeros, so each scale runs only
// its own block. The biases are zero (pack_mlp's float32 biases of 0: a sum
// plus 0.0f is the sum). A masked slot of scale 1 takes no MLP tile.
//
// Bound: operations, 2 x (6*32 + 32*64 + 64*128) = 20.9 kFLOP of bf16
// products a slot and scale, on all S2 slots of both scales as the TPU
// kernel computes them (tools/tpu_profile_bounds.py), against 16 bytes read
// a slot (three float32 planes and the mask). This first version uses
// mma.sync from registers, without wgmma or TMA.

#include "pe_common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kFrames>
__global__ void __launch_bounds__(kThreads)
profile_r9_kernel(const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
                  const float* __restrict__ mask, const float* __restrict__ cx, const float* __restrict__ cy,
                  const float* __restrict__ cz, const __nv_bfloat16* __restrict__ wpack,
                  const float* __restrict__ bpack, float* __restrict__ out, long long points, int s2, float r1,
                  float r2, float inv_r1, float inv_r2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  __nv_bfloat16* s_stage = reinterpret_cast<__nv_bfloat16*>(s_b + 2 * kBScale);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nu = s2 / 32;  // slots per lane
  __nv_bfloat16* stage = s_stage + warp * s2 * kRow;
  for (long long pt = (long long)blockIdx.x * kWarps + warp; pt < points; pt += (long long)gridDim.x * kWarps) {
    const float px = cx[pt], py = cy[pt], pz = cz[pt];
    const long long row = pt * s2;
    float rx[kPerLane], ry[kPerLane], rz[kPerLane], m1[kPerLane], ones[kPerLane];
    bool k1[kPerLane], k2[kPerLane];
    bool mine = false;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const bool in = u < nu;
      const long long s = row + u * 32 + lane;
      rx[u] = in ? gx[s] - px : 0.0f;
      ry[u] = in ? gy[s] - py : 0.0f;
      rz[u] = in ? gz[s] - pz : 0.0f;
      m1[u] = in ? mask[s] : 0.0f;
      ones[u] = in ? 1.0f : 0.0f;
      k1[u] = m1[u] > 0.0f;
      k2[u] = true;  // scale 2's max runs over every slot
      mine |= in && k1[u];
    }
    const bool kept = __any_sync(0xffffffffu, mine);
    float o0[kPerLane], o1[kPerLane], o2[kPerLane];
    if (kFrames) {
      masked_lrf(rx, ry, rz, m1, nu, r1, inv_r1, o0, o1, o2);
    } else {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        o0[u] = rx[u];
        o1[u] = ry[u];
        o2[u] = rz[u];
      }
    }
    if (kept) {
      staged_pool(rx, ry, rz, o0, o1, o2, k1, nu, s_w, s_b, stage, out + pt * 256);
    } else {  // no slot of scale 1 kept: the max over none, bf16 -inf
      for (int c = lane; c < 128; c += 32) out[pt * 256 + c] = -INFINITY;
    }
    if (kFrames) masked_lrf(rx, ry, rz, ones, nu, r2, inv_r2, o0, o1, o2);
    staged_pool(rx, ry, rz, o0, o1, o2, k2, nu, s_w + kWScale, s_b + kBScale, stage, out + pt * 256 + 128);
  }
}

template <bool kFrames>
int launch(const float* gx, const float* gy, const float* gz, const float* mask, const float* cx, const float* cy,
           const float* cz, const void* wpack, const float* bpack, float* out, long long points, int s2, float r1,
           float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      (size_t)kWarps * s2 * kRow * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(profile_r9_kernel<kFrames>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, profile_r9_kernel<kFrames>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (points + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  profile_r9_kernel<kFrames><<<(unsigned)blocks, kThreads, smem, stream>>>(
      gx, gy, gz, mask, cx, cy, cz, static_cast<const __nv_bfloat16*>(wpack), bpack, out, points, s2, r1, r2,
      inv_r1, inv_r2);
  return (int)cudaGetLastError();
}

}  // namespace

// slot planes and mask (points, S2) float32, centres (points); wpack / bpack:
// both scales' weights as ops/pe_fused.py:pack_mlp lays them out, the biases
// zero. S2 a multiple of 32 up to kMaxSlots; mode 0 matmul_only, 1 full_nobias.
extern "C" int unopose_profile_r9(const float* gx, const float* gy, const float* gz, const float* mask,
                                  const float* cx, const float* cy, const float* cz, const void* wpack,
                                  const float* bpack, float* out, long long points, int s2, int mode, float r1,
                                  float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  if (s2 % 32 != 0 || s2 <= 0 || s2 > kMaxSlots || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  if (points == 0) return 0;
  return mode ? launch<true>(gx, gy, gz, mask, cx, cy, cz, wpack, bpack, out, points, s2, r1, r2, inv_r1, inv_r2,
                             stream)
              : launch<false>(gx, gy, gz, mask, cx, cy, cz, wpack, bpack, out, points, s2, r1, r2, inv_r1, inv_r2,
                              stream);
}
