// Packed first_k fine PE, point-major (row 10): per point, its scale-2
// slots as materialised (B, P, S2) planes and both scales' multiset
// weights, through both scales' local frames, the folded-BatchNorm MLP
// 6 -> 32 -> 64 -> 128 (bf16 operands, float32 accumulation, bias + ReLU and
// a bf16 cast after each layer) and the max. Output (B, P, 256) float32:
// scale 1 in channels 0-127, scale 2 in 128-255, ahead of the PE's output
// Dense.
//
// Replaces the TPU kernel unopose_tpu/ops/pe_fused.py:pe_fused_packed
// (_pe_kernel_packed with _scale_block and _masked_lrf_block). Its
// reductions, which this kernel follows, are chosen per block of 64 points:
//  - fast block (every point's hit count total2 <= S2 / 2; the hits are
//    compacted to the front): only the first S2 / 2 slots; each scale's LRF
//    weighted by its multiset weights (w1, w2) and its max masked by w > 0;
//  - full block: all S2 slots; scale 1 as on the fast path; scale 2 with an
//    unweighted LRF (count S2: the pad slots are materialised duplicates of
//    the first hit) and an unmasked max.
// The TPU kernel packs the two scales (fast) or the two slot halves (full)
// into block-diagonal weights to fill its 128 x 128 matrix unit; the zero
// blocks add exact zeros, and here each scale runs its own MLP. One warp
// owns one point at a time: its lanes hold slots lane, lane + 32, ... in
// registers, the LRF is pe_common.cuh's masked_lrf (butterfly sums, the
// acos-free Newton eigenvector), and the slots of the max are staged as
// bf16 rows in the warp's shared buffer and run through the MLP on
// mma.sync m16n8k16 tiles (staged_pool, as in pe_masked.cu), both scales'
// weights in shared memory for a persistent grid. The fast flag is each
// warp's own max over its point's 64-point block. Past one window of 512
// slots (a full block at S2 > 512), a lane's slots are walked window by
// window from device memory (pe_common.cuh's windowed_scale): the LRF sums
// carried across windows in the lane's slot order, the max across them.
//
// Bound: operations. 2 x (6*32 + 32*64 + 64*128) = 20.9 kFLOP of bf16
// products per slot and scale taking part in the max: on a fast block the
// hits of both scales, on a full block scale 1's hits and all S2 slots of
// scale 2; against 14 bytes read per slot. This first version uses
// mma.sync from registers, without wgmma or TMA; its padding of the first
// layer (K 6 -> 16) and of the rows to whole 16-row tiles is not counted in
// the bound.
//
// Arithmetic follows the plain version (ops/pe_fused.py:
// pe_fused_packed_plain) operation by operation, each rounded on its own
// (-fmad=false); only the order of the slot sums and of the products'
// accumulation differs.

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 64;  // points per fast-path decision

template <int PL>
__global__ void __launch_bounds__(kThreads)
pe_packed_kernel(const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
                 const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
                 const int* __restrict__ total2, const float* __restrict__ cx, const float* __restrict__ cy,
                 const float* __restrict__ cz, const __nv_bfloat16* __restrict__ wpack,
                 const float* __restrict__ bpack, float* __restrict__ out, long long points, int np, int s2,
                 float r1, float r2, float inv_r1, float inv_r2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  __nv_bfloat16* s_stage = reinterpret_cast<__nv_bfloat16*>(s_b + 2 * kBScale);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __nv_bfloat16* stage = s_stage + warp * min(s2, kWindow) * kRow;
  for (long long pt = (long long)blockIdx.x * kWarps + warp; pt < points; pt += (long long)gridDim.x * kWarps) {
    const long long blk = pt - (pt % np) % kBlock;  // first point of its 64-point block
    const bool fast = warp_max_of(total2 + blk, kBlock) <= s2 / 2;
    const int nu = (fast ? s2 / 2 : s2) / 32;  // slots per lane
    const float px = cx[pt], py = cy[pt], pz = cz[pt];
    const long long row = pt * s2;
    if (nu > PL) {
      auto load = [&](int sc, int w, float (&rx)[PL], float (&ry)[PL], float (&rz)[PL], float (&m)[PL]) {
#pragma unroll
        for (int u = 0; u < PL; ++u) {
          const bool in = w * PL + u < nu;
          const long long s = row + (w * PL + u) * 32 + lane;
          rx[u] = in ? gx[s] - px : 0.0f;
          ry[u] = in ? gy[s] - py : 0.0f;
          rz[u] = in ? gz[s] - pz : 0.0f;
          m[u] = in ? (sc == 0 ? __bfloat162float(w1[s]) : (fast ? __bfloat162float(w2[s]) : 1.0f)) : 0.0f;
        }
      };
      windowed_scale<PL>([&](int w, auto& rx, auto& ry, auto& rz, auto& m) { load(0, w, rx, ry, rz, m); },
                         [](float m) { return m > 0.0f; }, nu, nu, r1, inv_r1, s_w, s_b, stage, out + pt * 256);
      windowed_scale<PL>([&](int w, auto& rx, auto& ry, auto& rz, auto& m) { load(1, w, rx, ry, rz, m); },
                         [fast](float m) { return !fast || m > 0.0f; }, nu, nu, r2, inv_r2, s_w + kWScale,
                         s_b + kBScale, stage, out + pt * 256 + 128);
      continue;
    }
    float rx[PL], ry[PL], rz[PL], m1[PL], m2[PL];
    bool k1[PL], k2[PL];
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      const bool in = u < nu;
      const long long s = row + u * 32 + lane;
      rx[u] = in ? gx[s] - px : 0.0f;
      ry[u] = in ? gy[s] - py : 0.0f;
      rz[u] = in ? gz[s] - pz : 0.0f;
      m1[u] = in ? __bfloat162float(w1[s]) : 0.0f;
      m2[u] = in ? (fast ? __bfloat162float(w2[s]) : 1.0f) : 0.0f;  // full: unweighted scale 2
      k1[u] = m1[u] > 0.0f;
      k2[u] = !fast || m2[u] > 0.0f;  // full: scale 2's max over every slot
    }
    float o0[PL], o1[PL], o2[PL];
    masked_lrf(rx, ry, rz, m1, nu, r1, inv_r1, o0, o1, o2);
    staged_pool(rx, ry, rz, o0, o1, o2, k1, nu, s_w, s_b, stage, out + pt * 256);
    masked_lrf(rx, ry, rz, m2, nu, r2, inv_r2, o0, o1, o2);
    staged_pool(rx, ry, rz, o0, o1, o2, k2, nu, s_w + kWScale, s_b + kBScale, stage, out + pt * 256 + 128);
  }
}

template <int PL>
int launch(const float* gx, const float* gy, const float* gz, const void* w1, const void* w2, const int* total2,
           const float* cx, const float* cy, const float* cz, const void* wpack, const float* bpack, float* out,
           long long points, int np, int s2, float r1, float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      (size_t)kWarps * min(s2, kWindow) * kRow * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(pe_packed_kernel<PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_packed_kernel<PL>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (points + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_packed_kernel<PL><<<(unsigned)blocks, kThreads, smem, stream>>>(
      gx, gy, gz, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), total2, cx, cy, cz,
      static_cast<const __nv_bfloat16*>(wpack), bpack, out, points, np, s2, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}

}  // namespace

// slot planes (B, P, S2) float32, weights (B, P, S2) bf16, total2 (B, P)
// int32, centres (B, P); wpack / bpack: both scales' weights as
// ops/pe_fused.py:pack_mlp lays them out (2 x kWScale bf16, 2 x kBScale
// float32). S2: a multiple of 256 up to P (at most kMaxSlotsPacked).
extern "C" int unopose_pe_packed(const float* gx, const float* gy, const float* gz, const void* w1, const void* w2,
                                 const int* total2, const float* cx, const float* cy, const float* cz,
                                 const void* wpack, const float* bpack, float* out, int batch, int np, int s2,
                                 float r1, float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  if (s2 % 256 != 0 || s2 <= 0 || s2 > kMaxSlotsPacked || s2 > np || np % kBlock != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long points = (long long)batch * np;
  if (points == 0) return 0;
  return s2 <= kMaxSlots ? launch<kPerLane>(gx, gy, gz, w1, w2, total2, cx, cy, cz, wpack, bpack, out, points, np,
                                            s2, r1, r2, inv_r1, inv_r2, stream)
                         : launch<kPerLaneMax>(gx, gy, gz, w1, w2, total2, cx, cy, cz, wpack, bpack, out, points,
                                               np, s2, r1, r2, inv_r1, inv_r2, stream);
}
