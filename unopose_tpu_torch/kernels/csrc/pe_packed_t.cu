// Packed first_k fine PE, slot-major (row 11): per point, its scale-2 slots
// and both scales' multiset weights given slot-major as (B, S2, P) planes,
// both scales' local frames weighted over all S2 slots, the 12 bf16
// channels, the folded-BatchNorm MLP 6 -> 32 -> 64 -> 128 (bf16 operands,
// float32 accumulation, bias + ReLU and a bf16 cast after each layer) over
// the slots of its tier, and each scale's max over those of weight > 0.
// Output (B, P, 256) float32: scale 1 in channels 0-127, scale 2 in 128-255.
//
// Replaces the TPU kernel unopose_tpu/ops/pe_fused.py:pe_fused_packed_t
// (_pe_kernel_packed_t with _masked_lrf_block_t). The TPU kernel lays
// slots on sublanes and points on lanes, reduces the LRF moments over all
// S2 slots, and runs one block-diagonal cross-scale MLP on 64-slot chunks of
// a tier of 64, 128 or S2 slots for every point of its 128-point block (the
// least that holds the block's largest hit count; the hits are compacted to
// the front). This kernel follows those reductions. Its layout: a block
// takes 8 consecutive points at a time and copies their slot columns of the
// five inputs into shared memory, each warp reading 4 slot rows of 8
// points, 32 contiguous bytes each (the TPU layout's lane axis); one warp
// per point then reads its column, a lane holding slots lane, lane + 32,
// ... (a row stride of 9 words spreads the lanes over the banks), and runs
// pe_common.cuh's masked_lrf over all S2 slots and staged_pool over the
// tier (the kept slots staged as bf16 rows and run through the MLP on
// mma.sync m16n8k16 tiles, as in pe_masked.cu); both scales' weights in
// shared memory for a persistent grid. Past one window (S2 > 512, whose
// columns would not fit in shared memory), a warp reads its point's slot
// column from device memory window by window, the 8 warps of a block
// sharing each 32-byte sector through L1, and runs pe_common.cuh's
// windowed_scale: the LRF sums carried across windows in the lane's slot
// order, the max across them.
//
// Bound: operations. 2 x (6*32 + 32*64 + 64*128) = 20.9 kFLOP of bf16
// products per slot and scale of weight > 0, against 16 bytes read per
// slot. This first version uses mma.sync from registers, without wgmma or
// TMA; its padding of the first layer (K 6 -> 16) and of the rows to whole
// 16-row tiles is not counted in the bound.
//
// Arithmetic follows the plain version (ops/pe_fused.py:
// pe_fused_packed_t_plain) operation by operation, each rounded on its own
// (-fmad=false); only the order of the slot sums and of the products'
// accumulation differs.

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kWarps;  // points staged at a time, one a warp
constexpr int kLd = kTile + 1;  // words per staged slot row
constexpr int kBlock = 128;     // points per tier decision

template <int PL>
__global__ void __launch_bounds__(kThreads)
pe_packed_t_kernel(const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
                   const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
                   const int* __restrict__ total2, const float* __restrict__ cx, const float* __restrict__ cy,
                   const float* __restrict__ cz, const __nv_bfloat16* __restrict__ wpack,
                   const float* __restrict__ bpack, float* __restrict__ out, int batch, int np, int s2, float r1,
                   float r2, float inv_r1, float inv_r2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  float* s_cols = s_b + 2 * kBScale;  // x, y, z, w1, w2 columns: s2 rows of kLd words each
  __nv_bfloat16* s_stage = reinterpret_cast<__nv_bfloat16*>(s_cols + 5 * s2 * kLd);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nu = s2 / 32;  // slots per lane
  const long long tiles = (long long)batch * (np / kTile);
  if (nu > PL) {
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(s_cols) + warp * kWindow * kRow;
    __syncthreads();  // the weights are in
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long b = tile / (np / kTile);
      const int p = (int)(tile % (np / kTile)) * kTile + warp;
      const long long pt = b * np + p;
      const int bmax = warp_max_of(total2 + b * np + (p - p % kBlock), kBlock);
      const int tier = bmax <= 64 ? 64 : (bmax <= 128 ? 128 : s2);
      const float px = cx[pt], py = cy[pt], pz = cz[pt];
      auto load = [&](const __nv_bfloat16* __restrict__ wm, int w, float (&rx)[PL], float (&ry)[PL],
                      float (&rz)[PL], float (&m)[PL]) {
#pragma unroll
        for (int u = 0; u < PL; ++u) {
          const bool in = w * PL + u < nu;
          const long long src = (b * s2 + (w * PL + u) * 32 + lane) * np + p;
          rx[u] = in ? gx[src] - px : 0.0f;
          ry[u] = in ? gy[src] - py : 0.0f;
          rz[u] = in ? gz[src] - pz : 0.0f;
          m[u] = in ? __bfloat162float(wm[src]) : 0.0f;
        }
      };
      windowed_scale<PL>([&](int w, auto& rx, auto& ry, auto& rz, auto& m) { load(w1, w, rx, ry, rz, m); },
                         [](float m) { return m > 0.0f; }, nu, tier / 32, r1, inv_r1, s_w, s_b, stage,
                         out + pt * 256);
      windowed_scale<PL>([&](int w, auto& rx, auto& ry, auto& rz, auto& m) { load(w2, w, rx, ry, rz, m); },
                         [](float m) { return m > 0.0f; }, nu, tier / 32, r2, inv_r2, s_w + kWScale,
                         s_b + kBScale, stage, out + pt * 256 + 128);
    }
    return;
  }
  __nv_bfloat16* stage = s_stage + warp * s2 * kRow;
  const float* col = s_cols + warp;
  const int plane = s2 * kLd;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long b = tile / (np / kTile);
    const int p0 = (int)(tile % (np / kTile)) * kTile;
    __syncthreads();  // the weights are in, or the last tile's columns are read
    for (int i = threadIdx.x; i < s2 * kTile; i += kThreads) {
      const int s = i / kTile, j = i % kTile;
      const long long src = (b * s2 + s) * np + p0 + j;
      s_cols[s * kLd + j] = gx[src];
      s_cols[plane + s * kLd + j] = gy[src];
      s_cols[2 * plane + s * kLd + j] = gz[src];
      s_cols[3 * plane + s * kLd + j] = __bfloat162float(w1[src]);
      s_cols[4 * plane + s * kLd + j] = __bfloat162float(w2[src]);
    }
    __syncthreads();

    const long long pt = b * np + p0 + warp;
    const int bmax = warp_max_of(total2 + b * np + (p0 - p0 % kBlock), kBlock);
    const int tier = bmax <= 64 ? 64 : (bmax <= 128 ? 128 : s2);
    const float px = cx[pt], py = cy[pt], pz = cz[pt];
    float rx[PL], ry[PL], rz[PL], m[PL];
    bool keep[PL];
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      const bool in = u < nu;
      const int s = (u * 32 + lane) * kLd;
      rx[u] = in ? col[s] - px : 0.0f;
      ry[u] = in ? col[plane + s] - py : 0.0f;
      rz[u] = in ? col[2 * plane + s] - pz : 0.0f;
    }
    float o0[PL], o1[PL], o2[PL];
#pragma unroll 1
    for (int sc = 0; sc < 2; ++sc) {
#pragma unroll
      for (int u = 0; u < PL; ++u) {
        m[u] = u < nu ? col[(3 + sc) * plane + (u * 32 + lane) * kLd] : 0.0f;
        keep[u] = m[u] > 0.0f;
      }
      masked_lrf(rx, ry, rz, m, nu, sc ? r2 : r1, sc ? inv_r2 : inv_r1, o0, o1, o2);
      staged_pool(rx, ry, rz, o0, o1, o2, keep, tier / 32, s_w + sc * kWScale, s_b + sc * kBScale, stage,
                  out + pt * 256 + sc * 128);
    }
  }
}

template <int PL>
int launch(const float* gx, const float* gy, const float* gz, const void* w1, const void* w2, const int* total2,
           const float* cx, const float* cy, const float* cz, const void* wpack, const float* bpack, float* out,
           int batch, int np, int s2, float r1, float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  // past one window only the warps' staging buffers (the columns are read from device memory)
  const size_t cols = s2 > kWindow ? 0 : (size_t)5 * s2 * kLd * sizeof(float);
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) + cols +
                      (size_t)kWarps * min(s2, kWindow) * kRow * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(pe_packed_t_kernel<PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_packed_t_kernel<PL>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)batch * (np / kTile);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_packed_t_kernel<PL><<<(unsigned)blocks, kThreads, smem, stream>>>(
      gx, gy, gz, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), total2, cx, cy, cz,
      static_cast<const __nv_bfloat16*>(wpack), bpack, out, batch, np, s2, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}

}  // namespace

// slot planes (B, S2, P) float32, weights (B, S2, P) bf16, total2 (B, P)
// int32, centres (B, P); wpack / bpack: both scales' weights as
// ops/pe_fused.py:pack_mlp lays them out. S2: a multiple of 256 up to P (at
// most kMaxSlotsPacked).
extern "C" int unopose_pe_packed_t(const float* gx, const float* gy, const float* gz, const void* w1, const void* w2,
                                   const int* total2, const float* cx, const float* cy, const float* cz,
                                   const void* wpack, const float* bpack, float* out, int batch, int np, int s2,
                                   float r1, float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  if (s2 % 256 != 0 || s2 <= 0 || s2 > kMaxSlotsPacked || s2 > np || np % kBlock != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || np == 0) return 0;
  return s2 <= kMaxSlots ? launch<kPerLane>(gx, gy, gz, w1, w2, total2, cx, cy, cz, wpack, bpack, out, batch, np, s2,
                                            r1, r2, inv_r1, inv_r2, stream)
                         : launch<kPerLaneMax>(gx, gy, gz, w1, w2, total2, cx, cy, cz, wpack, bpack, out, batch, np,
                                               s2, r1, r2, inv_r1, inv_r2, stream);
}
