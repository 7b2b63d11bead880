// Packed fine-PE MLP and pool on prebuilt channels (row 13): per point,
// the folded-BatchNorm MLP 6 -> 32 -> 64 -> 128 of each scale over the 12
// channels ops/pe_fused.py:pe_channels_packed builds (scale 1 zeroed where
// its weight is 0, so a zeroed slot is an exact copy of the self point),
// bf16 operands, float32 accumulation, bias + ReLU and a bf16 cast after
// layers 1 and 2, bias + ReLU in float32 after layer 3, then the unmasked
// max over the point's slots of its first `tier` chunks. Output (B, P, 256)
// float32: scale 1 in channels 0-127, scale 2 in 128-255.
//
// Replaces the TPU kernel unopose_tpu/ops/pe_fused.py:pe_mlp_pool_packed
// (_pe_mlp_pool_kernel). The TPU kernel reads each of four (B, 12, P, w)
// slot chunks (w = S2 / 4) as a flat (12, 64 w) block and runs one
// block-diagonal 12 -> 64 -> 128 -> 256 MLP columns-major on its matrix
// unit; the zero blocks add exact zeros, and here each scale runs its own
// MLP. Its tier, which this kernel follows, is clip(ceil(bmax / w), 1, 4)
// chunks for every point of a 64-point block (bmax: the block's largest hit
// count; the hits are compacted to the front, so the skipped chunks hold
// only pad duplicates and zeroed slots, which never raise the max). One
// warp owns one point at a time: per scale and chunk, its lanes copy the
// scale's six channels of the w slots into the warp's shared buffer as
// bf16 rows, reading each channel's w contiguous values coalesced, and the
// MLP runs on mma.sync m16n8k16 tiles of 16 rows (pe_common.cuh's mlp_tile,
// with the last layer left unrounded), into a running max; both scales'
// weights in shared memory for a persistent grid. The chunks are read in
// place with a row stride `ld` (w for four separate tensors, S2 for the
// four views of one (B, 12, P, S2) tensor). A chunk wider than the warp's
// buffer (w > 128, S2 > 512) is staged and run 128 slots at a time, the max
// carried across them.
//
// Bound: operations. 2 x (6*32 + 32*64 + 64*128) = 20.9 kFLOP of bf16
// products per slot and scale of the chunks a point runs, against 24 bytes
// read per slot. This first version uses mma.sync from registers, without
// wgmma or TMA; its padding of the first layer (K 6 -> 16) is not counted
// in the bound.
//
// Arithmetic follows the plain version (ops/pe_fused.py:
// pe_mlp_pool_packed_plain); only the order of the products' accumulation
// differs.

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 64;  // points per tier decision
constexpr int kMaxW = 128;  // slots of a chunk staged at a time

__global__ void __launch_bounds__(kThreads)
pe_mlp_pool_packed_kernel(const __nv_bfloat16* __restrict__ c0, const __nv_bfloat16* __restrict__ c1,
                          const __nv_bfloat16* __restrict__ c2, const __nv_bfloat16* __restrict__ c3,
                          const int* __restrict__ total2, const __nv_bfloat16* __restrict__ wpack,
                          const float* __restrict__ bpack, float* __restrict__ out, long long points, int np, int w,
                          long long ld) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  __nv_bfloat16* s_stage = reinterpret_cast<__nv_bfloat16*>(s_b + 2 * kBScale);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group
  __nv_bfloat16* stage = s_stage + warp * kMaxW * kRow;
  const __nv_bfloat16* chunks[4] = {c0, c1, c2, c3};
  const long long plane = (long long)np * ld;  // one channel of one cloud
  for (long long pt = (long long)blockIdx.x * kWarps + warp; pt < points; pt += (long long)gridDim.x * kWarps) {
    const long long b = pt / np, p = pt % np;
    const int bmax = warp_max_of(total2 + pt - p % kBlock, kBlock);
    const int tier = max(1, min((bmax + w - 1) / w, 4));
#pragma unroll 1
    for (int sc = 0; sc < 2; ++sc) {
      float mx[16][2];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) mx[nt][0] = mx[nt][1] = 0.0f;  // ReLU outputs are >= 0
#pragma unroll 1
      for (int c = 0; c < tier; ++c) {
#pragma unroll 1
        for (int s0 = 0; s0 < w; s0 += kMaxW) {
          const int ws = min(kMaxW, w - s0);
          const __nv_bfloat16* src = chunks[c] + (b * 12 + 6 * sc) * plane + p * ld + s0;
          for (int ch = 0; ch < 6; ++ch) {
            for (int s = lane; s < ws; s += 32) stage[s * kRow + ch] = src[ch * plane + s];
          }
          __syncwarp();
#pragma unroll 1
          for (int mt = 0; mt < ws / 16; ++mt) {
            const int r0 = mt * 16 + g, r1 = r0 + 8;  // the two slots (rows) this lane holds
            // layer 1's A fragment: K = the scale's 6 channels, zero-padded to 16
            uint32_t a1[4] = {0u, 0u, 0u, 0u};
            if (t < 3) {
              a1[0] = ld32(stage + r0 * kRow + 2 * t);
              a1[1] = ld32(stage + r1 * kRow + 2 * t);
            }
            mlp_tile<false>(a1, s_w + sc * kWScale, s_b + sc * kBScale, true, true, mx);
          }
          __syncwarp();  // the buffer is rewritten by the next window
        }
      }
      store_max(mx, out + pt * 256 + sc * 128);
    }
  }
}

}  // namespace

// chunks: four (B, 12, P, w) bf16 arrays, element (b, c, p, s) at ((b * 12 +
// c) * P + p) * ld + s; total2 (B, P) int32; wpack / bpack: both scales'
// weights as ops/pe_fused.py:pack_mlp lays them out
extern "C" int unopose_pe_mlp_pool_packed(const void* c0, const void* c1, const void* c2, const void* c3,
                                          const int* total2, const void* wpack, const float* bpack, float* out,
                                          int batch, int np, int w, int ld, cudaStream_t stream) {
  if (w <= 0 || w % 64 != 0 || 4 * w > kMaxSlotsPacked || 4 * w > np || ld < w || np % kBlock != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long points = (long long)batch * np;
  if (points == 0) return 0;
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      (size_t)kWarps * kMaxW * kRow * sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(pe_mlp_pool_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_mlp_pool_packed_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (points + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_mlp_pool_packed_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(c0), static_cast<const __nv_bfloat16*>(c1),
      static_cast<const __nv_bfloat16*>(c2), static_cast<const __nv_bfloat16*>(c3), total2,
      static_cast<const __nv_bfloat16*>(wpack), bpack, out, points, np, w, (long long)ld);
  return (int)cudaGetLastError();
}
