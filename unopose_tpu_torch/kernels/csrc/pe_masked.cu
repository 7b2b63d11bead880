// Masked fine PE: per point and scale, the relative coordinates of its
// grouped neighbours, their local reference frame over the valid slots, the
// six channels rounded to bf16, the folded-BatchNorm MLP 6 -> 32 -> 64 -> 128
// (bf16 operands, float32 accumulation, bias + ReLU and a bf16 cast after
// each layer) and the max over the valid slots, taken as a multiply by the
// mask after the ReLU. Output (B, P, 256) float32: scale 1 in channels 0-127,
// scale 2 in 128-255, ahead of the PE's output Dense.
//
// Replaces the TPU kernel unopose_tpu/ops/pe_fused.py:pe_fused (_pe_kernel
// with _scale_block and _masked_lrf_block), which serves the subset mode and
// the unpacked first_k grouping (all-ones masks). The TPU kernel pads S to a
// multiple of 128 (Mosaic cannot merge a smaller minor dim), keeps slots on
// lanes, and packs sample pairs into block-diagonal weights when S % 256 == 0
// to fill its 128 x 128 matrix unit. Here one warp owns one point at a time:
//  - the LRF runs as in pe_channels.cu, the warp's lanes holding slots lane,
//    lane + 32, ... in registers and every sum a butterfly reduction (each
//    lane ends with the same bits), the eigenvector by the acos-free Newton
//    trisection;
//  - a lane holding a valid slot writes its six bf16 channels as one 16-byte
//    row of the warp's staging buffer in shared memory (4 KB at S = 256),
//    the valid slots packed to the front by ballot ranks: a masked slot's
//    outputs are multiplied by 0 and a ReLU output never lowers a max that
//    starts at 0, so the max over the valid rows, in any order, is the
//    result, and the MLP runs on ceil(valid / 16) tiles instead of S / 16;
//  - the MLP runs as in pe_mlp_pool.cu on mma.sync m16n8k16 bf16 tiles of 16
//    rows read from that buffer, the three layers chained in registers, the
//    rows past the valid ones zero and masked out;
//  - both scales' weights, laid out by ops/pe_fused.py:pack_mlp, sit in
//    shared memory for a persistent grid of blocks.
//
// Bound: operations. 2 x (6*32 + 32*64 + 64*128) = 20.9 kFLOP of bf16
// products per valid slot (at most 6.7 MFLOP per point at S1 64 + S2 256,
// ~437 GFLOP at B = 32, N = 2048, ~0.44 ms at 989 TFLOP/s, where every slot
// is valid as on the unpacked first_k path), against (3 x 4 + 1) bytes read
// per slot. This first version uses mma.sync from registers, without wgmma
// or TMA; its padding of the first layer (K 6 -> 16) and of the valid rows to
// whole 16-row tiles is not counted in the bound.
//
// Arithmetic follows the plain version (ops/pe_fused.py:pe_fused_masked_plain,
// via ops/lrf.py:batch_lrf_planar and ops/eig3.py with use_newton) operation
// by operation, each rounded on its own (-fmad=false); only the order of the
// slot sums and of the products' accumulation differs. The LRF (masked_lrf),
// the staging, tile and max (staged_pool, with mlp_tile and store_max) are
// pe_common.cuh's, shared with pe_packed.cu (K19) and pe_packed_t.cu (K22).

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One scale of one point: the masked LRF, then the valid slots through the
// MLP and the max (staged_pool), written to out[0..127].
__device__ void pe_scale(const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
                         const uint8_t* __restrict__ mask, int s, float px, float py, float pz, float r_lrf,
                         float inv_r, const __nv_bfloat16* W0, const float* B0, __nv_bfloat16* stage,
                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int nu = (s + 31) >> 5;
  float rx[kPerLane], ry[kPerLane], rz[kPerLane], m[kPerLane];
  bool keep[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int slot = u * 32 + lane;
    const bool in = u < nu && slot < s;  // slots past s: zero offsets, masked out
    rx[u] = in ? gx[slot] - px : 0.0f;
    ry[u] = in ? gy[slot] - py : 0.0f;
    rz[u] = in ? gz[slot] - pz : 0.0f;
    m[u] = in && mask[slot] ? 1.0f : 0.0f;
    keep[u] = m[u] > 0.0f;
  }
  float o0[kPerLane], o1[kPerLane], o2[kPerLane];
  masked_lrf(rx, ry, rz, m, nu, r_lrf, inv_r, o0, o1, o2);
  staged_pool(rx, ry, rz, o0, o1, o2, keep, nu, W0, B0, stage, out);
}

__global__ void __launch_bounds__(kThreads)
pe_masked_kernel(const float* __restrict__ g1x, const float* __restrict__ g1y, const float* __restrict__ g1z,
                 const uint8_t* __restrict__ m1, const float* __restrict__ g2x, const float* __restrict__ g2y,
                 const float* __restrict__ g2z, const uint8_t* __restrict__ m2, const float* __restrict__ cx,
                 const float* __restrict__ cy, const float* __restrict__ cz, const __nv_bfloat16* __restrict__ wpack,
                 const float* __restrict__ bpack, float* __restrict__ out, long long points, int s1, int s2, float r1,
                 float r2, float inv_r1, float inv_r2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  __nv_bfloat16* s_stage = reinterpret_cast<__nv_bfloat16*>(s_b + 2 * kBScale);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  __nv_bfloat16* stage = s_stage + warp * kMaxSlots * kRow;
  for (long long pt = (long long)blockIdx.x * kWarps + warp; pt < points; pt += (long long)gridDim.x * kWarps) {
    const float px = cx[pt], py = cy[pt], pz = cz[pt];
    pe_scale(g1x + pt * s1, g1y + pt * s1, g1z + pt * s1, m1 + pt * s1, s1, px, py, pz, r1, inv_r1, s_w, s_b,
             stage, out + pt * 256);
    pe_scale(g2x + pt * s2, g2y + pt * s2, g2z + pt * s2, m2 + pt * s2, s2, px, py, pz, r2, inv_r2, s_w + kWScale,
             s_b + kBScale, stage, out + pt * 256 + 128);
  }
}

}  // namespace

// grouped planes (B, P, S1) and (B, P, S2) float32, masks of the same shapes
// (one byte), centres (B, P); wpack / bpack: both scales' weights as
// ops/pe_fused.py:pack_mlp lays them out (2 x kWScale bf16, 2 x kBScale float32)
extern "C" int unopose_pe_masked(const float* g1x, const float* g1y, const float* g1z, const void* m1,
                                 const float* g2x, const float* g2y, const float* g2z, const void* m2,
                                 const float* cx, const float* cy, const float* cz, const void* wpack,
                                 const float* bpack, float* out, long long points, int s1, int s2, float r1, float r2,
                                 float inv_r1, float inv_r2, cudaStream_t stream) {
  if (s1 <= 0 || s2 <= 0 || s1 > kMaxSlots || s2 > kMaxSlots) return (int)cudaErrorInvalidValue;
  if (points == 0) return 0;
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      (size_t)kWarps * kMaxSlots * kRow * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(pe_masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_masked_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (points + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_masked_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      g1x, g1y, g1z, static_cast<const uint8_t*>(m1), g2x, g2y, g2z, static_cast<const uint8_t*>(m2), cx, cy, cz,
      static_cast<const __nv_bfloat16*>(wpack), bpack, out, points, s1, s2, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}
