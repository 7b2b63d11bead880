// Fine-PE channels: per point, gather its neighbourhood slots' coordinates,
// compute the two scales' weighted local reference frames and store the 12
// channels (rel xyz, LRF-1 xyz, rel xyz, LRF-2 xyz) of every slot as bf16.
//
// Replaces the TPU kernel A of unopose_tpu/ops/pe_fused.py:pe_fused_v5
// (_pe_kernel_channels_t with _masked_lrf_block_t). The TPU kernel gathers
// from 128-lane banks of the permuted planes (Mosaic's lane gather reaches
// one vreg), lays slots on sublanes and points on lanes, and picks a
// 64/128/256-slot tier per block of 128 points. Here a block stages its
// cloud's three permuted planes in shared memory (24 KB at N = 2048) and
// one warp owns one point at a time: its lanes hold slots lane, lane + 32,
// ... in registers, the moment, vote and x-axis sums are warp butterfly
// reductions (every lane ends with the same bits), and the eigenvector is
// the acos-free Newton trisection of the JAX kernel. The tier is per point:
// 64 * ceil(total2 / 64) slots (at least 64), since slots past total2 carry
// weight 0 in both scales and dropping exact-zero terms leaves every sum
// unchanged. Only those slots are written; the MLP kernel
// (pe_mlp_pool.cu) reads exactly those.
//
// Layout (B, P, S2, 12) bf16, point-major with a slot's 12 channels
// together: a lane writes its slot's 24 bytes as three 8-byte stores, and
// the MLP kernel reads a 16-slot row tile of one scale as the A operand of
// its tensor-core product with no transpose.
//
// Bound: bytes. Per needed slot it reads 2 index + 4 weight bytes and writes
// 24 (~126 MB at B = 32, N = 2048 and one 64-slot tier per point, ~0.04 ms
// at 3.35 TB/s), against ~150 float32 operations per slot (~0.01 ms).
//
// Arithmetic follows the plain version (ops/pe_fused.py:pe_channels_plain,
// via ops/lrf.py:batch_lrf_planar and ops/eig3.py with use_newton) operation
// by operation, each rounded on its own (-fmad=false); only the order of the
// slot sums differs. The per-point work (point_channels, with masked_lrf) is
// pe_common.cuh's, shared with pe_gather_fused.cu (K21).

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointsPerBlock = 64;
constexpr int kMaxN = 4096;

__global__ void __launch_bounds__(kThreads)
pe_channels_kernel(const float* __restrict__ xp, const float* __restrict__ yp, const float* __restrict__ zp,
                   const int16_t* __restrict__ idx, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2, const int* __restrict__ total2,
                   const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
                   __nv_bfloat16* __restrict__ out, int n, int np, int s2, int point_blocks, float r1,
                   float r2, float inv_r1, float inv_r2) {
  extern __shared__ float s_planes[];  // x, y, z planes of the cloud, n each
  const int b = blockIdx.x / point_blocks;
  const int p0 = (blockIdx.x % point_blocks) * kPointsPerBlock;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    s_planes[j] = xp[(size_t)b * n + j];
    s_planes[n + j] = yp[(size_t)b * n + j];
    s_planes[2 * n + j] = zp[(size_t)b * n + j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int p_end = min(p0 + kPointsPerBlock, np);
  for (int p = p0 + warp; p < p_end; p += kWarps) {
    const size_t pt = (size_t)b * np + p;
    const int chunks = max(1, min((total2[pt] + 63) >> 6, s2 >> 6));
    const int nu = 2 * chunks;  // slots per lane
    point_channels<kPerLane>(s_planes, n, idx + pt * s2, w1 + pt * s2, w2 + pt * s2, nu, cx[pt], cy[pt], cz[pt], r1,
                             r2, inv_r1, inv_r2, out + pt * s2 * 12);
  }
}

}  // namespace

extern "C" int unopose_pe_channels(const float* xp, const float* yp, const float* zp, const int16_t* idx,
                                   const void* w1, const void* w2, const int* total2, const float* cx,
                                   const float* cy, const float* cz, void* out, int batch, int n, int np,
                                   int s2, float r1, float r2, float inv_r1, float inv_r2,
                                   cudaStream_t stream) {
  if (n > kMaxN || s2 > kMaxSlots || s2 % 64 != 0 || s2 == 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || np == 0) return 0;
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pe_channels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int point_blocks = (np + kPointsPerBlock - 1) / kPointsPerBlock;
  pe_channels_kernel<<<(unsigned)(batch * point_blocks), kThreads, smem, stream>>>(
      xp, yp, zp, idx, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), total2,
      cx, cy, cz, static_cast<__nv_bfloat16*>(out), n, np, s2, point_blocks, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}
