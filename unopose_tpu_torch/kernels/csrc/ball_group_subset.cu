// Subset-mode ball grouping of the fine PE: around every point of a cloud,
// slot s of S takes the first candidate g in 0..G-1 (G = N / S) whose
// permuted column g * S + s lies strictly within the radius. Outputs, each
// (B, N, S): the neighbour's x, y, z and squared distance (float32) and the
// slot's validity (one byte); a slot with no hit holds candidate 0 and a
// distance of 0, as the TPU kernel leaves it.
//
// Replaces the TPU kernel unopose_tpu/ops/ball_query.py:
// ball_group_subset_pallas, which pre-splits the permuted cloud into a
// candidate-major (G, S) layout outside the kernel (Mosaic cannot reshape
// a (P, N) row into (P, G, S) with S < 128) and selects by a one-hot sum
// over the G candidates of a (p_blk, S) tile. Here a block stages its
// cloud in permuted order in shared memory (24 KB at N = 2048), and each
// thread owns one (centre, slot) pair: it scans its slot's G candidates in
// order and stops at the first hit. Neighbouring threads hold neighbouring
// slots of one centre, so the candidate reads are conflict-free and the
// five stores are coalesced along S.
//
// Bound: bytes. Per (centre, slot) it writes 4 x 4 + 1 bytes (~285 MB at
// B = 32, N = 2048, S = 256; ~71 MB at S = 64), against at most G distance
// evaluations of 8 float32 operations each.
//
// The distance is the TPU kernel's, direct differences of centre minus
// candidate, dx * dx + dy * dy + dz * dz, in the form XLA contracts it to
// (the JAX kernel in interpret mode computes this): fma(dz, dz, fma(dx, dx,
// dy * dy)), written out with __fmaf_rn since the build passes -fmad=false.
// The plain version (ops/ball_query.py:subset_sqdist) forms each fused
// operation in float64: the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerBlock = 8192;  // (centre, slot) pairs a block covers
constexpr int kMaxN = 4096;

__global__ void __launch_bounds__(kThreads)
ball_group_subset_kernel(const float* __restrict__ pts, const int* __restrict__ perm, float* __restrict__ gx,
                         float* __restrict__ gy, float* __restrict__ gz, float* __restrict__ d2_out,
                         uint8_t* __restrict__ valid, int n, int s, int centres_per_block, int centre_blocks,
                         float r2) {
  extern __shared__ float s_cloud[];  // x, y, z planes of the permuted cloud, n each
  const int b = blockIdx.x / centre_blocks;
  const int p0 = (blockIdx.x % centre_blocks) * centres_per_block;
  const float* cloud = pts + (size_t)b * n * 3;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int q = perm[j];
    s_cloud[j] = cloud[3 * q];
    s_cloud[n + j] = cloud[3 * q + 1];
    s_cloud[2 * n + j] = cloud[3 * q + 2];
  }
  __syncthreads();

  const int g_count = n / s;
  const int p_end = min(p0 + centres_per_block, n);
  const int items = (p_end - p0) * s;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int p = p0 + it / s;
    const int slot = it % s;
    const float cx = cloud[3 * p], cy = cloud[3 * p + 1], cz = cloud[3 * p + 2];
    float hx = s_cloud[slot], hy = s_cloud[n + slot], hz = s_cloud[2 * n + slot], hd = 0.0f;
    bool found = false;
    for (int g = 0; g < g_count; ++g) {
      const int col = g * s + slot;
      const float xg = s_cloud[col], yg = s_cloud[n + col], zg = s_cloud[2 * n + col];
      const float dx = cx - xg, dy = cy - yg, dz = cz - zg;
      const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, dy * dy));
      if (d2 < r2) {
        hx = xg;
        hy = yg;
        hz = zg;
        hd = d2;
        found = true;
        break;
      }
    }
    const size_t o = ((size_t)b * n + p) * s + slot;
    gx[o] = hx;
    gy[o] = hy;
    gz[o] = hz;
    d2_out[o] = hd;
    valid[o] = found ? 1 : 0;
  }
}

}  // namespace

// pts (B, N, 3) float32, perm (N) int32; five (B, N, S) outputs; r2 = radius^2
extern "C" int unopose_ball_group_subset(const float* pts, const int* perm, float* gx, float* gy, float* gz,
                                         float* d2, void* valid, int batch, int n, int s, float r2,
                                         cudaStream_t stream) {
  if (n > kMaxN || s <= 0 || n % s != 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ball_group_subset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int centres_per_block = max(1, min(n, kItemsPerBlock / s));
  const int centre_blocks = (n + centres_per_block - 1) / centres_per_block;
  ball_group_subset_kernel<<<(unsigned)(batch * centre_blocks), kThreads, smem, stream>>>(
      pts, perm, gx, gy, gz, d2, static_cast<uint8_t*>(valid), n, s, centres_per_block, centre_blocks, r2);
  return (int)cudaGetLastError();
}
