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
// cloud in permuted order in shared memory, a chunk of whole candidates
// (kChunkPoints points, 48 KB) at a time, so any N divisible by S fits: the
// whole cloud in one chunk up to N = 4096, two chunks at N = 8192. Each
// thread owns (centre, slot) pairs: it scans its slot's candidates of the
// chunk in order, writes the pair's outputs at the first hit and, where
// there are several chunks, marks the pair done (a byte in shared memory)
// so that later chunks skip it; in the
// last chunk a pair with no hit takes candidate 0, whose coordinates (the
// first S permuted points) stay in shared memory beside the chunks.
// Neighbouring threads hold neighbouring slots of one centre, so the
// candidate reads are conflict-free and the stores coalesce along S.
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
constexpr int kChunkPoints = 4096;    // permuted points staged at a time (a multiple of S where S <= 4096)

__global__ void __launch_bounds__(kThreads)
ball_group_subset_kernel(const float* __restrict__ pts, const int* __restrict__ perm, float* __restrict__ gx,
                         float* __restrict__ gy, float* __restrict__ gz, float* __restrict__ d2_out,
                         uint8_t* __restrict__ valid, int n, int s, int chunk_groups, int centres_per_block,
                         int centre_blocks, float r2) {
  const int chunk = chunk_groups * s;                      // points of one chunk
  extern __shared__ float s_cloud[];                       // x, y, z planes of one chunk, chunk each
  float* s_first = s_cloud + 3 * chunk;                    // x, y, z planes of candidate 0, s each
  uint8_t* s_done = reinterpret_cast<uint8_t*>(s_first + 3 * s);  // several chunks: per pair, hit found
  const int b = blockIdx.x / centre_blocks;
  const int p0 = (blockIdx.x % centre_blocks) * centres_per_block;
  const float* cloud = pts + (size_t)b * n * 3;
  const int g_count = n / s;
  const int p_end = min(p0 + centres_per_block, n);
  const int items = (p_end - p0) * s;
  const bool chunked = chunk_groups < g_count;
  if (chunked) {
    for (int it = threadIdx.x; it < items; it += kThreads) s_done[it] = 0;  // each pair stays with its thread
  }
  for (int j = threadIdx.x; j < s; j += kThreads) {
    const int q = perm[j];
    s_first[j] = cloud[3 * q];
    s_first[s + j] = cloud[3 * q + 1];
    s_first[2 * s + j] = cloud[3 * q + 2];
  }

  for (int g0 = 0; g0 < g_count; g0 += chunk_groups) {
    const int g1 = min(g0 + chunk_groups, g_count);
    const int c0 = g0 * s, c1 = g1 * s;
    __syncthreads();  // the previous chunk is scanned
    for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
      const int q = perm[j];
      s_cloud[j - c0] = cloud[3 * q];
      s_cloud[chunk + j - c0] = cloud[3 * q + 1];
      s_cloud[2 * chunk + j - c0] = cloud[3 * q + 2];
    }
    __syncthreads();
    const bool last = g1 == g_count;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      if (chunked && s_done[it]) continue;
      const int p = p0 + it / s;
      const int slot = it % s;
      const float cx = cloud[3 * p], cy = cloud[3 * p + 1], cz = cloud[3 * p + 2];
      // a pair with no hit takes candidate 0 and a distance of 0
      float hx = s_first[slot], hy = s_first[s + slot], hz = s_first[2 * s + slot], hd = 0.0f;
      bool found = false;
      for (int g = g0; g < g1; ++g) {
        const int col = (g - g0) * s + slot;
        const float xg = s_cloud[col], yg = s_cloud[chunk + col], zg = s_cloud[2 * chunk + col];
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
      if (found || last) {
        const size_t o = ((size_t)b * n + p) * s + slot;
        gx[o] = hx;
        gy[o] = hy;
        gz[o] = hz;
        d2_out[o] = hd;
        valid[o] = found ? 1 : 0;
        if (chunked) s_done[it] = 1;
      }
    }
  }
}

}  // namespace

// pts (B, N, 3) float32, perm (N) int32; five (B, N, S) outputs; r2 = radius^2
extern "C" int unopose_ball_group_subset(const float* pts, const int* perm, float* gx, float* gy, float* gz,
                                         float* d2, void* valid, int batch, int n, int s, float r2,
                                         cudaStream_t stream) {
  if (s <= 0 || n % s != 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  const int chunk_groups = max(1, min(n / s, kChunkPoints / s));
  const int centres_per_block = max(1, min(n, kItemsPerBlock / s));
  const bool chunked = chunk_groups < n / s;
  const size_t smem = (size_t)3 * (chunk_groups + 1) * s * sizeof(float) + (chunked ? (size_t)centres_per_block * s : 0);
  cudaError_t err =
      cudaFuncSetAttribute(ball_group_subset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int centre_blocks = (n + centres_per_block - 1) / centres_per_block;
  ball_group_subset_kernel<<<(unsigned)(batch * centre_blocks), kThreads, smem, stream>>>(
      pts, perm, gx, gy, gz, d2, static_cast<uint8_t*>(valid), n, s, chunk_groups, centres_per_block,
      centre_blocks, r2);
  return (int)cudaGetLastError();
}
