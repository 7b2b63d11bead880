// Planar neighbour gather: out_c[b, p, s] = plane_c[b, idx[b, p, s]] for
// the three coordinate planes c = x, y, z.
//
// Replaces the TPU kernel unopose_tpu/ops/gather_pallas.py:gather_planar
// (_kernel), which decomposes each source row into 128-lane banks because
// Mosaic's lane gather is limited to one vreg. On Hopper a thread simply
// loads its element: the (B, N) planes (8 KB per cloud and plane at
// N = 2048) stay in L1/L2, so the kernel is bound by the 12 bytes it writes
// and the 2 or 4 it reads per output element. A grid-stride loop over the
// flattened output keeps neighbouring threads on neighbouring addresses for
// the index reads and the three output writes.
//
// Indices are clamped to [0, N - 1], the "clip" mode of the JAX gather; in
// range they are returned bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Index>
__global__ void gather_planar_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                     const float* __restrict__ z, const Index* __restrict__ idx,
                                     float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
                                     int n, long long per_batch, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const long long b = t / per_batch;
    int i = (int)idx[t];
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    const size_t src = (size_t)b * n + i;
    ox[t] = x[src];
    oy[t] = y[src];
    oz[t] = z[src];
  }
}

}  // namespace

extern "C" int unopose_gather_planar(const float* x, const float* y, const float* z, const void* idx,
                                     int idx_bytes, float* ox, float* oy, float* oz, int batch, int n,
                                     long long per_batch, cudaStream_t stream) {
  const long long total = (long long)batch * per_batch;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  if (idx_bytes == 2) {
    gather_planar_kernel<int16_t><<<(unsigned)blocks, threads, 0, stream>>>(
        x, y, z, static_cast<const int16_t*>(idx), ox, oy, oz, n, per_batch, total);
  } else if (idx_bytes == 4) {
    gather_planar_kernel<int32_t><<<(unsigned)blocks, threads, 0, stream>>>(
        x, y, z, static_cast<const int32_t*>(idx), ox, oy, oz, n, per_batch, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
