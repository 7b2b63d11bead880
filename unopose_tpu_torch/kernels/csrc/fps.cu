// Furthest point sampling, one thread block per cloud.
//
// Replaces the TPU kernel unopose_tpu/ops/fps.py:fps_pallas (_fps_kernel).
// Semantics: start at index 0; every step lowers each point's running
// minimum squared distance to the selected set and picks the argmax, the
// smallest index winning ties (jnp.argmax / torch.argmax first occurrence).
//
// Bound: npoint - 1 dependent steps, each a pass over the cloud and a
// block-wide argmax; the work per step is small (at N = 5000 some 60 k
// float32 operations, about 0.25 us on one SM's 128 lanes), so a step's
// latency, not bytes or flops, bounds the kernel. What the design does
// about it:
//  - each thread holds its points i = tid + T u in registers (coordinates
//    and running minima; shared memory holds the cloud for the winner's
//    lookup): no shared-memory traffic in the distance loop. T = 256
//    threads up to N = 6144 (24 points a thread); past that 1024 threads,
//    their coordinates read from shared memory past 8 points a thread.
//    Fewer threads make the step's barrier and argmax cheaper, and a
//    cluster of CTAs exchanging keys through distributed shared memory
//    costs more than it spreads the work (tools/kernel_variants.py times
//    each; PERF.md gives the times on one H100);
//  - the argmax is a packed key: distances are >= 0, so their float bits
//    order as unsigned ints; a warp takes the largest bits with one
//    __reduce_max_sync and the smallest index among the points carrying
//    them with one __reduce_min_sync;
//  - one barrier a step: each warp's (bits, index) goes to a slot of the
//    step's parity, and after a single __syncthreads every warp reduces
//    all warps' slots itself (the parity keeps a fast warp's next write off a slot
//    a slow warp still reads). Only the last of a thread's points may lie
//    past N, so only it is tested.
//
// Bitwise contract with the plain PyTorch version (ops/fps.py:fps_plain):
// the distance is ((dx*dx + dy*dy) + dz*dz) with each operation rounded on
// its own (__fmul_rn / __fadd_rn, and the file is built with -fmad=false),
// so no FMA contraction can flip a near-tie argmax.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSmallT = 256;     // threads a cloud up to kSmallT * kSmallPer points
constexpr int kSmallPer = 24;    // points a thread then, coordinates in registers
constexpr int kLargeT = 1024;    // threads a larger cloud
constexpr int kLargePer = 15;    // N <= 15360 (the wrapper takes N <= 14528)
constexpr int kRegCoords = 8;    // past this many points a thread of a large cloud, coordinates from shared memory

template <int T, int PER>
__global__ void __launch_bounds__(T, 1)
fps_kernel(const float* __restrict__ pts, int n, int npoint, int* __restrict__ out) {
  constexpr int kThreads = T, kWarps = T / 32;
  constexpr bool kReg = T == kSmallT || PER <= kRegCoords;
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  __shared__ unsigned s_bits[2][kWarps];
  __shared__ int s_idx[2][kWarps];

  const float* p = pts + (size_t)blockIdx.x * n * 3;
  int* o = out + (size_t)blockIdx.x * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float px[kReg ? PER : 1], py[kReg ? PER : 1], pz[kReg ? PER : 1], md[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * kThreads;
    md[u] = 1e10f;
    if (i < n) {
      const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
      xs[i] = x;
      ys[i] = y;
      zs[i] = z;
      if constexpr (kReg) {
        px[u] = x;
        py[u] = y;
        pz[u] = z;
      }
    }
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float x1 = xs[last], y1 = ys[last], z1 = zs[last];
    float best = -1.0f;
    int besti = INT_MAX;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * kThreads;
      if (u < PER - 1 || i < n) {  // n > (PER - 1) * kThreads: only the last point may be missing
        float x, y, z;
        if constexpr (kReg) {
          x = px[u];
          y = py[u];
          z = pz[u];
        } else {
          x = xs[i];
          y = ys[i];
          z = zs[i];
        }
        const float dx = __fsub_rn(x, x1);
        const float dy = __fsub_rn(y, y1);
        const float dz = __fsub_rn(z, z1);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float m = fminf(md[u], d);
        md[u] = m;
        if (m > best) {  // indices ascend within a thread: strict > keeps the first
          best = m;
          besti = i;
        }
      }
    }
    // a thread with no point offers bits 0 and no index: any point's key (>= +0.0f) is at least as large,
    // and its index smaller
    unsigned bits = besti < n ? __float_as_uint(best) : 0u;
    unsigned top = __reduce_max_sync(0xffffffffu, bits);
    int idx = __reduce_min_sync(0xffffffffu, bits == top ? besti : INT_MAX);
    const int par = j & 1;
    if (lane == 0) {
      s_bits[par][warp] = top;
      s_idx[par][warp] = idx;
    }
    __syncthreads();
    bits = lane < kWarps ? s_bits[par][lane] : 0u;
    top = __reduce_max_sync(0xffffffffu, bits);
    idx = __reduce_min_sync(0xffffffffu, bits == top && lane < kWarps ? s_idx[par][lane] : INT_MAX);
    last = idx;
    if (tid == 0) o[j] = last;
  }
}

template <int T, int PER>
int launch(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<T, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<T, PER><<<batch, T, smem, stream>>>(pts, n, npoint, out);
  return (int)cudaGetLastError();
}

// the least PER from PER on with n <= T * PER
template <int T, int PER, int MAX>
int dispatch(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  if constexpr (PER > MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n <= PER * T) return launch<T, PER>(pts, out, batch, n, npoint, stream);
    return dispatch<T, PER + 1, MAX>(pts, out, batch, n, npoint, stream);
  }
}

}  // namespace

// pts (batch, n, 3) float32 -> out (batch, npoint) int32, 1 <= npoint <= n
extern "C" int unopose_fps(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || npoint < 1 || npoint > n) return (int)cudaErrorInvalidValue;
  if (n <= kSmallT * kSmallPer) return dispatch<kSmallT, 1, kSmallPer>(pts, out, batch, n, npoint, stream);
  return dispatch<kLargeT, kSmallPer * kSmallT / kLargeT + 1, kLargePer>(pts, out, batch, n, npoint, stream);
}
