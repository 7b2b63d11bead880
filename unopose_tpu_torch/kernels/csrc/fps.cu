// Furthest point sampling, one thread block per cloud.
//
// Replaces the TPU kernel unopose_tpu/ops/fps.py:fps_pallas (_fps_kernel).
// Semantics: start at index 0; every step lowers each point's running
// minimum squared distance to the selected set and picks the argmax, the
// smallest index winning ties (jnp.argmax / torch.argmax first occurrence).
//
// Bound: npoint - 1 dependent steps, each a pass over the cloud plus a
// block-wide reduction; the work per step is tiny, so the kernel is bound
// by the latency of the sequential steps and their two barriers, not by
// bytes or flops. The design keeps the coordinates and the running minima
// in shared memory (no device-memory traffic inside the loop) and does the
// reduction with warp shuffles, so one step costs two __syncthreads.
//
// Bitwise contract with the plain PyTorch version (ops/fps.py:fps_plain):
// the distance is ((dx*dx + dy*dy) + dz*dz) with each operation rounded on
// its own (__fmul_rn / __fadd_rn, and the file is built with -fmad=false),
// so no FMA contraction can flip a near-tie argmax.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFpsThreads = 512;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kFpsThreads)
fps_kernel(const float* __restrict__ pts, int n, int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  float* mind = zs + n;
  __shared__ float red_val[kFpsThreads / 32];
  __shared__ int red_idx[kFpsThreads / 32];
  __shared__ int s_last;

  const float* p = pts + (size_t)blockIdx.x * n * 3;
  int* o = out + (size_t)blockIdx.x * npoint;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xs[i] = p[3 * i];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
    mind[i] = 1e10f;
  }
  if (threadIdx.x == 0) {
    o[0] = 0;
    s_last = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float x1 = xs[last], y1 = ys[last], z1 = zs[last];
    float best = -1.0f;
    int besti = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float dx = __fsub_rn(xs[i], x1);
      const float dy = __fsub_rn(ys[i], y1);
      const float dz = __fsub_rn(zs[i], z1);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > best) {  // indices ascend within a thread: strict > keeps the first
        best = m;
        besti = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      better(best, besti, __shfl_down_sync(0xffffffffu, best, off), __shfl_down_sync(0xffffffffu, besti, off));
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_val[lane] : -1.0f;
      besti = lane < nwarps ? red_idx[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        better(best, besti, __shfl_down_sync(0xffffffffu, best, off), __shfl_down_sync(0xffffffffu, besti, off));
      }
      if (lane == 0) {
        s_last = besti;
        o[j] = besti;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

extern "C" int unopose_fps(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  const size_t smem = (size_t)4 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<batch, kFpsThreads, smem, stream>>>(pts, n, npoint, out);
  return (int)cudaGetLastError();
}
