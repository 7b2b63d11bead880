// Coarse hypothesis selection: per cloud b and hypothesis h, the observed
// points in the model frame TP = (pts1 - t_h) R_h, each one's squared
// distance to its nearest model point, and the w1-weighted sum of the
// distances, sum_r w1_r sqrt(min_m |tp_r - m|^2). The wrapper
// (ops/hyp_select.py) turns the sums into the scores sum(w1) / (sum + 1e-8).
// Two modes of one kernel:
//
//   mode 0 (unopose_tpu/ops/hyp_select.py: hypothesis_select_scores): TP in
//       the block from bf16(pts1 - t) and bf16(R), the three products
//       (exact in float32) added in order, as the TPU kernel computes it;
//   mode 1 (unopose_tpu/ops/hyp_select2.py: hypothesis_select_scores_v2):
//       TP read, (B, P2, N1, 3) float32, from the caller's float32 product.
//
// The TPU kernels evaluate d^2 as |x|^2 - 2 x.y + |y|^2 on the matrix unit
// with a bf16x3 cross term, which guards that expansion against
// cancellation. Here d^2 is the direct difference (dx * dx + dy * dy) +
// dz * dz in float32 (the build passes -fmad=false: no contraction), which
// has no cancellation to guard. No (B, P2, N1, N2) tensor exists: one block
// per cloud and tile of 8 hypotheses stages the model cloud in shared
// memory as float4 (x, y, z, 0), one 16-byte broadcast read per distance;
// each warp owns one hypothesis, its lanes the pts1 rows r = lane, lane +
// 32, ...; per row a running min over the model points, then the square
// root and the weight, added to the lane's sum in row order; the 32 lane
// sums are added by an xor butterfly (16, 8, 4, 2, 1), a fixed order that
// the plain twin repeats, so the two are equal bit for bit.
//
// Bound: operations. At B = 16, P2 = 300, N1 = N2 = 196, 1.84e8 distances
// of 9 float32 operations (3 differences, 3 products, 2 sums, a min): 0.025
// ms at 67 TFLOP/s; the inputs are ~12 MB in mode 1 (TP) and < 0.1 MB in
// mode 0. Without fused multiply-adds every operation is its own
// instruction, so the issue rate allows about twice that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // hypotheses per block, one per warp
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int kMode>
__global__ void __launch_bounds__(kThreads)
hyp_select_kernel(const float* __restrict__ pts1, const float* __restrict__ rs, const float* __restrict__ ts,
                  const float* __restrict__ tp, const float* __restrict__ model, const float* __restrict__ w1,
                  float* __restrict__ dsum, int P2, int N1, int N2, int tiles) {
  extern __shared__ float4 smem[];
  float4* s_model = smem;          // N2
  float4* s_p1 = smem + N2;        // N1 (mode 0)
  float* s_w1 = reinterpret_cast<float*>(s_p1 + (kMode == 0 ? N1 : 0));  // N1
  const int b = blockIdx.x / tiles;
  const int h = (blockIdx.x % tiles) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const float* mb = model + (size_t)b * N2 * 3;
  for (int m = threadIdx.x; m < N2; m += kThreads) s_model[m] = make_float4(mb[3 * m], mb[3 * m + 1], mb[3 * m + 2], 0.0f);
  const float* pb = pts1 + (size_t)b * N1 * 3;
  for (int r = threadIdx.x; r < N1; r += kThreads) {
    if (kMode == 0) s_p1[r] = make_float4(pb[3 * r], pb[3 * r + 1], pb[3 * r + 2], 0.0f);
    s_w1[r] = w1[(size_t)b * N1 + r];
  }
  __syncthreads();
  if (h >= P2) return;

  const size_t bh = (size_t)b * P2 + h;
  float R[9], t[3];
  if (kMode == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = bf16_round(rs[bh * 9 + i]);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = ts[bh * 3 + i];
  }
  float acc = 0.0f;
  for (int r = lane; r < N1; r += 32) {
    float x, y, z;
    if (kMode == 0) {
      const float4 p = s_p1[r];
      const float a0 = bf16_round(p.x - t[0]), a1 = bf16_round(p.y - t[1]), a2 = bf16_round(p.z - t[2]);
      x = (a0 * R[0] + a1 * R[3]) + a2 * R[6];
      y = (a0 * R[1] + a1 * R[4]) + a2 * R[7];
      z = (a0 * R[2] + a1 * R[5]) + a2 * R[8];
    } else {
      const float* q = tp + (bh * N1 + r) * 3;
      x = q[0];
      y = q[1];
      z = q[2];
    }
    float mn = __int_as_float(0x7f800000);  // +inf
#pragma unroll 4
    for (int m = 0; m < N2; ++m) {
      const float4 q = s_model[m];
      const float dx = x - q.x, dy = y - q.y, dz = z - q.z;
      mn = fminf(mn, (dx * dx + dy * dy) + dz * dz);
    }
    acc += sqrtf(mn) * s_w1[r];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[bh] = acc;
}

}  // namespace

// pts1 (B, N1, 3), model (B, N2, 3), w1 (B, N1) float32; mode 0: rs (B, P2, 3, 3), ts (B, P2, 3); mode 1:
// tp (B, P2, N1, 3). Writes dsum (B, P2). A model cloud too large for a block's shared memory fails in
// cudaFuncSetAttribute, whose error is returned.
extern "C" int unopose_hyp_select(const float* pts1, const float* rs, const float* ts, const float* tp,
                                  const float* model, const float* w1, float* dsum, int B, int P2, int N1, int N2,
                                  int mode, cudaStream_t stream) {
  if (B <= 0 || P2 <= 0 || N1 <= 0 || N2 <= 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)N2 * sizeof(float4) + (mode == 0 ? (size_t)N1 * sizeof(float4) : 0) +
                      (size_t)N1 * sizeof(float);
  const auto kernel = mode == 0 ? hyp_select_kernel<0> : hyp_select_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no sticky error for the next launch
    return (int)err;
  }
  const int tiles = (P2 + kWarps - 1) / kWarps;
  kernel<<<(unsigned)(B * tiles), kThreads, smem, stream>>>(pts1, rs, ts, tp, model, w1, dsum, P2, N1, N2, tiles);
  return (int)cudaGetLastError();
}
