// Fused geometric structure embedding: for every pair (i, j) of a cloud's
// points, the distance term plus the max over the k anchor angles, each read
// from a pre-projected table by a 3-point quadratic Lagrange stencil, written
// as symmetric per-channel int8 (the production embedding, quant_int8).
//
// Replaces the TPU kernel unopose_tpu/ops/geo_fused.py:geo_rpe_fused
// (_geo_kernel). The TPU has no fast gather, so it evaluates each stencil as
// a dense (rows, T) @ (T, D) contraction of mostly zero weights. Here the
// three table rows are simply read: a block keeps a 128-channel tile of both
// tables in shared memory (2 x T x 128 float32 = 128 KB at T = 128; 32-channel
// tiles when D is not a multiple of 128) and walks a group of rows i. Per
// row, its threads first compute the stencil (grid position, three weights)
// of every column j for the distance and the k angles into shared memory;
// then each warp takes one column j at a time (four with 32-channel tiles),
// each lane four channels, and forms (l_m T[q-1] + l_0 T[q]) + l_p T[q+1]
// from the tile, the max over k, the sum and the store.
//
// Bound: the (B, N, N, D) output, 318 MB as int8 at B = 32, N = 197,
// D = 256 (~0.1 ms at 3.35 TB/s), and ~25 float32 operations per output
// element (~8 GFLOP, ~0.12 ms at 67 TFLOP/s); the tables are re-read from
// L2 by every block (128 KB each). The kernel keeps every intermediate out
// of device memory and writes each output byte once, 4 bytes a lane.
//
// Rounding follows the plain version (ops/geo_fused.py:geo_rpe_fused_plain)
// step by step: the stencil weights are rounded to bf16 when the contraction
// dtype is bf16 (the wrapper passes tables already rounded), the products
// are exact in float32, the three terms are summed left to right with every
// operation rounded on its own (the library is built with -fmad=false), and
// the int8 code is round-half-to-even (__float2int_rn, as jnp.round).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 16;
constexpr int kMaxN = 512;  // ops/geo_fused.py:MAX_N
constexpr int kMaxK = 4;
constexpr int kMaxT = 128;

// constants are rounded from double, as the Python scalars of both versions are
constexpr float kHalfPi = static_cast<float>(3.14159265358979323846 / 2.0);
constexpr float kPi = static_cast<float>(3.14159265358979323846);

__device__ __forceinline__ float atan_poly01(float u) {
  const float u2 = u * u;
  float p = static_cast<float>(-0.005021087850713095);
  p = static_cast<float>(0.025331775490924545) + u2 * p;
  p = static_cast<float>(-0.06087457203230464) + u2 * p;
  p = static_cast<float>(0.10002210544512247) + u2 * p;
  p = static_cast<float>(-0.14047822793196393) + u2 * p;
  p = static_cast<float>(0.1997402878865833) + u2 * p;
  p = static_cast<float>(-0.33332232628435243) + u2 * p;
  p = static_cast<float>(0.9999999227777523) + u2 * p;
  return u * p;
}

// atan2(s, c) for s >= 0 without a branch on the quadrant (ops/geo_fused.py)
__device__ __forceinline__ float atan2_pos_sin(float s, float c) {
  const float ac = fabsf(c);
  const float lo = fminf(s, ac);
  const float hi = fmaxf(fmaxf(s, ac), static_cast<float>(1e-30));
  float a = atan_poly01(lo / hi);
  a = s > ac ? kHalfPi - a : a;
  return c < 0.0f ? kPi - a : a;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (l_m, l_0, l_p, q as int bits) of the centred quadratic stencil at grid position pos
__device__ __forceinline__ float4 stencil(float pos, float tmax, float qmax, bool bf16_weights) {
  pos = fminf(fmaxf(pos, 0.0f), tmax);
  float q = floorf(pos + 0.5f);
  q = fminf(fmaxf(q, 1.0f), qmax);
  const float r = pos - q;
  float lm = (0.5f * r) * (r - 1.0f);
  float l0 = 1.0f - r * r;
  float lp = (0.5f * r) * (r + 1.0f);
  if (bf16_weights) {
    lm = round_bf16(lm);
    l0 = round_bf16(l0);
    lp = round_bf16(lp);
  }
  return make_float4(lm, l0, lp, __int_as_float(static_cast<int>(q)));
}

__device__ __forceinline__ float lagrange(float lm, float l0, float lp, float tm, float t0, float tp) {
  return __fadd_rn(__fadd_rn(__fmul_rn(lm, tm), __fmul_rn(l0, t0)), __fmul_rn(lp, tp));
}

// four channels of one table at one stencil; tab4 is the (T, kTile) tile as float4
template <int kTile>
__device__ __forceinline__ float4 eval(const float4* tab4, float4 st, int c4) {
  const int q = __float_as_int(st.w);
  const float4 tm = tab4[(q - 1) * (kTile / 4) + c4];
  const float4 t0 = tab4[q * (kTile / 4) + c4];
  const float4 tp = tab4[(q + 1) * (kTile / 4) + c4];
  return make_float4(lagrange(st.x, st.y, st.z, tm.x, t0.x, tp.x), lagrange(st.x, st.y, st.z, tm.y, t0.y, tp.y),
                     lagrange(st.x, st.y, st.z, tm.z, t0.z, tp.z), lagrange(st.x, st.y, st.z, tm.w, t0.w, tp.w));
}

__device__ __forceinline__ int quant(float e, float qs) {
  const int v = __float2int_rn(__fmul_rn(e, qs));
  return v < -127 ? -127 : (v > 127 ? 127 : v);
}

// kTile channels per block, 4 per lane: a warp covers 128 / kTile columns j at a time
template <int kTile>
__global__ void __launch_bounds__(kThreads)
geo_rpe_kernel(const float* __restrict__ pts, const float* __restrict__ ref_vec,
               const float* __restrict__ tab_d, const float* __restrict__ tab_a,
               const float* __restrict__ qscale, int8_t* __restrict__ out, int n, int k, int T, int D,
               int bf16_weights, float sd, float sa, float factor_a, int row_groups) {
  extern __shared__ float4 smem[];
  float4* s_tab_d = smem;                          // (T, kTile) floats of the distance table
  float4* s_tab_a = smem + T * (kTile / 4);        // and of the angle table
  float4* s_st = smem + 2 * T * (kTile / 4);       // (1 + k, n) stencils of the current row

  const int b = blockIdx.x / row_groups;
  const int i0 = (blockIdx.x % row_groups) * kRowsPerBlock;
  const int c0 = blockIdx.y * kTile;
  constexpr int kLanesPerCol = kTile / 4;
  constexpr int kColsPerWarp = 32 / kLanesPerCol;
  const int lane = threadIdx.x & 31;
  const int c4 = lane % kLanesPerCol;  // this lane's 4 channels within the tile
  const int warp_col = (threadIdx.x >> 5) * kColsPerWarp + lane / kLanesPerCol;

  for (int idx = threadIdx.x; idx < T * (kTile / 4); idx += kThreads) {
    const size_t src = (size_t)(idx / (kTile / 4)) * D + c0 + 4 * (idx % (kTile / 4));
    s_tab_d[idx] = *reinterpret_cast<const float4*>(tab_d + src);
    s_tab_a[idx] = *reinterpret_cast<const float4*>(tab_a + src);
  }
  const float4 qs = *reinterpret_cast<const float4*>(qscale + c0 + 4 * c4);

  const float* cloud = pts + (size_t)b * n * 3;
  const float tmax = static_cast<float>(T - 1);
  const float qmax = static_cast<float>(T - 2);
  const int i_end = min(i0 + kRowsPerBlock, n);
  for (int i = i0; i < i_end; ++i) {
    __syncthreads();  // the tables are loaded and the previous row's stencils consumed
    const float pix = cloud[3 * i], piy = cloud[3 * i + 1], piz = cloud[3 * i + 2];
    const float* anchors = ref_vec + ((size_t)b * n + i) * k * 3;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float ax = cloud[3 * j] - pix;  // p_j - p_i
      const float ay = cloud[3 * j + 1] - piy;
      const float az = cloud[3 * j + 2] - piz;
      const float d = sqrtf((ax * ax + ay * ay) + az * az);
      s_st[j] = stencil(d * sd, tmax, qmax, bf16_weights);
      for (int kk = 0; kk < k; ++kk) {
        const float vx = anchors[3 * kk], vy = anchors[3 * kk + 1], vz = anchors[3 * kk + 2];
        const float cxp = vy * az - vz * ay;
        const float cyp = vz * ax - vx * az;
        const float czp = vx * ay - vy * ax;
        const float sin_v = sqrtf((cxp * cxp + cyp * cyp) + czp * czp);
        float cos_v = (vx * ax + vy * ay) + vz * az;
        if (sin_v == 0.0f && cos_v == 0.0f) cos_v = 1.0f;  // degenerate anchor: angle 0
        const float a_idx = atan2_pos_sin(sin_v, cos_v) * factor_a;
        s_st[(1 + kk) * n + j] = stencil(a_idx * sa, tmax, qmax, bf16_weights);
      }
    }
    __syncthreads();

    const size_t row = ((size_t)b * n + i) * n;
    for (int j = warp_col; j < n; j += kWarps * kColsPerWarp) {
      const float4 e = eval<kTile>(s_tab_d, s_st[j], c4);
      float4 ea = eval<kTile>(s_tab_a, s_st[n + j], c4);
      for (int kk = 1; kk < k; ++kk) {
        const float4 ek = eval<kTile>(s_tab_a, s_st[(1 + kk) * n + j], c4);
        ea = make_float4(fmaxf(ea.x, ek.x), fmaxf(ea.y, ek.y), fmaxf(ea.z, ek.z), fmaxf(ea.w, ek.w));
      }
      const float4 s = make_float4(e.x + ea.x, e.y + ea.y, e.z + ea.z, e.w + ea.w);
      const size_t o = (row + j) * D + c0 + 4 * c4;
      const uint32_t w = (uint32_t)(quant(s.x, qs.x) & 0xff) | ((uint32_t)(quant(s.y, qs.y) & 0xff) << 8) |
                         ((uint32_t)(quant(s.z, qs.z) & 0xff) << 16) | ((uint32_t)(quant(s.w, qs.w) & 0xff) << 24);
      *reinterpret_cast<uint32_t*>(out + o) = w;
    }
  }
}

template <int kTile>
int launch(const float* pts, const float* ref_vec, const float* tab_d, const float* tab_a, const float* qscale,
           int8_t* out, int batch, int n, int k, int T, int D, int bf16_weights, float sd, float sa,
           float factor_a, cudaStream_t stream) {
  const int row_groups = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = (size_t)2 * T * kTile * sizeof(float) + (size_t)(1 + k) * n * sizeof(float4);
  cudaError_t err =
      cudaFuncSetAttribute(geo_rpe_kernel<kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * row_groups), (unsigned)(D / kTile));
  geo_rpe_kernel<kTile><<<grid, kThreads, smem, stream>>>(pts, ref_vec, tab_d, tab_a, qscale, out, n, k, T, D,
                                                            bf16_weights, sd, sa, factor_a, row_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (batch, n, n, D) int8 codes round(e * qscale); bf16_weights: round the
// stencil weights to bf16 (the contraction dtype of a bf16 model)
extern "C" int unopose_geo_rpe(const float* pts, const float* ref_vec, const float* tab_d,
                               const float* tab_a, const float* qscale, int8_t* out, int batch, int n,
                               int k, int T, int D, int bf16_weights, float sd, float sa, float factor_a,
                               cudaStream_t stream) {
  if (n > kMaxN || k < 1 || k > kMaxK || T < 3 || T > kMaxT || D % 32 != 0 || qscale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n == 0) return 0;
  // 128-channel tiles at the model's widths; 32-channel tiles for narrow test widths
  return D % 128 == 0 ? launch<128>(pts, ref_vec, tab_d, tab_a, qscale, out, batch, n, k, T, D, bf16_weights,
                                    sd, sa, factor_a, stream)
                      : launch<32>(pts, ref_vec, tab_d, tab_a, qscale, out, batch, n, k, T, D, bf16_weights,
                                   sd, sa, factor_a, stream);
}
