// Fused geometric structure embedding: for every pair (i, j) of a cloud's
// points, the distance term plus the max over the k anchor angles, each read
// from a pre-projected table by a 3-point quadratic Lagrange stencil, written
// as symmetric per-channel int8 (the production embedding, quant_int8), or
// as float32 or bf16 values (quant_int8 off, in a float32 or bf16 model).
//
// Replaces the TPU kernel unopose_tpu/ops/geo_fused.py:geo_rpe_fused
// (_geo_kernel). The TPU has no fast gather, so it evaluates each stencil as
// a dense (rows, T) @ (T, D) contraction of mostly zero weights. Here the
// three table rows are simply read from a channel tile of both tables that a
// block keeps in shared memory.
//
// Bound at B = 32, N = 197, D = 256: the (B, N, N, D) output is 318 MB as
// int8 (~0.1 ms at 3.35 TB/s), and ~25 float32 operations per output entry
// (~8 GFLOP, ~0.12 ms at 67 TFLOP/s). The arithmetic repeats the plain
// version one rounded operation at a time (~27 per entry, ~0.26 ms at the
// 128 lanes a clock of an SM), and every entry reads 3 (1 + k) table values
// from shared memory (~0.23 ms at 128 bytes a clock an SM with bf16 tables).
// With the widening of the bf16 table values, the clamps and the packing, a
// lane issues ~45 instructions per entry: ~0.43 ms. What the design does:
//  - bf16 tables in shared memory for the bf16 contraction where 256
//    divides D: the wrapper passes tables already rounded to bf16, so they
//    are held exactly in half the bytes (one 16-byte read is 8 channels of a
//    table row) and widened to float32 by a shift; otherwise float32 tables;
//  - a 256-channel tile (bf16: 128 KB of tables) and 24 warps on an SM, a
//    lane 8 channels, so a warp reads one (i, j) row of D = 256 in 16-byte
//    loads and stores 256 contiguous bytes, 8 a lane; float32 tables take
//    128-channel tiles of 4 channels a lane, D % 128 != 0 32-channel tiles;
//    the loop over the k angles is unrolled to kMaxK (the kernel is built
//    for k = 3, the model's, apart, where k is known at compile time), so a
//    lane's table reads of one entry are all in flight at once;
//  - no block barrier past the tables' load: a warp takes a unit of one row
//    i and 32 columns j, computes the 1 + k stencils of its columns, one per
//    lane, into its own shared buffer and, after a __syncwarp, evaluates
//    those columns reading the stencils back as broadcasts; the blocks stay
//    resident and walk the units (one wave, the tables loaded once a block).
//
// The float32 and bf16 stores (the JAX kernel's quantize=False output,
// e.astype(out_dtype)) share everything up to the store: one kernel,
// templated on the output type. A lane writes its kCh channels of an entry
// in 16-byte stores (float32: 4 channels a store; bf16: 8, or 4 as one
// 8-byte store in 32-channel tiles), so the lanes of a column write its
// tile's channels contiguously: 512 bytes a warp and column in the float32
// and bf16 layouts, 128 in 32-channel tiles. The output is then 4x (float32)
// or 2x (bf16) the int8 bytes: at 32 x 197 x 197 x 256 1.27 GB and 0.64 GB,
// 0.380 ms and 0.190 ms at 3.35 TB/s, past the int8 store's bound by
// operations; the float32 output takes the float32 contraction (float32
// tables of 128 channels), as the JAX kernel does.
//
// Rounding follows the plain version (ops/geo_fused.py:geo_rpe_fused_plain)
// step by step: the stencil weights are rounded to bf16 when the contraction
// dtype is bf16 (the wrapper passes tables already rounded), the products
// are exact in float32, the three terms are summed left to right with every
// operation rounded on its own (the library is built with -fmad=false), the
// int8 code is round-half-to-even (__float2int_rn, as jnp.round), and the
// bf16 value is the float32 sum rounded to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 768;
constexpr int kWarps = kThreads / 32;
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

__device__ __forceinline__ int quant(float e, float qs) {
  const int v = __float2int_rn(__fmul_rn(e, qs));
  return v < -127 ? -127 : (v > 127 ? 127 : v);
}

// the kCh channels of one entry: int8 codes round(v * qs), four to a 32-bit word
template <int kCh>
__device__ __forceinline__ void store(int8_t* dst, const float (&v)[kCh], const float (&qs)[kCh]) {
  uint32_t w[kCh / 4];
#pragma unroll
  for (int h = 0; h < kCh / 4; ++h) {
    uint32_t x = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) x |= (uint32_t)(quant(v[4 * h + c], qs[4 * h + c]) & 0xff) << (8 * c);
    w[h] = x;
  }
  if constexpr (kCh == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// float32 values as they are, 16 bytes a store
template <int kCh>
__device__ __forceinline__ void store(float* dst, const float (&v)[kCh], const float (&)[kCh]) {
#pragma unroll
  for (int h = 0; h < kCh / 4; ++h)
    reinterpret_cast<float4*>(dst)[h] = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}

// bf16 values rounded to nearest even, two to a 32-bit word, 8 or 16 bytes a store
template <int kCh>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&v)[kCh], const float (&)[kCh]) {
  uint32_t w[kCh / 2];
#pragma unroll
  for (int h = 0; h < kCh / 2; ++h) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
    w[h] = *reinterpret_cast<const uint32_t*>(&x);
  }
  if constexpr (kCh == 8) *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

// kCh channels of a table row, widened to float32: float32 rows as they are, bf16 rows by a shift (exact)
template <typename Tab, int kCh>
__device__ __forceinline__ void load_row(float (&v)[kCh], const Tab* p) {
  if constexpr (std::is_same_v<Tab, float>) {
    static_assert(kCh % 4 == 0, "float32 tables: 16-byte reads");
#pragma unroll
    for (int h = 0; h < kCh / 4; ++h) {
      const float4 x = reinterpret_cast<const float4*>(p)[h];
      v[4 * h] = x.x, v[4 * h + 1] = x.y, v[4 * h + 2] = x.z, v[4 * h + 3] = x.w;
    }
  } else {
    static_assert(kCh == 4 || kCh == 8, "bf16 tables: 4 or 8 channels a lane");
    uint32_t w[kCh / 2];
    if constexpr (kCh == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x, w[1] = x.y;
    }
#pragma unroll
    for (int h = 0; h < kCh / 2; ++h) {
      v[2 * h] = __uint_as_float(w[h] << 16);
      v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
    }
  }
}

// four float32 table values into a shared tile, as they are or as bf16 (exact: they are bf16 values)
template <typename Tab>
__device__ __forceinline__ void store4(Tab* dst, float4 x) {
  if constexpr (std::is_same_v<Tab, float>) {
    *reinterpret_cast<float4*>(dst) = x;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// kCh channels of one table at one stencil; tab is the lane's first channel of table row 0, rows kTile apart
template <typename Tab, int kTile, int kCh>
__device__ __forceinline__ void eval(float (&out)[kCh], const Tab* tab, float4 st) {
  const int q = __float_as_int(st.w);
  float tm[kCh], t0[kCh], tp[kCh];
  load_row<Tab, kCh>(tm, tab + (q - 1) * kTile);
  load_row<Tab, kCh>(t0, tab + q * kTile);
  load_row<Tab, kCh>(tp, tab + (q + 1) * kTile);
#pragma unroll
  for (int c = 0; c < kCh; ++c) out[c] = lagrange(st.x, st.y, st.z, tm[c], t0[c], tp[c]);
}

// Out: int8_t (codes), float or __nv_bfloat16 (values)
template <typename Out>
struct Args {
  const float* pts;      // (batch, n, 3)
  const float* ref_vec;  // (batch, n, k, 3)
  const float* tab_d;    // (T, D), rounded to the contraction dtype
  const float* tab_a;
  const float* qscale;   // (D), read by the int8 store alone
  Out* out;              // (batch, n, n, D)
  int batch, n, k, T, D, bf16_weights;
  float sd, sa, factor_a;
};

// the 1 + k stencils of the pair (i, j) of cloud b (distance, then the angle of each anchor), at st[s * stride]
template <typename Out>
__device__ __forceinline__ void stencils(float4* st, int stride, const Args<Out>& p, int b, int i, int j) {
  const float* cloud = p.pts + (size_t)b * p.n * 3;
  const float* anchors = p.ref_vec + ((size_t)b * p.n + i) * p.k * 3;
  const float tmax = static_cast<float>(p.T - 1), qmax = static_cast<float>(p.T - 2);
  const float ax = cloud[3 * j] - cloud[3 * i];  // p_j - p_i
  const float ay = cloud[3 * j + 1] - cloud[3 * i + 1];
  const float az = cloud[3 * j + 2] - cloud[3 * i + 2];
  const float d = sqrtf((ax * ax + ay * ay) + az * az);
  st[0] = stencil(d * p.sd, tmax, qmax, p.bf16_weights);
  for (int kk = 0; kk < p.k; ++kk) {
    const float vx = anchors[3 * kk], vy = anchors[3 * kk + 1], vz = anchors[3 * kk + 2];
    const float cxp = vy * az - vz * ay;
    const float cyp = vz * ax - vx * az;
    const float czp = vx * ay - vy * ax;
    const float sin_v = sqrtf((cxp * cxp + cyp * cyp) + czp * czp);
    float cos_v = (vx * ax + vy * ay) + vz * az;
    if (sin_v == 0.0f && cos_v == 0.0f) cos_v = 1.0f;  // degenerate anchor: angle 0
    const float a_idx = atan2_pos_sin(sin_v, cos_v) * p.factor_a;
    st[(1 + kk) * stride] = stencil(a_idx * p.sa, tmax, qmax, p.bf16_weights);
  }
}

// one entry (i, j) at the lane's kCh channels: the distance term plus the max over the k angles, stored as
// Out; st holds its stencils at st[s * stride]
template <typename Tab, int kTile, int kCh, typename Out>
__device__ __forceinline__ void entry(Out* dst, const Tab* tab_d, const Tab* tab_a, const float4* st, int stride,
                                      int k, const float (&qs)[kCh]) {
  float e[kCh], ea[kCh];
  eval<Tab, kTile, kCh>(e, tab_d, st[0]);
  eval<Tab, kTile, kCh>(ea, tab_a, st[stride]);
#pragma unroll
  for (int kk = 1; kk < kMaxK; ++kk) {
    if (kk >= k) break;
    float ek[kCh];
    eval<Tab, kTile, kCh>(ek, tab_a, st[(1 + kk) * stride]);
#pragma unroll
    for (int c = 0; c < kCh; ++c) ea[c] = fmaxf(ea[c], ek[c]);
  }
#pragma unroll
  for (int c = 0; c < kCh; ++c) e[c] = e[c] + ea[c];
  store<kCh>(dst, e, qs);
}

// kTile channels per block, kCh per lane: a warp covers 32 kCh / kTile columns j at a time; kK: the
// angle count where it is fixed at compile time (3, the model's), or kMaxK for any k read from p
template <typename Tab, int kTile, int kCh, int kK, typename Out>
__global__ void __launch_bounds__(kThreads) geo_rpe_kernel(const Args<Out> p) {
  constexpr int kLanesPerCol = kTile / kCh;
  constexpr int kColsPerStep = 32 / kLanesPerCol;
  static_assert(kLanesPerCol <= 32 && 32 % kLanesPerCol == 0, "a column's channels within one warp");
  extern __shared__ float4 smem[];
  Tab* s_tab_d = reinterpret_cast<Tab*>(smem);  // (T, kTile) values of the distance table
  Tab* s_tab_a = s_tab_d + p.T * kTile;          // and of the angle table
  float4* s_st = reinterpret_cast<float4*>(s_tab_a + p.T * kTile);  // kWarps x (1 + k) x 32 stencils
  const int c0 = blockIdx.y * kTile, n = p.n, k = kK < kMaxK ? kK : p.k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = lane % kLanesPerCol;  // this lane's channels: c0 + cl * kCh onwards
  for (int idx = threadIdx.x; idx < p.T * (kTile / 4); idx += kThreads) {
    const size_t src = (size_t)(idx / (kTile / 4)) * p.D + c0 + 4 * (idx % (kTile / 4));
    store4(s_tab_d + 4 * idx, *reinterpret_cast<const float4*>(p.tab_d + src));
    store4(s_tab_a + 4 * idx, *reinterpret_cast<const float4*>(p.tab_a + src));
  }
  float qs[kCh];  // the int8 store's scales (0 for the value stores, which do not read them)
#pragma unroll
  for (int c = 0; c < kCh; ++c) qs[c] = std::is_same_v<Out, int8_t> ? p.qscale[c0 + cl * kCh + c] : 0.0f;
  const Tab* tab_d = s_tab_d + cl * kCh;
  const Tab* tab_a = s_tab_a + cl * kCh;
  __syncthreads();

  // units of one row i and 32 columns j, walked by the warps of all blocks
  float4* st = s_st + warp * (1 + k) * 32;
  const int chunks = (n + 31) / 32;
  const long long units = (long long)p.batch * n * chunks;
  for (long long u = (long long)blockIdx.x * kWarps + warp; u < units; u += (long long)gridDim.x * kWarps) {
    const long long bi = u / chunks;  // b * n + i
    const int j0 = (int)(u % chunks) * 32, cols = min(32, n - j0);
    __syncwarp();  // the previous unit's stencils are read
    if (lane < cols) stencils(st + lane, 32, p, (int)(bi / n), (int)(bi % n), j0 + lane);
    __syncwarp();
    Out* row = p.out + ((size_t)bi * n + j0) * p.D + c0 + cl * kCh;
    for (int jj = lane / kLanesPerCol; jj < cols; jj += kColsPerStep)
      entry<Tab, kTile, kCh>(row + (size_t)jj * p.D, tab_d, tab_a, st + jj, 32, k, qs);
  }
}

// one block an SM's worth of blocks (each loads its tables once), no more than the units need
template <typename Tab, int kTile, int kCh, typename Out>
int launch(const Args<Out>& p, cudaStream_t stream) {
  const size_t smem = (size_t)2 * p.T * kTile * sizeof(Tab) + (size_t)kWarps * (1 + p.k) * 32 * sizeof(float4);
  const auto kernel = p.k == 3 ? geo_rpe_kernel<Tab, kTile, kCh, 3, Out> : geo_rpe_kernel<Tab, kTile, kCh, kMaxK, Out>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = p.D / kTile;
  const long long units = (long long)p.batch * p.n * ((p.n + 31) / 32);
  const long long blocks = std::min((units + kWarps - 1) / kWarps, (long long)std::max(1, sms * per_sm / tiles));
  kernel<<<dim3((unsigned)blocks, (unsigned)tiles), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the tile layout by width and contraction dtype, whatever the store
template <typename Out>
int dispatch(const Args<Out>& p, cudaStream_t stream) {
  if (p.n > kMaxN || p.k < 1 || p.k > kMaxK || p.T < 3 || p.T > kMaxT || p.D % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.batch == 0 || p.n == 0) return 0;
  const int D = p.D, bf16_weights = p.bf16_weights;
  if (D % 128 != 0) return launch<float, 32, 4>(p, stream);  // narrow test widths
  if (bf16_weights && D % 256 == 0) return launch<__nv_bfloat16, 256, 8>(p, stream);
  return launch<float, 128, 4>(p, stream);
}

}  // namespace

// out: (batch, n, n, D) int8 codes round(e * qscale); bf16_weights: round the
// stencil weights to bf16 (the contraction dtype of a bf16 model; the tables
// then hold bf16 values)
extern "C" int unopose_geo_rpe(const float* pts, const float* ref_vec, const float* tab_d,
                               const float* tab_a, const float* qscale, int8_t* out, int batch, int n,
                               int k, int T, int D, int bf16_weights, float sd, float sa, float factor_a,
                               cudaStream_t stream) {
  if (qscale == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(Args<int8_t>{pts, ref_vec, tab_d, tab_a, qscale, out, batch, n, k, T, D, bf16_weights, sd, sa,
                               factor_a}, stream);
}

// out: (batch, n, n, D) values: bf16 with out_bf16, and then the bf16
// contraction (the tables hold bf16 values), else float32 with the float32
// contraction, as the JAX kernel picks the contraction dtype by the output's
extern "C" int unopose_geo_rpe_values(const float* pts, const float* ref_vec, const float* tab_d,
                                      const float* tab_a, void* out, int batch, int n, int k, int T, int D,
                                      int out_bf16, float sd, float sa, float factor_a, cudaStream_t stream) {
  if (out_bf16) {
    return dispatch(Args<__nv_bfloat16>{pts, ref_vec, tab_d, tab_a, nullptr, static_cast<__nv_bfloat16*>(out),
                                        batch, n, k, T, D, 1, sd, sa, factor_a}, stream);
  }
  return dispatch(Args<float>{pts, ref_vec, tab_d, tab_a, nullptr, static_cast<float*>(out), batch, n, k, T, D, 0,
                              sd, sa, factor_a}, stream);
}
