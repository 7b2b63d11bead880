// Fused multi-head self-attention of the production ViT: per image and head,
// softmax(q k^T * hd^-0.5) v with float32 scores, the exact row max and sum
// over all keys, p / l rounded to v's dtype, a float32-accumulated P V, and
// the output in q's dtype. q, k and v are read in place from the (B, N, 3D)
// qkv output through their batch and row strides (heads packed along the
// features: columns h*hd .. h*hd+hd-1 of each are head h).
//
// Replaces the TPU kernel unopose_tpu/ops/vit_attn.py:_attn_kernel. The TPU
// runs one image per grid step with all heads' (261, 261) float32 scores in
// VMEM; here one head's (261, 261) score tile alone (272 KB) exceeds the
// 227 KB of shared memory a block may use. So one block takes one (image,
// head, 64-row query tile): 32 x 12 x 5 = 1920 blocks at the ViT-B main
// shape. The head's K rows and V transposed sit in shared memory (bf16,
// keys padded to a multiple of 16 with zeros, rows padded by 8 bf16 so the
// fragment loads are free of bank conflicts: 75 KB at N = 261, hd = 64).
// Each of the 4 warps owns 16 query rows, holds their Q fragments in
// registers and never stores a score: it runs S = Q K^T on mma.sync m16n8k16
// (bf16 operands, float32 accumulators) three times, once for the row max,
// once for the row sum of exp(s - max), once to form P = exp(s - max) / sum,
// packed to bf16 straight into the A fragments of O = P V. Recomputing S
// costs 2 N^2 hd operations per pass, which the tensor cores do far faster
// than the bytes arrive.
//
// Bound at the main shape (B = 32, N = 261, D = 768, 12 heads): bytes. q, k,
// v and o move 51.3 MB (15.3 us at 3.35 TB/s); the products are 6.7 GFLOP
// (6.8 us at 989 TFLOP/s), the recomputed ones not counted. The K and V
// slices are read once per query tile (5 times), from L2 after the first.
// This first version uses mma.sync without wgmma, TMA or a pipeline.
//
// float32 inputs (the tiny float32 configs) take a scalar variant with the
// same rounding points: one thread per query row, K and V in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps of 16 query rows
constexpr int kRows = 64;      // query rows per block

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Scores of this warp's 16 rows against keys nt*8 .. nt*8+7, scaled, with
// the keys past n at -inf: s[0], s[1] row g, keys 2t, 2t+1; s[2], s[3] row g+8.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[4], const uint32_t (&qa)[HD / 16][4], const __nv_bfloat16* sK,
                                       int nt, int n, float scale) {
  constexpr int kLdK = HD + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  s[0] = s[1] = s[2] = s[3] = 0.0f;
  const __nv_bfloat16* kr = sK + (nt * 8 + g) * kLdK + 2 * t;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) mma_bf16(s, qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = s[e] * scale;
  const int key = nt * 8 + 2 * t;
  if (key >= n) s[0] = s[2] = -INFINITY;
  if (key + 1 >= n) s[1] = s[3] = -INFINITY;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int n, long long sb,
                long long sn, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kLdK = HD + 8;
  constexpr int kVec = HD / 8;
  const int npad = (n + 15) & ~15;
  const int ldv = npad + 8;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [npad][HD + 8]
  __nv_bfloat16* sVt = sK + npad * kLdK;                       // [HD][npad + 8]
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const long long base = b * sb + (long long)h * HD;

  for (int i = threadIdx.x; i < npad * kVec; i += kThreads) {
    const int key = i / kVec, c = (i % kVec) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (key < n) {
      kv = *reinterpret_cast<const uint4*>(k + base + key * sn + c);
      vv = *reinterpret_cast<const uint4*>(v + base + key * sn + c);
    }
    *reinterpret_cast<uint4*>(sK + key * kLdK + c) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) sVt[(c + e) * ldv + key] = ve[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  if (row0 + warp * 16 >= n) return;  // no barrier follows

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = r0 < n ? ld32(q + base + r0 * sn + c) : 0u;
    qa[ks][1] = r1 < n ? ld32(q + base + r1 * sn + c) : 0u;
    qa[ks][2] = r0 < n ? ld32(q + base + r0 * sn + c + 8) : 0u;
    qa[ks][3] = r1 < n ? ld32(q + base + r1 * sn + c + 8) : 0u;
  }

  // pass 1: the exact row max over all keys
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int nt = 0; nt < npad / 8; ++nt) {
    float s[4];
    scores<HD>(s, qa, sK, nt, n, scale);
    m0 = fmaxf(m0, fmaxf(s[0], s[1]));
    m1 = fmaxf(m1, fmaxf(s[2], s[3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  // pass 2: the row sum of exp(s - max)
  float l0 = 0.0f, l1 = 0.0f;
  for (int nt = 0; nt < npad / 8; ++nt) {
    float s[4];
    scores<HD>(s, qa, sK, nt, n, scale);
    l0 = l0 + expf(s[0] - m0);
    l0 = l0 + expf(s[1] - m0);
    l1 = l1 + expf(s[2] - m1);
    l1 = l1 + expf(s[3] - m1);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 = l0 + __shfl_xor_sync(0xffffffffu, l0, off);
    l1 = l1 + __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // pass 3: P = exp(s - max) / sum in bf16, O = P V in float32
  float o[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  for (int kk = 0; kk < npad / 16; ++kk) {
    float sa[4], sc[4];
    scores<HD>(sa, qa, sK, 2 * kk, n, scale);
    scores<HD>(sc, qa, sK, 2 * kk + 1, n, scale);
    uint32_t pa[4];
    pa[0] = pack_bf16(expf(sa[0] - m0) / l0, expf(sa[1] - m0) / l0);
    pa[1] = pack_bf16(expf(sa[2] - m1) / l1, expf(sa[3] - m1) / l1);
    pa[2] = pack_bf16(expf(sc[0] - m0) / l0, expf(sc[1] - m0) / l0);
    pa[3] = pack_bf16(expf(sc[2] - m1) / l1, expf(sc[3] - m1) / l1);
    const __nv_bfloat16* vr = sVt + g * ldv + kk * 16 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) mma_bf16(o[nd], pa, ld32(vr + nd * 8 * ldv), ld32(vr + nd * 8 * ldv + 8));
  }
  const long long heads_d = gridDim.y * (long long)HD;  // D: the output is (B, N, D) contiguous
  __nv_bfloat16* orow = out + (long long)b * n * heads_d + (long long)h * HD + 2 * t;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    if (r0 < n) *reinterpret_cast<uint32_t*>(orow + r0 * heads_d + nd * 8) = pack_bf16(o[nd][0], o[nd][1]);
    if (r1 < n) *reinterpret_cast<uint32_t*>(orow + r1 * heads_d + nd * 8) = pack_bf16(o[nd][2], o[nd][3]);
  }
}

// float32 variant: one thread per query row, the same passes and rounding points.
template <int HD>
__global__ void __launch_bounds__(kRows)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               float* __restrict__ out, int n, long long sb, long long sn, float scale) {
  extern __shared__ float fsmem[];
  float* sK = fsmem;        // [n][HD]
  float* sV = fsmem + n * HD;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * kRows + threadIdx.x;
  const long long base = b * sb + (long long)h * HD;
  for (int i = threadIdx.x; i < n * HD; i += kRows) {
    const int key = i / HD, c = i % HD;
    sK[i] = k[base + key * sn + c];
    sV[i] = v[base + key * sn + c];
  }
  __syncthreads();
  if (r >= n) return;
  float qr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) qr[c] = q[base + r * sn + c];
  auto score = [&](int key) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc = acc + qr[c] * sK[key * HD + c];
    return acc * scale;
  };
  float m = -INFINITY;
  for (int key = 0; key < n; ++key) m = fmaxf(m, score(key));
  float l = 0.0f;
  for (int key = 0; key < n; ++key) l = l + expf(score(key) - m);
  float o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.0f;
  for (int key = 0; key < n; ++key) {
    const float p = expf(score(key) - m) / l;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = o[c] + p * sV[key * HD + c];
  }
  const long long heads_d = gridDim.y * (long long)HD;
  float* orow = out + (long long)b * n * heads_d + r * heads_d + (long long)h * HD;
#pragma unroll
  for (int c = 0; c < HD; ++c) orow[c] = o[c];
}

// An N whose K and V do not fit in one block's shared memory fails here, in
// cudaFuncSetAttribute; the runtime's last error is reset so that later
// launches do not report it.
int clear(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int n, int heads, long long sb,
           long long sn, int bf16, float scale, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, heads, B);
  cudaError_t err;
  if (bf16) {
    const int npad = (n + 15) & ~15;
    const size_t smem = ((size_t)npad * (HD + 8) + (size_t)HD * (npad + 8)) * sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(mha_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return clear(err);
    mha_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), n, sb, sn, scale);
  } else {
    const size_t smem = (size_t)2 * n * HD * sizeof(float);
    err = cudaFuncSetAttribute(mha_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return clear(err);
    mha_f32_kernel<HD><<<grid, kRows, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                      static_cast<const float*>(v), static_cast<float*>(out), n,
                                                      sb, sn, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, n, heads * hd) views sharing the batch and row strides sb, sn
// (in elements, unit feature stride); out: (B, n, heads * hd) contiguous.
// scale: hd^-0.5 as the caller rounds it to float32.
extern "C" int unopose_mha_fused(const void* q, const void* k, const void* v, void* out, int B, int n, int heads,
                                 int hd, long long sb, long long sn, int bf16, float scale, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || heads <= 0 || heads > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 32: return launch<32>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 48: return launch<48>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 64: return launch<64>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 80: return launch<80>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 96: return launch<96>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 112: return launch<112>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    case 128: return launch<128>(q, k, v, out, B, n, heads, sb, sn, bf16, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
