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
// slot sums differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointsPerBlock = 64;
constexpr int kMaxSlots = 256;
constexpr int kPerLane = kMaxSlots / 32;
constexpr int kMaxN = 4096;

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: a + b == b + a, so every lane ends with the same bits
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cos(arccos(r) / 3) by Newton on 4c^3 - 3c = r (ops/eig3.py:_cos_acos_div3_newton)
__device__ __forceinline__ float cos_acos_div3_newton(float r) {
  r = fminf(fmaxf(r, -1.0f), 1.0f);
  float c = 0.5f + 0.5f * sqrtf(fmaxf((r + 1.0f) * 0.5f, 0.0f));
  for (int it = 0; it < 6; ++it) {
    const float f = ((4.0f * c) * c) * c - 3.0f * c - r;
    const float df = fmaxf((12.0f * c) * c - 3.0f, static_cast<float>(1e-3));
    c = fminf(fmaxf(c - f / df, 0.5f), 1.0f);
  }
  return c;
}

// unit eigenvector of the smallest eigenvalue of [[a, b, c], [b, d, e], [c, e, f]]
// (ops/eig3.py:smallest_eigvec_sym3_planar with use_newton)
__device__ void smallest_eigvec(float a, float b, float c, float d, float e, float f, float& v0, float& v1,
                                float& v2) {
  const float p1 = (b * b + c * c) + e * e;
  const float q = ((a + d) + f) / 3.0f;
  const float da = a - q, dd = d - q, df = f - q;
  const float p2 = ((da * da + dd * dd) + df * df) + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
  const float sp = p > 0.0f ? p : 1.0f;
  const float ba = da / sp, bd = dd / sp, bf = df / sp;
  const float bb = b / sp, bc = c / sp, be = e / sp;
  const float det = (ba * (bd * bf - be * be) - bb * (bb * bf - be * bc)) + bc * (bb * be - bd * bc);
  const float r = fminf(fmaxf(det / 2.0f, -1.0f), 1.0f);
  const float c1 = cos_acos_div3_newton(r);
  const float s1 = sqrtf(fmaxf(1.0f - c1 * c1, 0.0f));
  const float c3 = -0.5f * c1 - static_cast<float>(0.8660254037844386) * s1;  // sqrt(3) / 2
  float l1 = q + (2.0f * p) * c1;
  const float l3 = q + (2.0f * p) * c3;
  float l2 = (3.0f * q - l1) - l3;
  if (p2 <= static_cast<float>(1e-30)) {
    l1 = q;
    l2 = q;
  }
  const float s = l1 + l2, pr = l1 * l2;
  const float m00 = (((a * a + b * b) + c * c) - s * a) + pr;
  const float m01 = ((a * b + b * d) + c * e) - s * b;
  const float m02 = ((a * c + b * e) + c * f) - s * c;
  const float m11 = (((b * b + d * d) + e * e) - s * d) + pr;
  const float m12 = ((b * c + d * e) + e * f) - s * e;
  const float m22 = (((c * c + e * e) + f * f) - s * f) + pr;
  const float n0 = (m00 * m00 + m01 * m01) + m02 * m02;
  const float n1 = (m01 * m01 + m11 * m11) + m12 * m12;
  const float n2 = (m02 * m02 + m12 * m12) + m22 * m22;
  const bool best01 = n0 >= n1;
  const bool use2 = n2 > (best01 ? n0 : n1);
  const float x0 = use2 ? m02 : (best01 ? m00 : m01);
  const float x1 = use2 ? m12 : (best01 ? m01 : m11);
  const float x2 = use2 ? m22 : (best01 ? m02 : m12);
  const float nrm = sqrtf((x0 * x0 + x1 * x1) + x2 * x2);
  const float scale = fmaxf(fmaxf(fmaxf(fabsf(a), fabsf(d)), fabsf(f)), static_cast<float>(1e-30));
  const bool ok = nrm > (static_cast<float>(1e-20) * scale) * scale;
  const float inv = ok ? 1.0f / fmaxf(nrm, static_cast<float>(1e-30)) : 0.0f;
  v0 = x0 * inv;
  v1 = x1 * inv;
  v2 = ok ? x2 * inv : 1.0f;
}

// the LRF coordinates of one scale (ops/lrf.py:batch_lrf_planar with weights m)
__device__ __forceinline__ void masked_lrf(const float (&rx)[kPerLane], const float (&ry)[kPerLane],
                                           const float (&rz)[kPerLane], const float (&m)[kPerLane], int nu,
                                           float r_lrf, float inv_r, float (&o0)[kPerLane],
                                           float (&o1)[kPerLane], float (&o2)[kPerLane]) {
  float cnt = 0.0f, sa = 0.0f, sb = 0.0f, sc = 0.0f, sd = 0.0f, se = 0.0f, sf = 0.0f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    if (u < nu) {
      cnt += m[u];
      sa += (rx[u] * rx[u]) * m[u];
      sb += (rx[u] * ry[u]) * m[u];
      sc += (rx[u] * rz[u]) * m[u];
      sd += (ry[u] * ry[u]) * m[u];
      se += (ry[u] * rz[u]) * m[u];
      sf += (rz[u] * rz[u]) * m[u];
    }
  }
  cnt = fmaxf(warp_sum(cnt), 1.0f);
  float z0, z1, z2;
  smallest_eigvec(warp_sum(sa) / cnt, warp_sum(sb) / cnt, warp_sum(sc) / cnt, warp_sum(sd) / cnt,
                  warp_sum(se) / cnt, warp_sum(sf) / cnt, z0, z1, z2);

  float pos = 0.0f, neg = 0.0f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    if (u < nu) {
      const float cp = -((z0 * rx[u] + z1 * ry[u]) + z2 * rz[u]);
      pos += (cp > static_cast<float>(1e-3) ? 1.0f : 0.0f) * m[u];
      neg += (cp < static_cast<float>(-1e-3) ? 1.0f : 0.0f) * m[u];
    }
  }
  const float sgn = warp_sum(pos) - warp_sum(neg) < 0.0f ? -1.0f : 1.0f;
  z0 *= sgn;
  z1 *= sgn;
  z2 *= sgn;

  float vx = 0.0f, vy = 0.0f, vz = 0.0f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    if (u < nu) {
      const float norm = (z0 * rx[u] + z1 * ry[u]) + z2 * rz[u];
      const float x_l2 = sqrtf((rx[u] * rx[u] + ry[u] * ry[u]) + rz[u] * rz[u]);
      const float dl = r_lrf - x_l2;
      const float w = (dl * dl) * (norm * norm);
      vx += (w * (rx[u] - norm * z0)) * m[u];
      vy += (w * (ry[u] - norm * z1)) * m[u];
      vz += (w * (rz[u] - norm * z2)) * m[u];
    }
  }
  vx = warp_sum(vx);
  vy = warp_sum(vy);
  vz = warp_sum(vz);
  const float vn = sqrtf((vx * vx + vy * vy) + vz * vz) + static_cast<float>(1e-10);
  const float x0 = vx / vn, x1 = vy / vn, x2 = vz / vn;
  const float y0 = x1 * z2 - x2 * z1;
  const float y1 = x2 * z0 - x0 * z2;
  const float y2 = x0 * z1 - x1 * z0;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    if (u < nu) {
      o0[u] = ((x0 * rx[u] + x1 * ry[u]) + x2 * rz[u]) * inv_r;
      o1[u] = ((y0 * rx[u] + y1 * ry[u]) + y2 * rz[u]) * inv_r;
      o2[u] = ((z0 * rx[u] + z1 * ry[u]) + z2 * rz[u]) * inv_r;
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p_end = min(p0 + kPointsPerBlock, np);
  for (int p = p0 + warp; p < p_end; p += kWarps) {
    const size_t pt = (size_t)b * np + p;
    const int chunks = max(1, min((total2[pt] + 63) >> 6, s2 >> 6));
    const int nu = 2 * chunks;  // slots per lane
    const float px = cx[pt], py = cy[pt], pz = cz[pt];
    float rx[kPerLane], ry[kPerLane], rz[kPerLane], m1[kPerLane], m2[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      if (u < nu) {
        const size_t s = pt * s2 + u * 32 + lane;
        int q = idx[s];
        q = q < 0 ? 0 : (q >= n ? n - 1 : q);
        rx[u] = s_planes[q] - px;
        ry[u] = s_planes[n + q] - py;
        rz[u] = s_planes[2 * n + q] - pz;
        m1[u] = __bfloat162float(w1[s]);
        m2[u] = __bfloat162float(w2[s]);
      }
    }
    float a0[kPerLane], a1[kPerLane], a2[kPerLane], c0[kPerLane], c1[kPerLane], c2[kPerLane];
    masked_lrf(rx, ry, rz, m1, nu, r1, inv_r1, a0, a1, a2);
    masked_lrf(rx, ry, rz, m2, nu, r2, inv_r2, c0, c1, c2);
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      if (u < nu) {
        uint2* dst = reinterpret_cast<uint2*>(out + (pt * s2 + u * 32 + lane) * 12);
        dst[0] = make_uint2(pack2(rx[u], ry[u]), pack2(rz[u], a0[u]));
        dst[1] = make_uint2(pack2(a1[u], a2[u]), pack2(rx[u], ry[u]));
        dst[2] = make_uint2(pack2(rz[u], c0[u]), pack2(c1[u], c2[u]));
      }
    }
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
