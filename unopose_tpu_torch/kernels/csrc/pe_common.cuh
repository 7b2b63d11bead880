// Device code shared by the fine-PE inference kernels pe_channels.cu (K5),
// pe_mlp_pool.cu (K6), pe_masked.cu (K16), pe_packed.cu (K19),
// pe_mlp_pool_packed.cu (K20), pe_gather_fused.cu (K21) and pe_packed_t.cu
// (K22): the local reference frame of a neighbourhood over weighted slots
// (ops/lrf.py: batch_lrf_planar with use_newton), its steps split into the
// warp's sums over a point's slots and the scalar work on them (K5 runs the
// scalar work on one lane per point, the others on the whole warp), the
// folded-BatchNorm MLP 6 -> 32 -> 64 -> 128 on mma.sync m16n8k16 bf16 tiles
// of 16 slots with its running max, and three per-point routines built from
// them: K21's channels (point_channels), K6's pool (point_pool) and K16's
// staged scale (staged_pool); K19 (pe_packed.cu) takes the frame's steps
// and runs its MLP on warpgroup products. A lane holds slots lane, lane +
// 32, ...: the per-lane slot count is a template parameter, kPerLane (256
// slots) for K16 and for K21 and K22 up to 256 slots, up to kPerLaneMax (a
// window of 512 slots) for those two. They take up to kMaxSlotsPacked slots:
// past one window a point's slots are walked window by window
// (windowed_frame, the windowed branches of the kernels), each lane's LRF
// sums carried across windows in
// the slot order one wider array would take and the pooled max carried
// across them (a max is exact in any order), so that one window is the
// single-array code bit for bit. Each kernel's source says how it uses them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 256;  // K5, K6, K16
constexpr int kPerLane = kMaxSlots / 32;
constexpr int kMaxSlotsPacked = 4096;  // K19-K22: the JAX gates admit nsample2 % 256 == 0 up to N <= 4096
constexpr int kWindow = 512;           // slots a warp holds in registers (and stages) at once in K21, K22
constexpr int kPerLaneMax = kWindow / 32;
constexpr int kLd0 = 16 + 8;  // row strides of the transposed weights, in bf16
constexpr int kLd1 = 32 + 8;
constexpr int kLd2 = 64 + 8;
constexpr int kW0 = 32 * kLd0;
constexpr int kW1 = 64 * kLd1;
constexpr int kW2 = 128 * kLd2;
constexpr int kWScale = kW0 + kW1 + kW2;  // ops/pe_fused.py:pack_mlp
constexpr int kBScale = 32 + 64 + 128;

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

// The weighted LRF of one scale (ops/lrf.py:batch_lrf_planar with weights
// m), in the steps a windowed walk over a point's slots repeats: each
// lane's sums over its slots u < nu in u order, then across the warp.
struct LrfMoments {
  float cnt = 0.0f, sa = 0.0f, sb = 0.0f, sc = 0.0f, sd = 0.0f, se = 0.0f, sf = 0.0f;
};

struct Frame {
  float x0, x1, x2, y0, y1, y2, z0, z1, z2;
};

template <int PL>
__device__ __forceinline__ void lrf_moments(const float (&rx)[PL], const float (&ry)[PL], const float (&rz)[PL],
                                            const float (&m)[PL], int nu, LrfMoments& s) {
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (u < nu) {
      s.cnt += m[u];
      s.sa += (rx[u] * rx[u]) * m[u];
      s.sb += (rx[u] * ry[u]) * m[u];
      s.sc += (rx[u] * rz[u]) * m[u];
      s.sd += (ry[u] * ry[u]) * m[u];
      s.se += (ry[u] * rz[u]) * m[u];
      s.sf += (rz[u] * rz[u]) * m[u];
    }
  }
}

// each of a lane's moment sums summed over the warp (every lane ends with the same bits)
__device__ __forceinline__ LrfMoments warp_moments(const LrfMoments& s) {
  LrfMoments t;
  t.cnt = warp_sum(s.cnt);
  t.sa = warp_sum(s.sa);
  t.sb = warp_sum(s.sb);
  t.sc = warp_sum(s.sc);
  t.sd = warp_sum(s.sd);
  t.se = warp_sum(s.se);
  t.sf = warp_sum(s.sf);
  return t;
}

// the frame's normal, its sign not yet fixed, from the warp's moments t: their smallest eigenvector
__device__ __forceinline__ void normal_of(const LrfMoments& t, Frame& f) {
  const float cnt = fmaxf(t.cnt, 1.0f);
  smallest_eigvec(t.sa / cnt, t.sb / cnt, t.sc / cnt, t.sd / cnt, t.se / cnt, t.sf / cnt, f.z0, f.z1, f.z2);
}

__device__ __forceinline__ void lrf_normal(const LrfMoments& s, Frame& f) { normal_of(warp_moments(s), f); }

template <int PL>
__device__ __forceinline__ void lrf_votes(const Frame& f, const float (&rx)[PL], const float (&ry)[PL],
                                          const float (&rz)[PL], const float (&m)[PL], int nu, float& pos,
                                          float& neg) {
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (u < nu) {
      const float cp = -((f.z0 * rx[u] + f.z1 * ry[u]) + f.z2 * rz[u]);
      pos += (cp > static_cast<float>(1e-3) ? 1.0f : 0.0f) * m[u];
      neg += (cp < static_cast<float>(-1e-3) ? 1.0f : 0.0f) * m[u];
    }
  }
}

// the normal's sign from the votes summed over the warp
__device__ __forceinline__ void orient_of(float pos, float neg, Frame& f) {
  const float sgn = pos - neg < 0.0f ? -1.0f : 1.0f;
  f.z0 *= sgn;
  f.z1 *= sgn;
  f.z2 *= sgn;
}

__device__ __forceinline__ void lrf_orient(float pos, float neg, Frame& f) {
  orient_of(warp_sum(pos), warp_sum(neg), f);
}

template <int PL>
__device__ __forceinline__ void lrf_tangent(const Frame& f, const float (&rx)[PL], const float (&ry)[PL],
                                            const float (&rz)[PL], const float (&m)[PL], int nu, float r_lrf,
                                            float& vx, float& vy, float& vz) {
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (u < nu) {
      const float norm = (f.z0 * rx[u] + f.z1 * ry[u]) + f.z2 * rz[u];
      const float x_l2 = sqrtf((rx[u] * rx[u] + ry[u] * ry[u]) + rz[u] * rz[u]);
      const float dl = r_lrf - x_l2;
      const float w = (dl * dl) * (norm * norm);
      vx += (w * (rx[u] - norm * f.z0)) * m[u];
      vy += (w * (ry[u] - norm * f.z1)) * m[u];
      vz += (w * (rz[u] - norm * f.z2)) * m[u];
    }
  }
}

// the x and y axes from the tangent sums over the warp
__device__ __forceinline__ void axes_of(float vx, float vy, float vz, Frame& f) {
  const float vn = sqrtf((vx * vx + vy * vy) + vz * vz) + static_cast<float>(1e-10);
  f.x0 = vx / vn;
  f.x1 = vy / vn;
  f.x2 = vz / vn;
  f.y0 = f.x1 * f.z2 - f.x2 * f.z1;
  f.y1 = f.x2 * f.z0 - f.x0 * f.z2;
  f.y2 = f.x0 * f.z1 - f.x1 * f.z0;
}

__device__ __forceinline__ void lrf_axes(float vx, float vy, float vz, Frame& f) {
  axes_of(warp_sum(vx), warp_sum(vy), warp_sum(vz), f);
}

template <int PL>
__device__ __forceinline__ void lrf_coords(const Frame& f, const float (&rx)[PL], const float (&ry)[PL],
                                           const float (&rz)[PL], int nu, float inv_r, float (&o0)[PL],
                                           float (&o1)[PL], float (&o2)[PL]) {
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (u < nu) {
      o0[u] = ((f.x0 * rx[u] + f.x1 * ry[u]) + f.x2 * rz[u]) * inv_r;
      o1[u] = ((f.y0 * rx[u] + f.y1 * ry[u]) + f.y2 * rz[u]) * inv_r;
      o2[u] = ((f.z0 * rx[u] + f.z1 * ry[u]) + f.z2 * rz[u]) * inv_r;
    }
  }
}

// the LRF coordinates of one scale over the slots a lane holds
template <int PL>
__device__ __forceinline__ void masked_lrf(const float (&rx)[PL], const float (&ry)[PL], const float (&rz)[PL],
                                           const float (&m)[PL], int nu, float r_lrf, float inv_r, float (&o0)[PL],
                                           float (&o1)[PL], float (&o2)[PL]) {
  LrfMoments s;
  lrf_moments(rx, ry, rz, m, nu, s);
  Frame f;
  lrf_normal(s, f);
  float pos = 0.0f, neg = 0.0f;
  lrf_votes(f, rx, ry, rz, m, nu, pos, neg);
  lrf_orient(pos, neg, f);
  float vx = 0.0f, vy = 0.0f, vz = 0.0f;
  lrf_tangent(f, rx, ry, rz, m, nu, r_lrf, vx, vy, vz);
  lrf_axes(vx, vy, vz, f);
  lrf_coords(f, rx, ry, rz, nu, inv_r, o0, o1, o2);
}

// The frame of one scale over a lane's nu slots, more than one window
// holds: load(w, rx, ry, rz, m) fills window w, a lane's slots
// (w * PL + u) * 32 + lane for u < nu - w * PL (the rest zero). Each pass
// walks the windows in order, so that every sum takes the per-lane order of
// one array of nu slots; the windows are loaded once per pass.
template <int PL, class Load>
__device__ Frame windowed_frame(Load&& load, int nu, float r_lrf) {
  float rx[PL], ry[PL], rz[PL], m[PL];
  const int nwin = (nu + PL - 1) / PL;
  LrfMoments s;
#pragma unroll 1
  for (int w = 0; w < nwin; ++w) {
    load(w, rx, ry, rz, m);
    lrf_moments(rx, ry, rz, m, min(PL, nu - w * PL), s);
  }
  Frame f;
  lrf_normal(s, f);
  float pos = 0.0f, neg = 0.0f;
#pragma unroll 1
  for (int w = 0; w < nwin; ++w) {
    load(w, rx, ry, rz, m);
    lrf_votes(f, rx, ry, rz, m, min(PL, nu - w * PL), pos, neg);
  }
  lrf_orient(pos, neg, f);
  float vx = 0.0f, vy = 0.0f, vz = 0.0f;
#pragma unroll 1
  for (int w = 0; w < nwin; ++w) {
    load(w, rx, ry, rz, m);
    lrf_tangent(f, rx, ry, rz, m, min(PL, nu - w * PL), r_lrf, vx, vy, vz);
  }
  lrf_axes(vx, vy, vz, f);
  return f;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// bias + ReLU, rounded to a bf16 pair (low half = lower column)
__device__ __forceinline__ uint32_t relu_pack(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(x, 0.0f), fmaxf(y, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float relu_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(fmaxf(x, 0.0f))); }

template <bool kRound>
__device__ __forceinline__ float relu_last(float x) {
  return kRound ? relu_bf16(x) : fmaxf(x, 0.0f);
}

// One 16-slot tile of a point's neighbourhood through the scale's three
// layers (W0 = the scale's packed weights, B0 its biases), into the running
// max mx of this lane's columns: a1 is the tile's layer-1 A fragment (the 6
// channels, zero-padded to K = 16), keep0 / keep1 whether the lane's two
// rows (slots) take part in the max. kRoundLast: the last layer's ReLU
// output rounded to bf16 (every kernel but K20, whose TPU kernel keeps it
// in float32).
template <bool kRoundLast = true>
__device__ __forceinline__ void mlp_tile(const uint32_t (&a1)[4], const __nv_bfloat16* W0, const float* B0,
                                         bool keep0, bool keep1, float (&mx)[16][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group
  const __nv_bfloat16* W1 = W0 + kW0;
  const __nv_bfloat16* W2 = W1 + kW1;
  const float* B1 = B0 + 32;
  const float* B2 = B1 + 64;
  // layer 1: 6 -> 32
  uint32_t a2[2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const __nv_bfloat16* wr = W0 + (nt * 8 + g) * kLd0 + 2 * t;
    mma_bf16(c, a1, ld32(wr), ld32(wr + 8));
    const int col = nt * 8 + 2 * t;
    a2[nt >> 1][(nt & 1) * 2] = relu_pack(c[0] + B0[col], c[1] + B0[col + 1]);
    a2[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[2] + B0[col], c[3] + B0[col + 1]);
  }
  // layer 2: 32 -> 64
  uint32_t a3[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const __nv_bfloat16* wr = W1 + (nt * 8 + g) * kLd1 + kt * 16 + 2 * t;
      mma_bf16(c, a2[kt], ld32(wr), ld32(wr + 8));
    }
    const int col = nt * 8 + 2 * t;
    a3[nt >> 1][(nt & 1) * 2] = relu_pack(c[0] + B1[col], c[1] + B1[col + 1]);
    a3[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[2] + B1[col], c[3] + B1[col + 1]);
  }
  // layer 3: 64 -> 128, straight into the masked running max
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const __nv_bfloat16* wr = W2 + (nt * 8 + g) * kLd2 + kt * 16 + 2 * t;
      mma_bf16(c, a3[kt], ld32(wr), ld32(wr + 8));
    }
    const int col = nt * 8 + 2 * t;
    const float h0 = keep0 ? relu_last<kRoundLast>(c[0] + B2[col]) : 0.0f;
    const float h1 = keep0 ? relu_last<kRoundLast>(c[1] + B2[col + 1]) : 0.0f;
    const float h2 = keep1 ? relu_last<kRoundLast>(c[2] + B2[col]) : 0.0f;
    const float h3 = keep1 ? relu_last<kRoundLast>(c[3] + B2[col + 1]) : 0.0f;
    mx[nt][0] = fmaxf(mx[nt][0], fmaxf(h0, h2));
    mx[nt][1] = fmaxf(mx[nt][1], fmaxf(h1, h3));
  }
}

// The running max reduced across the 8 row groups and stored: out[0..127];
// with acc, the max of it and what out holds (a later window of the point).
__device__ __forceinline__ void store_max(float (&mx)[16][2], float* out, bool acc = false) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = mx[nt][j];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      mx[nt][j] = v;
    }
    if (g == 0) {
      float2* o = reinterpret_cast<float2*>(out + nt * 8 + 2 * t);
      *o = acc ? make_float2(fmaxf(mx[nt][0], o->x), fmaxf(mx[nt][1], o->y)) : make_float2(mx[nt][0], mx[nt][1]);
    }
  }
}

// K21's channels of one point (pe_gather_fused.cu), a warp per point as
// K5's first design ran them (pe_channels.cu now batches a warp's 16 points
// through the same steps, bit for bit): gather its first 32 * nu slots from
// the cloud's permuted planes in shared memory (s_planes: x, y, z, n each)
// through the int16 indices idx, both scales' LRFs over the slot weights
// w1 / w2 (idx, w1, w2 point at the point's row), and the 12 channels (rel
// xyz, LRF-1, rel xyz, LRF-2) of each slot as bf16, 24 bytes a slot from dst
// on (the warp's shared buffer).
template <int PL>
__device__ __forceinline__ void point_channels(const float* s_planes, int n, const int16_t* __restrict__ idx,
                                               const __nv_bfloat16* __restrict__ w1,
                                               const __nv_bfloat16* __restrict__ w2, int nu, float px, float py,
                                               float pz, float r1, float r2, float inv_r1, float inv_r2,
                                               __nv_bfloat16* dst) {
  const int lane = threadIdx.x & 31;
  float rx[PL], ry[PL], rz[PL], m1[PL], m2[PL];
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (u < nu) {
      const int s = u * 32 + lane;
      int q = idx[s];
      q = q < 0 ? 0 : (q >= n ? n - 1 : q);
      rx[u] = s_planes[q] - px;
      ry[u] = s_planes[n + q] - py;
      rz[u] = s_planes[2 * n + q] - pz;
      m1[u] = __bfloat162float(w1[s]);
      m2[u] = __bfloat162float(w2[s]);
    }
  }
  float a0[PL], a1[PL], a2[PL], c0[PL], c1[PL], c2[PL];
  masked_lrf(rx, ry, rz, m1, nu, r1, inv_r1, a0, a1, a2);
  masked_lrf(rx, ry, rz, m2, nu, r2, inv_r2, c0, c1, c2);
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (u < nu) {
      uint2* out = reinterpret_cast<uint2*>(dst + (u * 32 + lane) * 12);
      out[0] = make_uint2(pack2(rx[u], ry[u]), pack2(rz[u], a0[u]));
      out[1] = make_uint2(pack2(a1[u], a2[u]), pack2(rx[u], ry[u]));
      out[2] = make_uint2(pack2(rz[u], c0[u]), pack2(c1[u], c2[u]));
    }
  }
}

// K6's work on one point (pe_mlp_pool.cu): both scales' MLP over the
// first 16 * tiles slots of its 12-channel rows ch (as point_channels
// writes them), each scale's max over the slots whose weight (wm1 / wm2,
// the point's row) is > 0, stored to out[0..255] (with acc, maxed into it).
// s_w / s_b: both scales' pack_mlp weights and biases.
__device__ __forceinline__ void point_pool(const __nv_bfloat16* ch, const __nv_bfloat16* __restrict__ wm1,
                                           const __nv_bfloat16* __restrict__ wm2, int tiles,
                                           const __nv_bfloat16* s_w, const float* s_b, float* __restrict__ out,
                                           bool acc = false) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group
#pragma unroll 1
  for (int sc = 0; sc < 2; ++sc) {
    const __nv_bfloat16* wm = sc ? wm2 : wm1;
    float mx[16][2];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) mx[nt][0] = mx[nt][1] = 0.0f;  // ReLU outputs are >= 0
#pragma unroll 1
    for (int mt = 0; mt < tiles; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;  // the two slots (rows) this lane holds
      // layer 1's A fragment: K = the scale's 6 channels, zero-padded to 16
      uint32_t a1[4] = {0u, 0u, 0u, 0u};
      if (t < 3) {
        a1[0] = ld32(ch + r0 * 12 + 6 * sc + 2 * t);
        a1[1] = ld32(ch + r1 * 12 + 6 * sc + 2 * t);
      }
      mlp_tile(a1, s_w + sc * kWScale, s_b + sc * kBScale, __bfloat162float(wm[r0]) > 0.0f,
               __bfloat162float(wm[r1]) > 0.0f, mx);
    }
    store_max(mx, out + sc * 128, acc);
  }
}

// K21's work on one point whose tier exceeds a window (pe_gather_fused.cu):
// both scales' frames over the lane's nu slots (windowed_frame on the slots
// gathered as point_channels gathers them), then window by window the 12
// channels of the window's slots into the warp's buffer (point_channels'
// layout) and point_pool on them, each scale's max carried in out.
template <int PL>
__device__ void point_channels_pool_windowed(const float* s_planes, int n, const int16_t* __restrict__ idx,
                                             const __nv_bfloat16* __restrict__ w1,
                                             const __nv_bfloat16* __restrict__ w2, int nu, float px, float py,
                                             float pz, float r1, float r2, float inv_r1, float inv_r2,
                                             __nv_bfloat16* stage, const __nv_bfloat16* s_w, const float* s_b,
                                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  auto gather = [&](int w, float (&rx)[PL], float (&ry)[PL], float (&rz)[PL]) {
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      rx[u] = ry[u] = rz[u] = 0.0f;
      if (w * PL + u < nu) {
        int q = idx[(w * PL + u) * 32 + lane];
        q = q < 0 ? 0 : (q >= n ? n - 1 : q);
        rx[u] = s_planes[q] - px;
        ry[u] = s_planes[n + q] - py;
        rz[u] = s_planes[2 * n + q] - pz;
      }
    }
  };
  auto load = [&](const __nv_bfloat16* __restrict__ wm, int w, float (&rx)[PL], float (&ry)[PL], float (&rz)[PL],
                  float (&m)[PL]) {
    gather(w, rx, ry, rz);
#pragma unroll
    for (int u = 0; u < PL; ++u) m[u] = w * PL + u < nu ? __bfloat162float(wm[(w * PL + u) * 32 + lane]) : 0.0f;
  };
  const Frame f1 = windowed_frame<PL>([&](int w, auto& rx, auto& ry, auto& rz, auto& m) { load(w1, w, rx, ry, rz, m); },
                                      nu, r1);
  const Frame f2 = windowed_frame<PL>([&](int w, auto& rx, auto& ry, auto& rz, auto& m) { load(w2, w, rx, ry, rz, m); },
                                      nu, r2);
  float rx[PL], ry[PL], rz[PL], a0[PL], a1[PL], a2[PL], c0[PL], c1[PL], c2[PL];
#pragma unroll 1
  for (int w = 0; w * PL < nu; ++w) {
    const int nw = min(PL, nu - w * PL);
    gather(w, rx, ry, rz);
    lrf_coords(f1, rx, ry, rz, nw, inv_r1, a0, a1, a2);
    lrf_coords(f2, rx, ry, rz, nw, inv_r2, c0, c1, c2);
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      if (u < nw) {
        uint2* o = reinterpret_cast<uint2*>(stage + (u * 32 + lane) * 12);
        o[0] = make_uint2(pack2(rx[u], ry[u]), pack2(rz[u], a0[u]));
        o[1] = make_uint2(pack2(a1[u], a2[u]), pack2(rx[u], ry[u]));
        o[2] = make_uint2(pack2(rz[u], c0[u]), pack2(c1[u], c2[u]));
      }
    }
    __syncwarp();
    point_pool(stage, w1 + w * PL * 32, w2 + w * PL * 32, 2 * nw, s_w, s_b, out, w > 0);
    __syncwarp();  // the buffer is rewritten by the next window
  }
}

constexpr int kRow = 8;  // bf16 per staged row of staged_pool: rel xyz, LRF xyz, 1 (0 past the kept rows), 0

// K16's second half on one scale of one point (pe_masked.cu): the kept
// slots among the lane's first nu (keep[u]) written as bf16 rows of the
// warp's buffer stage (32 * nu rows at most), packed to the front by ballot
// ranks (a masked slot's outputs are multiplied by 0 and a ReLU output never
// lowers a max that starts at 0, so the max over the kept rows, in any
// order, is the multiply-masked max), zero rows up to a whole tile, then the
// MLP (W0 / B0: the scale's packed weights) on ceil(kept / 16) tiles into
// the running max mx (staged_pool_acc, once per window), stored to
// out[0..127] (staged_pool).
template <int PL>
__device__ __forceinline__ void staged_pool_acc(const float (&rx)[PL], const float (&ry)[PL], const float (&rz)[PL],
                                                const float (&o0)[PL], const float (&o1)[PL], const float (&o2)[PL],
                                                const bool (&keep)[PL], int nu, const __nv_bfloat16* W0,
                                                const float* B0, __nv_bfloat16* stage, float (&mx)[16][2]) {
  const int lane = threadIdx.x & 31;
  int valid = 0;
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (u < nu) {
      const unsigned ballot = __ballot_sync(0xffffffffu, keep[u]);
      if (keep[u]) {
        const int row = valid + __popc(ballot & ((1u << lane) - 1u));
        *reinterpret_cast<uint4*>(stage + row * kRow) =
            make_uint4(pack2(rx[u], ry[u]), pack2(rz[u], o0[u]), pack2(o1[u], o2[u]), pack2(1.0f, 0.0f));
      }
      valid += __popc(ballot);
    }
  }
  const int tiles = (valid + 15) >> 4;
  if (valid + lane < tiles * 16) *reinterpret_cast<uint4*>(stage + (valid + lane) * kRow) = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();

  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group
#pragma unroll 1
  for (int mt = 0; mt < tiles; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;  // the two rows this lane holds
    // layer 1's A fragment: K = the 6 channels, zero-padded to 16 (column 6, the row's flag, left out)
    uint32_t a1[4] = {0u, 0u, 0u, 0u};
    if (t < 3) {
      a1[0] = ld32(stage + r0 * kRow + 2 * t);
      a1[1] = ld32(stage + r1 * kRow + 2 * t);
    }
    mlp_tile(a1, W0, B0, __bfloat162float(stage[r0 * kRow + 6]) > 0.0f,
             __bfloat162float(stage[r1 * kRow + 6]) > 0.0f, mx);
  }
  __syncwarp();  // the staging buffer is rewritten by the next call
}

__device__ __forceinline__ void zero_max(float (&mx)[16][2]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) mx[nt][0] = mx[nt][1] = 0.0f;  // ReLU outputs are >= 0
}

template <int PL>
__device__ __forceinline__ void staged_pool(const float (&rx)[PL], const float (&ry)[PL], const float (&rz)[PL],
                                            const float (&o0)[PL], const float (&o1)[PL], const float (&o2)[PL],
                                            const bool (&keep)[PL], int nu, const __nv_bfloat16* W0,
                                            const float* B0, __nv_bfloat16* stage, float* __restrict__ out) {
  float mx[16][2];
  zero_max(mx);
  staged_pool_acc(rx, ry, rz, o0, o1, o2, keep, nu, W0, B0, stage, mx);
  store_max(mx, out);
}

// One scale of one point past one window (K22): the frame over the
// lane's nu_lrf slots (windowed_frame), then window by window over its first
// nu_pool slots the LRF coordinates and staged_pool_acc on the slots where
// keep(m) holds, the max stored to out[0..127]. load as windowed_frame's.
template <int PL, class Load, class Keep>
__device__ void windowed_scale(Load&& load, Keep&& keep_of, int nu_lrf, int nu_pool, float r_lrf, float inv_r,
                               const __nv_bfloat16* W0, const float* B0, __nv_bfloat16* stage,
                               float* __restrict__ out) {
  const Frame f = windowed_frame<PL>(load, nu_lrf, r_lrf);
  float mx[16][2];
  zero_max(mx);
  float rx[PL], ry[PL], rz[PL], m[PL], o0[PL], o1[PL], o2[PL];
  bool keep[PL];
#pragma unroll 1
  for (int w = 0; w * PL < nu_pool; ++w) {
    load(w, rx, ry, rz, m);
    const int nu = min(PL, nu_pool - w * PL);
#pragma unroll
    for (int u = 0; u < PL; ++u) keep[u] = keep_of(m[u]);
    lrf_coords(f, rx, ry, rz, nu, inv_r, o0, o1, o2);
    staged_pool_acc(rx, ry, rz, o0, o1, o2, keep, nu, W0, B0, stage, mx);
  }
  store_max(mx, out);
}

// The largest of n int32 values from p on, reduced over the warp (every lane gets it).
__device__ __forceinline__ int warp_max_of(const int* __restrict__ p, int n) {
  int v = 0;
  for (int i = threadIdx.x & 31; i < n; i += 32) v = max(v, p[i]);
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace
