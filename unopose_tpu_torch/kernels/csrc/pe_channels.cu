// Fine-PE channels: per point, gather its neighbourhood slots' coordinates,
// compute the two scales' weighted local reference frames and store the 12
// channels (rel xyz, LRF-1 xyz, rel xyz, LRF-2 xyz) of every slot as bf16.
//
// Replaces the TPU kernel A of unopose_tpu/ops/pe_fused.py:pe_fused_v5
// (_pe_kernel_channels_t with _masked_lrf_block_t). The TPU kernel gathers
// from 128-lane banks of the permuted planes (Mosaic's lane gather reaches
// one vreg), lays slots on sublanes and points on lanes, and picks a
// 64/128/256-slot tier per block of 128 points.
//
// Bound: bytes. Per needed slot it reads 2 index + 4 weight bytes and writes
// 24 (~126 MB at B = 32, N = 2048 and one 64-slot tier per point, ~0.04 ms
// at 3.35 TB/s), against ~160 float32 operations per slot (~0.01 ms).
//
// Design. A point's frame is a chain: sums over its slots, then scalar work
// on the sums (the moments, then the normal: smallest_eigvec, a Newton
// trisection with IEEE divisions; the votes, then the sign; the tangent
// sums, then the x and y axes). The first design ran it a warp per point,
// the lanes over the slots (lane l sums slots l, l + 32, ... in that order,
// then warp_sum's xor butterfly), so the scalar work ran on all 32 lanes
// once per point, and its registers held 8 slots a lane for the largest
// tier (124 registers, 16 warps an SM). Here a warp owns 16 points and walks
// them in four passes, one point at a time, each point's sums taken as
// before, then the scalar step once for the 16 points with lane p on point
// p: the moments of both scales, the votes, the tangent sums, and last the
// coordinates in both frames with the stores. Each pass regathers a slot's
// coordinates from the cloud's planes, which a block of 8 warps stages in
// shared memory once for its 128 points (24 KB at N = 2048), so nothing is
// held per slot across passes (64 registers, 32 warps an SM). A loop step
// takes two slots a lane (a point's slot count per lane is even). Lane p's
// point data and frames go through a table in shared memory to the lanes of
// the next pass. The tier is per point: 64 * ceil(total2 / 64) slots (at
// least 64), since slots past total2 carry weight 0 in both scales and
// dropping exact-zero terms leaves every sum unchanged. Only those slots are
// written (a lane's 24 bytes as three 8-byte stores, a warp's 32 slots 768
// contiguous bytes); the MLP kernel (pe_mlp_pool.cu) reads exactly those.
//
// What each part bought (tools/kernel_variants.py --only K5, NVIDIA H100
// 80GB HBM3, 700 W, 32 x 2048 points, S2 256, cubes / surfaces, ms; PERF.md
// has each run): the first design 0.306 / 0.501; this one 0.121 / 0.252; 32
// points a warp (p32, the scalar steps on every lane) 0.135 / 0.322; two or
// four points walked at once, their sums reduced by a reduce-scatter in the
// butterfly (since removed) 0.118 / 0.286 and 0.138 / 0.415; 4 warps a block
// (24 warps an SM) 0.139 / 0.319, 16 within 2%; the rows through shared
// memory as 16-byte vectors (staged_stores) within 1%.
//
// Layout (B, P, S2, 12) bf16, point-major with a slot's 12 channels
// together, so that the MLP kernel reads a 16-slot row tile of one scale as
// the A operand of its tensor-core product with no transpose.
//
// Arithmetic follows the plain version (ops/pe_fused.py:pe_channels_plain,
// via ops/lrf.py:batch_lrf_planar and ops/eig3.py with use_newton) operation
// by operation, each rounded on its own (-fmad=false); only the order of the
// slot sums differs, and it is the first design's: the outputs are its bits.
// The steps are pe_common.cuh's (lrf_moments, normal_of, lrf_votes,
// orient_of, lrf_tangent, axes_of, lrf_coords), which K21's point_channels
// runs as a warp per point.

#include "pe_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPointsPerWarp = 16;  // at most one a lane
constexpr int kThreads = kWarps * 32;
constexpr int kPointsPerBlock = kWarps * kPointsPerWarp;
constexpr int kMaxN = 4096;
constexpr int kFrameFloats = 20;  // a point's frames in shared memory: z1, z2, x1, y1, x2, y2, 2 spare

// One point as a pass walks it: the offset of its row of slots, the row's indices and weights, its centre and
// its slot count per lane (even).
struct Pt {
  size_t row;
  const int16_t* idx;
  const __nv_bfloat16* w1;
  const __nv_bfloat16* w2;
  float px, py, pz;
  int nu;
};

// A lane's slots u and u + 1 of a point as loaded from device memory: their permuted indices and weights.
struct Raw {
  int q[2];
  __nv_bfloat16 m1[2], m2[2];
};

// a point's frames as far as a pass needs them
struct Frames {
  Frame f1, f2;
};

// One pass over the warp's count points, one at a time: point_of(q) gives point q, frames_of(q) its frames,
// load(pt, u) the lane's slots u and u + 1 of it; slots(pt, fr, raw, u, acc) adds them to the point's sums acc
// (a fresh Acc, zero) in u order; keep(q, acc) sums them over the warp.
template <class Acc, class PointOf, class FramesOf, class Load, class Slots, class Keep>
__device__ __forceinline__ void walk(int count, PointOf&& point_of, FramesOf&& frames_of, Load&& load, Slots&& slots,
                                     Keep&& keep) {
  for (int q = 0; q < count; ++q) {
    const Pt pt = point_of(q);
    const Frames fr = frames_of(q);
    Acc acc;
    for (int u = 0; u < pt.nu; u += 2) slots(pt, fr, load(pt, u), u, acc);
    keep(q, acc);
  }
}

struct Moments2 {
  LrfMoments s1, s2;
};
struct Votes2 {
  float pos1 = 0.0f, neg1 = 0.0f, pos2 = 0.0f, neg2 = 0.0f;
};
struct Tangent2 {
  float v1[3] = {0.0f, 0.0f, 0.0f}, v2[3] = {0.0f, 0.0f, 0.0f};
};
struct Nothing {};

// A warp's tables in shared memory: a lane's point (centre, slots per lane) and its frames as far as known.
struct WarpSmem {
  float4 points[32];
  float frames[32][kFrameFloats];
};

__global__ void __launch_bounds__(kThreads)
pe_channels_kernel(const float* __restrict__ xp, const float* __restrict__ yp, const float* __restrict__ zp,
                   const int16_t* __restrict__ idx, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2, const int* __restrict__ total2,
                   const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
                   __nv_bfloat16* __restrict__ out, int n, int np, int s2, int point_blocks, float r1,
                   float r2, float inv_r1, float inv_r2) {
  extern __shared__ float4 s_dyn[];  // kWarps WarpSmem, then the x, y, z planes of the cloud, n each
  WarpSmem* s_warp = reinterpret_cast<WarpSmem*>(s_dyn);
  float* s_planes = reinterpret_cast<float*>(s_warp + kWarps);
  const int b = blockIdx.x / point_blocks, k = blockIdx.x % point_blocks;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    s_planes[j] = xp[(size_t)b * n + j];
    s_planes[n + j] = yp[(size_t)b * n + j];
    s_planes[2 * n + j] = zp[(size_t)b * n + j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = k * kPointsPerBlock + warp * kPointsPerWarp;  // the warp's points first, first + 1, ...
  const int count = min(kPointsPerWarp, np - first);
  if (count <= 0) return;
  float* my_frames = s_warp[warp].frames[lane];
  const float4* frames4 = reinterpret_cast<const float4*>(s_warp[warp].frames);
  auto point_of = [&](int q) {
    const float4 v = s_warp[warp].points[q];
    const size_t row = ((size_t)b * np + first + q) * s2;
    return Pt{row, idx + row, w1 + row, w2 + row, v.x, v.y, v.z, __float_as_int(v.w)};
  };
  auto normals_of = [&](int q) {
    const float4 a = frames4[q * (kFrameFloats / 4)];
    const float2 c = reinterpret_cast<const float2*>(frames4 + q * (kFrameFloats / 4) + 1)[0];
    Frames fr;
    fr.f1.z0 = a.x, fr.f1.z1 = a.y, fr.f1.z2 = a.z, fr.f2.z0 = a.w, fr.f2.z1 = c.x, fr.f2.z2 = c.y;
    return fr;
  };
  auto frames_of = [&](int q) {
    const float4* f = frames4 + q * (kFrameFloats / 4);
    const float4 a = f[0], c = f[1], d = f[2], e = f[3], g = f[4];
    Frames fr;
    fr.f1.z0 = a.x, fr.f1.z1 = a.y, fr.f1.z2 = a.z, fr.f2.z0 = a.w, fr.f2.z1 = c.x, fr.f2.z2 = c.y;
    fr.f1.x0 = c.z, fr.f1.x1 = c.w, fr.f1.x2 = d.x, fr.f1.y0 = d.y, fr.f1.y1 = d.z, fr.f1.y2 = d.w;
    fr.f2.x0 = e.x, fr.f2.x1 = e.y, fr.f2.x2 = e.z, fr.f2.y0 = e.w, fr.f2.y1 = g.x, fr.f2.y2 = g.y;
    return fr;
  };
  auto no_frames = [](int) { return Frames{}; };
  auto load_w = [&](const Pt& pt, int u) {  // indices and weights
    Raw r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = (u + h) * 32 + lane;
      r.q[h] = pt.idx[s];
      r.m1[h] = pt.w1[s];
      r.m2[h] = pt.w2[s];
    }
    return r;
  };
  auto load_q = [&](const Pt& pt, int u) {  // indices only
    Raw r;
#pragma unroll
    for (int h = 0; h < 2; ++h) r.q[h] = pt.idx[(u + h) * 32 + lane];
    return r;
  };
  // the slots' coordinates relative to the centre, from the staged planes
  const float *sx = s_planes, *sy = s_planes + n, *sz = s_planes + 2 * n;
  auto rel = [&](const Pt& pt, const Raw& r, float (&rx)[2], float (&ry)[2], float (&rz)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = min(max(r.q[h], 0), n - 1);
      rx[h] = sx[q] - pt.px;
      ry[h] = sy[q] - pt.py;
      rz[h] = sz[q] - pt.pz;
    }
  };
  auto weights = [](const Raw& r, float (&m1)[2], float (&m2)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m1[h] = __bfloat162float(r.m1[h]), m2[h] = __bfloat162float(r.m2[h]);
  };
  {  // lane p's point p (a lane past the warp's points repeats its last; its frames go unused)
    const size_t own = (size_t)b * np + first + min(lane, count - 1);
    const int nu = 2 * max(1, min((total2[own] + 63) >> 6, s2 >> 6));
    s_warp[warp].points[lane] = make_float4(cx[own], cy[own], cz[own], __int_as_float(nu));
  }
  __syncwarp();
  Frame f1, f2;  // lane p's frames

  // pass 1: both scales' moments; then lane p's normals
  LrfMoments t1, t2;
  walk<Moments2>(
      count, point_of, no_frames, load_w,
      [&](const Pt& pt, const Frames&, const Raw& r, int, Moments2& acc) {
        float rx[2], ry[2], rz[2], m1[2], m2[2];
        rel(pt, r, rx, ry, rz);
        weights(r, m1, m2);
        lrf_moments(rx, ry, rz, m1, 2, acc.s1);
        lrf_moments(rx, ry, rz, m2, 2, acc.s2);
      },
      [&](int q, const Moments2& acc) {
        const LrfMoments a = warp_moments(acc.s1), c = warp_moments(acc.s2);
        if (lane == q) t1 = a, t2 = c;
      });
  normal_of(t1, f1);
  normal_of(t2, f2);
  auto put_normals = [&]() {
    __syncwarp();  // every lane is done reading the table
    my_frames[0] = f1.z0, my_frames[1] = f1.z1, my_frames[2] = f1.z2;
    my_frames[3] = f2.z0, my_frames[4] = f2.z1, my_frames[5] = f2.z2;
    __syncwarp();
  };
  put_normals();

  // pass 2: the votes on each normal's sign; then lane p's signs
  Votes2 votes;
  walk<Votes2>(
      count, point_of, normals_of, load_w,
      [&](const Pt& pt, const Frames& fr, const Raw& r, int, Votes2& acc) {
        float rx[2], ry[2], rz[2], m1[2], m2[2];
        rel(pt, r, rx, ry, rz);
        weights(r, m1, m2);
        lrf_votes(fr.f1, rx, ry, rz, m1, 2, acc.pos1, acc.neg1);
        lrf_votes(fr.f2, rx, ry, rz, m2, 2, acc.pos2, acc.neg2);
      },
      [&](int q, const Votes2& acc) {
        const float a = warp_sum(acc.pos1), c = warp_sum(acc.neg1), d = warp_sum(acc.pos2), e = warp_sum(acc.neg2);
        if (lane == q) votes.pos1 = a, votes.neg1 = c, votes.pos2 = d, votes.neg2 = e;
      });
  orient_of(votes.pos1, votes.neg1, f1);
  orient_of(votes.pos2, votes.neg2, f2);
  put_normals();

  // pass 3: the tangent sums on the oriented normals; then lane p's x and y axes
  Tangent2 tangent;
  walk<Tangent2>(
      count, point_of, normals_of, load_w,
      [&](const Pt& pt, const Frames& fr, const Raw& r, int, Tangent2& acc) {
        float rx[2], ry[2], rz[2], m1[2], m2[2];
        rel(pt, r, rx, ry, rz);
        weights(r, m1, m2);
        lrf_tangent(fr.f1, rx, ry, rz, m1, 2, r1, acc.v1[0], acc.v1[1], acc.v1[2]);
        lrf_tangent(fr.f2, rx, ry, rz, m2, 2, r2, acc.v2[0], acc.v2[1], acc.v2[2]);
      },
      [&](int q, const Tangent2& acc) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float a = warp_sum(acc.v1[k]), c = warp_sum(acc.v2[k]);
          if (lane == q) tangent.v1[k] = a, tangent.v2[k] = c;
        }
      });
  axes_of(tangent.v1[0], tangent.v1[1], tangent.v1[2], f1);
  axes_of(tangent.v2[0], tangent.v2[1], tangent.v2[2], f2);
  __syncwarp();
  my_frames[6] = f1.x0, my_frames[7] = f1.x1, my_frames[8] = f1.x2;
  my_frames[9] = f1.y0, my_frames[10] = f1.y1, my_frames[11] = f1.y2;
  my_frames[12] = f2.x0, my_frames[13] = f2.x1, my_frames[14] = f2.x2;
  my_frames[15] = f2.y0, my_frames[16] = f2.y1, my_frames[17] = f2.y2;
  __syncwarp();

  // pass 4: every needed slot's coordinates in both frames, stored as its 12 channels: a lane's 24 bytes as
  // three 8-byte stores, a warp's 32 slots 768 contiguous bytes
  walk<Nothing>(
      count, point_of, frames_of, load_q,
      [&](const Pt& pt, const Frames& fr, const Raw& r, int u, Nothing&) {
        float rx[2], ry[2], rz[2], a0[2], a1[2], a2[2], c0[2], c1[2], c2[2];
        rel(pt, r, rx, ry, rz);
        lrf_coords(fr.f1, rx, ry, rz, 2, inv_r1, a0, a1, a2);
        lrf_coords(fr.f2, rx, ry, rz, 2, inv_r2, c0, c1, c2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint2* dst = reinterpret_cast<uint2*>(out + pt.row * 12) + ((u + h) * 32 + lane) * 3;
          dst[0] = make_uint2(pack2(rx[h], ry[h]), pack2(rz[h], a0[h]));
          dst[1] = make_uint2(pack2(a1[h], a2[h]), pack2(rx[h], ry[h]));
          dst[2] = make_uint2(pack2(rz[h], c0[h]), pack2(c1[h], c2[h]));
        }
      },
      [](int, const Nothing&) {});
}

// the kernel's dynamic shared memory for a cloud of n points
size_t smem_bytes(int n) { return kWarps * sizeof(WarpSmem) + (size_t)3 * n * sizeof(float); }

}  // namespace

extern "C" int unopose_pe_channels(const float* xp, const float* yp, const float* zp, const int16_t* idx,
                                   const void* w1, const void* w2, const int* total2, const float* cx,
                                   const float* cy, const float* cz, void* out, int batch, int n, int np,
                                   int s2, float r1, float r2, float inv_r1, float inv_r2,
                                   cudaStream_t stream) {
  if (n > kMaxN || s2 > kMaxSlots || s2 % 64 != 0 || s2 == 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || np == 0) return 0;
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(pe_channels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int point_blocks = (np + kPointsPerBlock - 1) / kPointsPerBlock;
  pe_channels_kernel<<<(unsigned)(batch * point_blocks), kThreads, smem, stream>>>(
      xp, yp, zp, idx, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), total2,
      cx, cy, cz, static_cast<__nv_bfloat16*>(out), n, np, s2, point_blocks, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}
