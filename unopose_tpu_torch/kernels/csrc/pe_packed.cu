// Packed first_k fine PE, point-major (row 10): per point, its scale-2
// slots as materialised (B, P, S2) planes and both scales' multiset
// weights, through both scales' local frames, the folded-BatchNorm MLP
// 6 -> 32 -> 64 -> 128 (bf16 operands, float32 accumulation, bias + ReLU and
// a bf16 cast after each layer) and the max. Output (B, P, 256) float32:
// scale 1 in channels 0-127, scale 2 in 128-255, ahead of the PE's output
// Dense.
//
// Replaces the TPU kernel unopose_tpu/ops/pe_fused.py:pe_fused_packed
// (_pe_kernel_packed with _scale_block and _masked_lrf_block). Its
// reductions, which this kernel follows, are chosen per block of 64 points:
//  - fast block (every point's hit count total2 <= S2 / 2; the hits are
//    compacted to the front): only the first S2 / 2 slots; each scale's LRF
//    weighted by its multiset weights (w1, w2) and its max masked by w > 0;
//  - full block: all S2 slots; scale 1 as on the fast path; scale 2 with an
//    unweighted LRF (count S2: the pad slots are materialised duplicates of
//    the first hit) and an unmasked max.
// The TPU kernel packs the two scales (fast) or the two slot halves (full)
// into block-diagonal weights to fill its 128 x 128 matrix unit; the zero
// blocks add exact zeros, and here each scale runs its own MLP.
//
// Design. A block is one warpgroup and takes whole 64-point blocks (a
// persistent grid, a static stride), reading the block's total2 once for
// its fast flag. It walks a 64-point block in rounds: each warp takes pw
// points (pw = the stage's 512 slots over the point's ns slots, at most 8;
// measured against 1 and 2, PERF.md), the
// first ns slots of each (S2 / 2 fast, S2 full) copied by 16-byte cp.async
// into the warp's stage in shared memory (the planes and weights of all pw
// points), where every pass reads them. The frames of both scales take
// three passes over the staged slots, K5's (pe_channels.cu): a point at a
// time, lane l summing slots l, l + 32, .. in order, then warp_sum's
// butterfly, and the scalar steps (the normal's eigenvector, the sign, the
// x and y axes) once for the warp's points with lane p on point p. Then,
// scale by scale, a fourth pass writes each point's kept slots (w1 > 0;
// scale 2: w2 > 0 fast, every slot full) as 6-channel bf16 rows into the
// warp's row buffer, packed by ballot ranks across its points, each point's
// run of rows padded to a multiple of 16 with copies of its first kept row
// (a repeated row never changes a max, so no row is masked). The MLP runs
// on warpgroup products, pe_train.cu's forward_tile pattern: a tile is each
// warp's next 16 rows (4 x 16 = 64), layer 1 as wgmma m64n32k16 and layer 2
// as m64n64k16 x 2 with A from registers (the previous layer's accumulators
// biased, ReLU'd and packed to bf16, as mma.sync's A fragments), layer 3 as
// m64n64k16 x 4 in two halves, B by descriptor from one copy of both
// scales' weights in shared memory (8 x 8 core matrices, no swizzle). Each
// 16-row slice belongs to one point, so a warp keeps the running max of the
// raw layer-3 sums of its point in registers and, at the point's last
// slice, reduces it over its row groups and stores bias + ReLU + bf16 of it
// (monotone, so bit for bit the max of the per-row outputs; pe_mlp_pool.cu).
// A warp past its rows feeds zero rows and keeps no max. Past one stage of
// 512 slots (a full block at S2 > 512), a warp takes one point and walks
// its slots stage by stage: each pass copies them again, and the pool runs
// the products after every stage's rows, its max carried across them (a
// stage holding S2 768's full rows whole ran 1.34x slower: its shared
// memory halved the warps an SM; tools/kernel_variants.py, PERF.md).
//
// What still holds it back: 185 registers a thread hold it to 8 warps an
// SM (two blocks), and the three frame passes are a chain of warp sums and
// scalar steps; the rounds do not overlap a point's copy with another's
// products; padding each point's rows to 16 adds idle rows (a point with 5
// kept slots runs 16).
//
// Bound: bytes, on the main path's cubes. Per slot of the needed half or
// whole row 12 bytes of coordinates and 2 or 4 of weights, and 1 KB written
// a point; 2 x (6*32 + 32*64 + 64*128) = 20.9 kFLOP of bf16 products per
// slot and scale that takes part in the max (on a fast block the hits of
// both scales, on a full block scale 1's hits and all S2 slots of scale 2);
// the padding of layer 1 (K 6 -> 16) and of the rows is not counted.
//
// Arithmetic follows the plain version (ops/pe_fused.py:
// pe_fused_packed_plain) operation by operation, each rounded on its own
// (-fmad=false); only the order of the slot sums and of the products'
// accumulation differs. The sums, frames, rows and products are the first
// design's (a warp per point, mma.sync in the same k order): its outputs
// bit for bit.

#include "pe_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBlock = 64;     // points per fast-path decision
constexpr int kMaxPw = 8;      // points a warp takes at once (lanes of the scalar steps)
constexpr int kStage = 512;    // slots a warp stages at once
constexpr int kMetaMax = kStage / 16;  // 16-row slices a warp's row buffer holds

// Both scales' weights as wgmma reads them: each layer's (out, in) bf16 in core matrices of 8 outputs x 8
// inputs (pe_train.cu's layout), layer 1's inputs padded 6 -> 16; a scale's layers at 0, kG1, kG2.
constexpr int kG1 = 32 * 16, kG2 = kG1 + 64 * 32, kGScale = kG2 + 128 * 64;
__device__ __forceinline__ int gw_at(int o, int i, int in) {
  return ((o >> 3) * (in >> 3) + (i >> 3)) * 64 + (o & 7) * 8 + (i & 7);
}
// the B of layer 1 (K 16), of layer 2's k-step ks, of layer 3's k-step ks for output half h
__device__ __forceinline__ uint64_t b_l1(const __nv_bfloat16* w) { return gdesc(w, 128, 256); }
__device__ __forceinline__ uint64_t b_l2(const __nv_bfloat16* w, int ks) { return gdesc(w + kG1 + ks * 128, 128, 512); }
__device__ __forceinline__ uint64_t b_l3(const __nv_bfloat16* w, int h, int ks) {
  return gdesc(w + kG2 + h * 4096 + ks * 128, 128, 1024);
}

// A warp's shared memory: its stage (x, y, z planes, then the w1 and w2 weights, kStage slots each), its rows
// (3 words a row: rel xyz and the LRF xyz as bf16 pairs), the slices' points, and its points' centres and frames.
struct WarpTables {
  float4 pts[kMaxPw];             // centre
  float frames[kMaxPw][2][9];     // per scale: x0 x1 x2 y0 y1 y2 z0 z1 z2
  unsigned char meta[kMetaMax];   // slice k: its point (bits 0-6), the point's last slice (bit 7)
};
constexpr size_t kWarpBytes = (size_t)kStage * 16 + (size_t)kStage * 12 + sizeof(WarpTables);
constexpr size_t kSmemBytes = (size_t)2 * kGScale * 2 + (size_t)2 * kBScale * 4 + 16 + 4 * kWarpBytes;

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store_frame(float* f, const Frame& a) {
  f[0] = a.x0, f[1] = a.x1, f[2] = a.x2, f[3] = a.y0, f[4] = a.y1, f[5] = a.y2, f[6] = a.z0, f[7] = a.z1, f[8] = a.z2;
}
__device__ __forceinline__ Frame load_frame(const float* f) {
  return Frame{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
}

// One layer-3 half of a tile (d: n-tiles 8h .. 8h + 7) into the running max of the raw sums
template <int kH>
__device__ __forceinline__ void max_half(float (&mx)[16][2], const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[8 * kH + j][0] = fmaxf(mx[8 * kH + j][0], fmaxf(d[4 * j], d[4 * j + 2]));
    mx[8 * kH + j][1] = fmaxf(mx[8 * kH + j][1], fmaxf(d[4 * j + 1], d[4 * j + 3]));
  }
}

// The running max reduced across the 8 row groups, then bias + ReLU + bf16 rounding once per column (B2: the
// scale's layer-3 biases), stored to out[0..127]; mx is reset for the next point
__device__ __forceinline__ void store_pool(float (&mx)[16][2], const float* B2, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + col) =
          make_float2(relu_bf16(mx[nt][0] + B2[col]), relu_bf16(mx[nt][1] + B2[col + 1]));
    }
    mx[nt][0] = mx[nt][1] = __int_as_float(0xff800000);  // -inf
  }
}

__global__ void __launch_bounds__(kThreads)
pe_packed_kernel(const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
                 const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
                 const int* __restrict__ total2, const float* __restrict__ cx, const float* __restrict__ cy,
                 const float* __restrict__ cz, const __nv_bfloat16* __restrict__ wpack,
                 const float* __restrict__ bpack, float* __restrict__ out, int batch, int np, int s2, float r1,
                 float r2, float inv_r1, float inv_r2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kGScale);
  int* s_block = reinterpret_cast<int*>(s_b + 2 * kBScale);  // the warps' maxima of total2, then their slices
  unsigned char* s_warps = reinterpret_cast<unsigned char*>(s_block + 4);
  // pack_mlp's rows (out, in + pad) into the core-matrix layout
  for (int e = threadIdx.x; e < 2 * kGScale; e += kThreads) {
    const int sc = e / kGScale, i = e % kGScale;
    const __nv_bfloat16* src = wpack + sc * kWScale;
    if (i < kG1) {
      s_w[sc * kGScale + gw_at(i >> 4, i & 15, 16)] = src[(i >> 4) * kLd0 + (i & 15)];
    } else if (i < kG2) {
      const int o = (i - kG1) >> 5, k = (i - kG1) & 31;
      s_w[sc * kGScale + kG1 + gw_at(o, k, 32)] = src[kW0 + o * kLd1 + k];
    } else {
      const int o = (i - kG2) >> 6, k = (i - kG2) & 63;
      s_w[sc * kGScale + kG2 + gw_at(o, k, 64)] = src[kW0 + kW1 + o * kLd2 + k];
    }
  }
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the weights, stored by threads, read by wgmma

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  unsigned char* mine = s_warps + warp * kWarpBytes;
  float* sx = reinterpret_cast<float*>(mine);
  float *sy = sx + kStage, *sz = sy + kStage;
  __nv_bfloat16* sw1 = reinterpret_cast<__nv_bfloat16*>(sz + kStage);
  const __nv_bfloat16* sw2 = sw1 + kStage;
  uint32_t* rows = reinterpret_cast<uint32_t*>(mine + (size_t)kStage * 16);
  WarpTables* tab = reinterpret_cast<WarpTables*>(mine + (size_t)kStage * 28);
  const long long jobs = (long long)batch * (np / kBlock);

  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long base = job * kBlock;  // the block's first point (np % 64 == 0)
    // the fast flag, once for the 64 points
    int v = lane < 16 ? total2[base + warp * 16 + lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    __syncthreads();  // the last job's reads of s_block are done (and the weights are stored)
    if (lane == 0) s_block[warp] = v;
    __syncthreads();
    const bool fast = max(max(s_block[0], s_block[1]), max(s_block[2], s_block[3])) <= s2 / 2;
    const int ns = fast ? s2 / 2 : s2;  // slots a point reads
    int pw = 1;
    while (2 * pw <= kMaxPw && 2 * pw * ns <= kStage) pw *= 2;
    const bool windowed = ns > kStage;  // then pw == 1: the point's slots stage by stage
    const int nwin = windowed ? (ns + kStage - 1) / kStage : 1;

    // copies n slots from slot s0 of the round's point i into the stage at i * ns (windowed: at 0)
    auto copy = [&](long long pt, int i, int s0, int n) {
      const long long row = pt * s2 + s0;
      const int at = windowed ? 0 : i * ns, c4 = n >> 2, c8 = n >> 3;
      for (int c = lane; c < 3 * c4; c += 32) {
        const int pl = c / c4, q = c - pl * c4;
        const float* src = (pl == 0 ? gx : pl == 1 ? gy : gz) + row + 4 * q;
        cp16(sx + pl * kStage + at + 4 * q, src);
      }
      for (int c = lane; c < (fast ? 2 : 1) * c8; c += 32) {
        const int pl = c / c8, q = c - pl * c8;
        cp16(sw1 + pl * kStage + at + 8 * q, (pl ? w2 : w1) + row + 8 * q);
      }
    };
    // the lane's slots of point i in order, fn(rx, ry, rz, m1, m2, s) with s its place in the stage (the
    // windowed walk copies each stage of slots first)
    auto walk = [&](long long pt, int i, auto&& fn) {
      const float4 c = tab->pts[i];
#pragma unroll 1
      for (int w = 0; w < nwin; ++w) {
        const int n = windowed ? min(kStage, ns - w * kStage) : ns, at = windowed ? 0 : i * ns;
        if (windowed) {
          __syncwarp();  // the last stage's reads are done
          copy(pt, i, w * kStage, n);
          cp_wait_all();
          __syncwarp();
        }
#pragma unroll 2
        for (int u = 0; u < (n >> 5); ++u) {
          const int s = at + 32 * u + lane;
          fn(sx[s] - c.x, sy[s] - c.y, sz[s] - c.z, __bfloat162float(sw1[s]), fast ? __bfloat162float(sw2[s]) : 1.0f,
             s);
        }
      }
    };

#pragma unroll 1
    for (int r = 0; r < kBlock / (4 * pw); ++r) {
      const long long first = base + (long long)(r * 4 + warp) * pw;  // the warp's points first .. first + pw - 1
      __syncwarp();  // the last round's reads of the stage and tables are done
      if (lane < pw) tab->pts[lane] = make_float4(cx[first + lane], cy[first + lane], cz[first + lane], 0.0f);
      if (!windowed) {
        for (int i = 0; i < pw; ++i) copy(first + i, i, 0, ns);
        cp_wait_all();
      }
      __syncwarp();

      // pass 1: both scales' moments; lane p's normals
      Frame f1, f2;
      {
        LrfMoments t1, t2;
#pragma unroll 1
        for (int i = 0; i < pw; ++i) {
          LrfMoments a1, a2;
          walk(first + i, i, [&](float rx, float ry, float rz, float m1, float m2, int) {
            const float X[1] = {rx}, Y[1] = {ry}, Z[1] = {rz}, M1[1] = {m1}, M2[1] = {m2};
            lrf_moments<1>(X, Y, Z, M1, 1, a1);
            lrf_moments<1>(X, Y, Z, M2, 1, a2);
          });
          a1 = warp_moments(a1);
          a2 = warp_moments(a2);
          if (lane == i) t1 = a1, t2 = a2;
        }
        normal_of(t1, f1);
        normal_of(t2, f2);
      }
      if (lane < pw) store_frame(tab->frames[lane][0], f1), store_frame(tab->frames[lane][1], f2);
      __syncwarp();
      // pass 2: the votes on each normal's sign; lane p's signs
      {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
        for (int i = 0; i < pw; ++i) {
          const Frame a = load_frame(tab->frames[i][0]), b = load_frame(tab->frames[i][1]);
          float pos1 = 0.0f, neg1 = 0.0f, pos2 = 0.0f, neg2 = 0.0f;
          walk(first + i, i, [&](float rx, float ry, float rz, float m1, float m2, int) {
            const float X[1] = {rx}, Y[1] = {ry}, Z[1] = {rz}, M1[1] = {m1}, M2[1] = {m2};
            lrf_votes<1>(a, X, Y, Z, M1, 1, pos1, neg1);
            lrf_votes<1>(b, X, Y, Z, M2, 1, pos2, neg2);
          });
          pos1 = warp_sum(pos1), neg1 = warp_sum(neg1), pos2 = warp_sum(pos2), neg2 = warp_sum(neg2);
          if (lane == i) v[0] = pos1, v[1] = neg1, v[2] = pos2, v[3] = neg2;
        }
        orient_of(v[0], v[1], f1);
        orient_of(v[2], v[3], f2);
      }
      __syncwarp();
      if (lane < pw) store_frame(tab->frames[lane][0], f1), store_frame(tab->frames[lane][1], f2);
      __syncwarp();
      // pass 3: the tangent sums on the oriented normals; lane p's x and y axes
      {
        float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
        for (int i = 0; i < pw; ++i) {
          const Frame a = load_frame(tab->frames[i][0]), b = load_frame(tab->frames[i][1]);
          float e[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          walk(first + i, i, [&](float rx, float ry, float rz, float m1, float m2, int) {
            const float X[1] = {rx}, Y[1] = {ry}, Z[1] = {rz}, M1[1] = {m1}, M2[1] = {m2};
            lrf_tangent<1>(a, X, Y, Z, M1, 1, r1, e[0], e[1], e[2]);
            lrf_tangent<1>(b, X, Y, Z, M2, 1, r2, e[3], e[4], e[5]);
          });
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            e[k] = warp_sum(e[k]);
            if (lane == i) v[k] = e[k];
          }
        }
        axes_of(v[0], v[1], v[2], f1);
        axes_of(v[3], v[4], v[5], f2);
      }
      __syncwarp();
      if (lane < pw) store_frame(tab->frames[lane][0], f1), store_frame(tab->frames[lane][1], f2);
      __syncwarp();

      // per scale: the kept slots' rows, then the MLP and the max
#pragma unroll 1
      for (int sc = 0; sc < 2; ++sc) {
        const __nv_bfloat16* W = s_w + sc * kGScale;
        const float* Bs = s_b + sc * kBScale;
        const float inv_r = sc ? inv_r2 : inv_r1;
        float mx[16][2];
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) mx[nt][0] = mx[nt][1] = __int_as_float(0xff800000);
#pragma unroll 1
        for (int w = 0; w < nwin; ++w) {
          // pass 4: the rows of the kept slots, point after point (windowed: this stage's slots of the point)
          int nrows = 0, slices = 0;
#pragma unroll 1
          for (int i = 0; i < pw; ++i) {
            const Frame f = load_frame(tab->frames[i][sc]);
            const float4 c = tab->pts[i];
            const int n = windowed ? min(kStage, ns - w * kStage) : ns, at = windowed ? 0 : i * ns;
            if (windowed) {
              __syncwarp();
              copy(first, 0, w * kStage, n);
              cp_wait_all();
              __syncwarp();
            }
            int kept = 0;
#pragma unroll 2
            for (int u = 0; u < (n >> 5); ++u) {
              const int s = at + 32 * u + lane;
              const float X[1] = {sx[s] - c.x}, Y[1] = {sy[s] - c.y}, Z[1] = {sz[s] - c.z};
              const bool keep = sc == 0 ? __bfloat162float(sw1[s]) > 0.0f : !fast || __bfloat162float(sw2[s]) > 0.0f;
              const unsigned ballot = __ballot_sync(0xffffffffu, keep);
              if (keep) {
                float o0[1], o1[1], o2[1];
                lrf_coords<1>(f, X, Y, Z, 1, inv_r, o0, o1, o2);
                uint32_t* row = rows + 3 * (nrows + kept + __popc(ballot & ((1u << lane) - 1u)));
                row[0] = pack2(X[0], Y[0]);
                row[1] = pack2(Z[0], o0[0]);
                row[2] = pack2(o1[0], o2[0]);
              }
              kept += __popc(ballot);
            }
            const int tiles = (kept + 15) >> 4;
            __syncwarp();
            if (kept > 0 && lane < tiles * 16 - kept) {  // the last slice's spare rows repeat the first kept row
              const uint32_t* src = rows + 3 * nrows;
              uint32_t* dst = rows + 3 * (nrows + kept + lane);
              dst[0] = src[0], dst[1] = src[1], dst[2] = src[2];
            }
            for (int k = lane; k < tiles; k += 32) tab->meta[slices + k] = (unsigned char)(i | (k == tiles - 1 ? 0x80 : 0));
            if (kept == 0 && !windowed) {  // no kept slot: the max over none, 0 (ReLU outputs are >= 0)
              reinterpret_cast<float4*>(out + (first + i) * 256 + sc * 128)[lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
            nrows += tiles * 16;
            slices += tiles;
          }
          __syncwarp();
          if (lane == 0) s_block[warp] = slices;
          __syncthreads();
          const int T = max(max(s_block[0], s_block[1]), max(s_block[2], s_block[3]));
          __syncthreads();  // every warp has read the slice counts
          // the products, a tile (each warp's next 16 rows) at a time
#pragma unroll 1
          for (int k = 0; k < T; ++k) {
            const bool live = k < slices;
            uint32_t a1[4] = {0u, 0u, 0u, 0u};
            if (live && t < 3) {
              a1[0] = rows[3 * (16 * k + g) + t];
              a1[1] = rows[3 * (16 * k + g + 8) + t];
            }
            uint32_t a2[2][4], a3[4][4];
            {
              float d1[16];
              wg_fence();
              wgmma_rs32<0>(d1, a1, b_l1(W), 0);
              wg_commit();
              wg_wait<0>();
              hold(d1);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const int col = nt * 8 + 2 * t;
                a2[nt >> 1][(nt & 1) * 2] = relu_pack(d1[4 * nt] + Bs[col], d1[4 * nt + 1] + Bs[col + 1]);
                a2[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(d1[4 * nt + 2] + Bs[col], d1[4 * nt + 3] + Bs[col + 1]);
              }
            }
            {
              float d2[32];
              wg_fence();
              wgmma_rs64<0>(d2, a2[0], b_l2(W, 0), 0);
              wgmma_rs64<0>(d2, a2[1], b_l2(W, 1), 1);
              wg_commit();
              wg_wait<0>();
              hold(d2);
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                const int col = 32 + nt * 8 + 2 * t;
                a3[nt >> 1][(nt & 1) * 2] = relu_pack(d2[4 * nt] + Bs[col], d2[4 * nt + 1] + Bs[col + 1]);
                a3[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(d2[4 * nt + 2] + Bs[col], d2[4 * nt + 3] + Bs[col + 1]);
              }
            }
            float d3[2][32];
            wg_fence();
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) wgmma_rs64<0>(d3[h], a3[ks], b_l3(W, h, ks), ks);
              wg_commit();
            }
            wg_wait<1>();
            hold(d3[0]);
            if (live) max_half<0>(mx, d3[0]);
            wg_wait<0>();
            hold(d3[1]);
            if (live) {
              max_half<1>(mx, d3[1]);
              const int m = tab->meta[k];
              if (!windowed && (m & 0x80)) store_pool(mx, Bs + 96, out + (first + (m & 0x7f)) * 256 + sc * 128);
            }
          }
          __syncwarp();  // the rows are rewritten by the next stage or scale
        }
        if (windowed) store_pool(mx, Bs + 96, out + first * 256 + sc * 128);
      }
    }
  }
}

}  // namespace

// slot planes (B, P, S2) float32, weights (B, P, S2) bf16, total2 (B, P)
// int32, centres (B, P); wpack / bpack: both scales' weights as
// ops/pe_fused.py:pack_mlp lays them out (2 x kWScale bf16, 2 x kBScale
// float32). S2: a multiple of 256 up to P (at most kMaxSlotsPacked).
extern "C" int unopose_pe_packed(const float* gx, const float* gy, const float* gz, const void* w1, const void* w2,
                                 const int* total2, const float* cx, const float* cy, const float* cz,
                                 const void* wpack, const float* bpack, float* out, int batch, int np, int s2,
                                 float r1, float r2, float inv_r1, float inv_r2, cudaStream_t stream) {
  if (s2 % 256 != 0 || s2 <= 0 || s2 > kMaxSlotsPacked || s2 > np || np % kBlock != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long jobs = (long long)batch * (np / kBlock);
  if (jobs == 0) return 0;
  const size_t smem = kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(pe_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_packed_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > jobs) blocks = jobs;
  pe_packed_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      gx, gy, gz, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), total2, cx, cy, cz,
      static_cast<const __nv_bfloat16*>(wpack), bpack, out, batch, np, s2, r1, r2, inv_r1, inv_r2);
  return (int)cudaGetLastError();
}
