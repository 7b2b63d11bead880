// Two-scale first_k neighbour selection with a chunked budget and global
// left compaction.
//
// Replaces the TPU pair unopose_tpu/ops/ball_query.py:_first_k_keys_pallas
// (int8-mask mode) + _compact_stage_pallas. The TPU pipeline streams d2
// blocks through VMEM, writes 2-bit masks to HBM, and ranks and compacts
// them in a second kernel with triangular matmuls and shift rounds. Here a
// block takes kWarps x kCentres consecutive centres of one cloud:
// - it stages the cloud's permuted points once in shared memory as float4
//   (x, y, z, pn), pn = |p|^2 computed once per candidate, padded to whole
//   32-position words with (0, 0, 0, inf), whose d2 is inf (no hit);
// - each warp scans the candidates 64 at a time (two words) for its kCentres
//   centres at once (each candidate read from shared memory serves all of
//   them), turns the two radius tests into __ballot_sync words, and keeps a
//   centre's four words of a step in shared memory by one 16-byte store;
// - then, centre by centre, a lane takes a word: a warp prefix sum of the
//   words' r1 and r2-only hit counts gives the chunk counts and every hit's
//   rank in its chunk; the r2 and r1 hits with the smallest original index
//   are the least keys perm[pos] * 4096 + pos over the lanes' hits (perm is
//   staged beside the cloud), or, where a mask holds a hit in every 64
//   candidates or more, the first met by a walk over the candidates in
//   original order (inv_perm); each lane emits its word's kept hits in
//   position order into a staged row of packed slot words (index | valid
//   << 16 | m1 << 24), stopping once its chunk's budget is full; the row
//   leaves as 16-byte vectors of idx_p and 8-byte vectors of validslot and
//   m1slot, pads past the kept hits.
// Nothing but the final (B, N, k2) selection reaches device memory. Any
// N % 4 == 0 up to 4096, as the JAX select takes: a chunk of W = N / 4
// positions may start and end inside a word, whose hits are then ranked one
// by one.
//
// Bound: N * N distance evaluations per cloud, each ~10 float32 operations
// once pn is hoisted (xy 5, d2 3, two compares), and N * k2 * 4 bytes of
// output per cloud; at 32 x 2048 that is ~1.3 G operations against 64 MB,
// so the kernel is bound by the issue rate of the scan.
//
// Slot order (shared bit for bit with the plain PyTorch version,
// ops/ball_query.py:first_k_select_plain, which mirrors the XLA branch of
// the JAX _first_k_budget_select): within each of the C chunks of W = N / C
// permuted positions, r1 hits come first and then r2-only hits, each by
// ascending position; at most budget = k2 / C of them are kept; the chunks'
// kept hits are then packed left in chunk order and the remaining slots
// hold the pad index q_first.
//
// d2 = (cn - 2 * xy) + pn with cn, pn and xy each summed left to right and
// every operation rounded on its own (built with -fmad=false), the same
// expansion form and order as the plain version, so both draw the same
// radius masks. perm and inv_perm are a permutation and its inverse
// (ops/ball_query.py:permutation): the smallest original index among the
// hits is the first hit met in original order, and perm[inv_perm[i]] = i.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // warps a block (fewer where shared memory is short)
constexpr int kCentres = 4;   // centres a warp
constexpr int kMaxN = 4096;
constexpr int kMaxIts = kMaxN / 32 / 32;  // a lane's mask words at most
constexpr int kChunks = 4;  // ops/ball_query.py:CHUNKS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// d2 = (cn - 2 xy) + pn of a centre and a staged candidate (x, y, z, pn); 2 xy is exact, so cn - 2 xy
// rounded once by the fused form is the plain version's two rounded operations
__device__ __forceinline__ float sqdist(float cx, float cy, float cz, float cn, float4 p) {
  return __fadd_rn(__fmaf_rn(-2.0f, dot3(cx, cy, cz, p.x, p.y, p.z), cn), p.w);
}

// the chunk of permuted position pos, and a per-chunk value of it (registers, not local memory)
__device__ __forceinline__ int chunk_of(int pos, int width) {
  return (pos >= width) + (pos >= 2 * width) + (pos >= 3 * width);
}
template <typename T, int kN>
__device__ __forceinline__ T pick(const T (&v)[kN], int ch) {
  return ch == 0 ? v[0] : ch == 1 ? v[1] : ch == 2 ? v[2] : v[3];
}

// a staged row of k2 slot words to device memory: slot s < base from the row, the pad q_first past it;
// kVec slots a lane a step (8: idx_p as 16 bytes, validslot and m1slot as 8; 4: as 8 and 4)
template <int kVec>
__device__ __forceinline__ void write_row(const uint32_t* srow, int base, int k2, uint32_t pad, int16_t* out_idx,
                                          uint8_t* out_valid, uint8_t* out_m1) {
  const int lane = threadIdx.x & 31;
  for (int s0 = kVec * lane; s0 < k2; s0 += 32 * kVec) {
    uint32_t v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(srow + s0 + i);
      v[i] = s0 + i < base ? q.x : pad;
      v[i + 1] = s0 + i + 1 < base ? q.y : pad;
      v[i + 2] = s0 + i + 2 < base ? q.z : pad;
      v[i + 3] = s0 + i + 3 < base ? q.w : pad;
    }
    uint32_t idx[kVec / 2], valid[kVec / 4], m1[kVec / 4];
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) idx[i] = (v[2 * i] & 0xffffu) | (v[2 * i + 1] << 16);
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      const uint32_t a = v[4 * i], b = v[4 * i + 1], c = v[4 * i + 2], d = v[4 * i + 3];
      valid[i] = ((a >> 16) & 0xffu) | ((b >> 8) & 0xff00u) | (c & 0xff0000u) | ((d << 8) & 0xff000000u);
      m1[i] = (a >> 24) | ((b >> 16) & 0xff00u) | ((c >> 8) & 0xff0000u) | (d & 0xff000000u);
    }
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint4*>(out_idx + s0) = make_uint4(idx[0], idx[1], idx[2], idx[3]);
      *reinterpret_cast<uint2*>(out_valid + s0) = make_uint2(valid[0], valid[1]);
      *reinterpret_cast<uint2*>(out_m1 + s0) = make_uint2(m1[0], m1[1]);
    } else {
      *reinterpret_cast<uint2*>(out_idx + s0) = make_uint2(idx[0], idx[1]);
      *reinterpret_cast<uint32_t*>(out_valid + s0) = valid[0];
      *reinterpret_cast<uint32_t*>(out_m1 + s0) = m1[0];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
first_k_select_kernel(const float* __restrict__ pts, const float* __restrict__ pts_p,
                      const int* __restrict__ perm, const int* __restrict__ inv_perm, int n, int budget,
                      int k1, int k2, float r1sq, float r2sq, int16_t* __restrict__ idx_p,
                      uint8_t* __restrict__ validslot, uint8_t* __restrict__ m1slot,
                      int* __restrict__ cnt1_out, int* __restrict__ enc1_out, int* __restrict__ total2_out,
                      int* __restrict__ q_first_out, int* __restrict__ overflow) {
  extern __shared__ float4 smem[];
  const int warps = blockDim.x >> 5;
  const int words = (n + 31) >> 5, words2 = (words + 1) & ~1;  // the scan takes two words a step
  float4* s_pts = smem;                                                    // [words2 * 32] (x, y, z, pn)
  int* s_perm = reinterpret_cast<int*>(s_pts + (words2 << 5));            // [words2 * 32] original indices
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_perm + (words2 << 5));  // [warps][centre][word][m2, m1]
  uint32_t* s_row = s_mask + warps * kCentres * 2 * words2;               // [warps][k2] slot words
  const int b = blockIdx.y;
  const float* cand = pts_p + (size_t)b * n * 3;
  for (int i = threadIdx.x; i < (words2 << 5); i += blockDim.x) {
    float4 p = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
    if (i < n) {
      p.x = cand[3 * i], p.y = cand[3 * i + 1], p.z = cand[3 * i + 2];
      p.w = dot3(p.x, p.y, p.z, p.x, p.y, p.z);
    }
    s_pts[i] = p;
    s_perm[i] = i < n ? __ldg(perm + i) : 0;
  }
  __syncthreads();

  // the warp index as the compiler can see it is uniform in the warp
  const int warp = __shfl_sync(kFull, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * warps + warp) * kCentres;  // the warp's first centre in the cloud
  if (q0 >= n) return;
  float cx[kCentres], cy[kCentres], cz[kCentres], cn[kCentres];
#pragma unroll
  for (int c = 0; c < kCentres; ++c) {
    const float* ctr = pts + ((size_t)b * n + min(q0 + c, n - 1)) * 3;
    cx[c] = ctr[0], cy[c] = ctr[1], cz[c] = ctr[2];
    cn[c] = dot3(cx[c], cy[c], cz[c], cx[c], cy[c], cz[c]);
  }
  uint32_t* wmask = s_mask + warp * kCentres * 2 * words2;
  for (int g = 0; g < words; g += 2) {
    const float4 p0 = s_pts[(g << 5) + lane], p1 = s_pts[((g + 1) << 5) + lane];
#pragma unroll
    for (int c = 0; c < kCentres; ++c) {
      const float d0 = sqdist(cx[c], cy[c], cz[c], cn[c], p0), d1 = sqdist(cx[c], cy[c], cz[c], cn[c], p1);
      const uint32_t a2 = __ballot_sync(kFull, d0 < r2sq), a1 = __ballot_sync(kFull, d0 < r1sq);
      const uint32_t b2 = __ballot_sync(kFull, d1 < r2sq), b1 = __ballot_sync(kFull, d1 < r1sq);
      if (lane == 0) *reinterpret_cast<uint4*>(wmask + c * 2 * words2 + 2 * g) = make_uint4(a2, a1, b2, b1);
    }
  }
  __syncwarp();

  const int width = n / kChunks, its = (words + 31) >> 5;
  uint32_t* srow = s_row + warp * k2;
  for (int c = 0; c < kCentres && q0 + c < n; ++c) {
    const uint32_t* mm = wmask + c * 2 * words2;  // word w: m2 at 2 w, m1 at 2 w + 1
    // the lane's words it * 32 + lane: their r1 hits, their r2-only hits, and the exclusive prefix over the
    // words in position order of the hit counts, packed as r1 | r2-only << 16
    uint32_t h1[kMaxIts], h2o[kMaxIts], pre[kMaxIts], total = 0u;
#pragma unroll
    for (int it = 0; it < kMaxIts; ++it) {
      h1[it] = h2o[it] = pre[it] = 0u;
      if (it < its) {
        const int w = (it << 5) + lane;
        const uint2 q = w < words ? *reinterpret_cast<const uint2*>(mm + 2 * w) : make_uint2(0u, 0u);
        const uint32_t a = q.y, b2 = q.x;
        h1[it] = a, h2o[it] = b2 & ~a;
        const uint32_t cnt = (uint32_t)__popc(a) | ((uint32_t)__popc(b2 & ~a) << 16);
        uint32_t inc = cnt;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const uint32_t v = __shfl_up_sync(kFull, inc, off);
          if (lane >= off) inc += v;
        }
        pre[it] = total + inc - cnt;
        total += __shfl_sync(kFull, inc, 31);
      }
    }
    // the packed prefix at each chunk's first position ch * width, and at n
    uint32_t at[kChunks + 1];
    at[0] = 0u, at[kChunks] = total;
#pragma unroll
    for (int ch = 1; ch < kChunks; ++ch) {
      const int x = ch * width, w = x >> 5;
      uint32_t p = pre[0];
#pragma unroll
      for (int i = 1; i < kMaxIts; ++i) p = (w >> 5) == i ? pre[i] : p;
      p = __shfl_sync(kFull, p, w & 31);
      const uint32_t below_x = (1u << (x & 31)) - 1u, a = mm[2 * w + 1];
      at[ch] = p + ((uint32_t)__popc(a & below_x) | ((uint32_t)__popc(mm[2 * w] & ~a & below_x) << 16));
    }
    int c1cnt[kChunks], base[kChunks], total2 = 0, cnt1 = 0, kept = 0;
    bool over = false;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const uint32_t d = at[ch + 1] - at[ch];
      const int ccnt = (int)(d & 0xffffu) + (int)(d >> 16);
      c1cnt[ch] = (int)(d & 0xffffu), base[ch] = kept;
      kept += min(ccnt, budget);
      total2 += ccnt, cnt1 += c1cnt[ch];
      over |= ccnt > budget;
    }
    over |= total2 > k2 || cnt1 > k1;
    // the r2 and r1 hits with the smallest original index, each as orig * 4096 + pos: from a walk over the
    // candidates in original order until the first hit where the mask holds one hit in 64 candidates or more,
    // else as the least key over the lanes' hits (the keys alone take 3.5x as long on a cloud where every
    // candidate hits, and a threshold of 1 in 32 loses 9% on sphere surfaces: tools/kernel_variants.py)
    const bool walk2 = 64 * total2 >= n, walk1 = 64 * cnt1 >= n;
    int key2 = n * 4096, key1 = n * 4096;
    if (!walk1) {  // cnt1 <= total2: walk1 implies walk2
#pragma unroll
      for (int it = 0; it < kMaxIts; ++it) {
        const int p0 = ((it << 5) + lane) << 5;
        for (uint32_t bits = walk2 ? h1[it] : h1[it] | h2o[it]; bits; bits &= bits - 1u) {
          const int j = __ffs(bits) - 1, key = s_perm[p0 + j] * 4096 + p0 + j;
          key2 = walk2 ? key2 : min(key2, key);
          key1 = (h1[it] >> j) & 1u ? min(key1, key) : key1;
        }
      }
      key2 = __reduce_min_sync(kFull, key2), key1 = __reduce_min_sync(kFull, key1);
    }
    // a walk ends at its mask's first hit (there is one: its count is at least n / 64)
    for (int i0 = 0; i0 < n && ((walk2 && key2 == n * 4096) || (walk1 && key1 == n * 4096)); i0 += 32) {
      const int i = i0 + lane;
      const int pos = i < n ? __ldg(inv_perm + i) : 0;
      const uint32_t f2 = __ballot_sync(kFull, i < n && ((mm[2 * (pos >> 5)] >> (pos & 31)) & 1u));
      const uint32_t f1 = __ballot_sync(kFull, i < n && ((mm[2 * (pos >> 5) + 1] >> (pos & 31)) & 1u));
      const int p2 = __shfl_sync(kFull, pos, f2 ? __ffs(f2) - 1 : 0);
      const int p1 = __shfl_sync(kFull, pos, f1 ? __ffs(f1) - 1 : 0);
      if (walk2 && key2 == n * 4096 && f2) key2 = (i0 + __ffs(f2) - 1) * 4096 + p2;
      if (walk1 && key1 == n * 4096 && f1) key1 = (i0 + __ffs(f1) - 1) * 4096 + p1;
    }
    const int q_first = total2 > 0 ? key2 & 4095 : __ldg(inv_perm), enc1 = key1;
    const long long row = (long long)b * n + q0 + c;
    if (lane == 0) {
      cnt1_out[row] = cnt1;
      enc1_out[row] = enc1;
      total2_out[row] = total2;
      q_first_out[row] = q_first;
      if (over) atomicOr(overflow, 1);
    }

    // the kept hits to their compacted slots, each lane its words' hits in position order: per chunk r1 hits,
    // then r2-only hits, each by position, their ranks in the chunk counted on from the word's prefix until
    // the budget
#pragma unroll
    for (int it = 0; it < kMaxIts; ++it) {
      const int p0 = ((it << 5) + lane) << 5;
      const int ch = chunk_of(p0, width), last = chunk_of(p0 + 31, width);
      if (!(h1[it] | h2o[it])) continue;
      if (ch == last) {  // the word lies in one chunk
        const uint32_t rel = pre[it] - pick(at, ch);
        const int at_base = pick(base, ch);
        int r = (int)(rel & 0xffffu);
        for (uint32_t bits = h1[it]; bits && r < budget; bits &= bits - 1u, ++r)
          srow[at_base + r] = (uint32_t)(p0 + __ffs(bits) - 1) | (1u << 16) | (1u << 24);
        r = pick(c1cnt, ch) + (int)(rel >> 16);
        for (uint32_t bits = h2o[it]; bits && r < budget; bits &= bits - 1u, ++r)
          srow[at_base + r] = (uint32_t)(p0 + __ffs(bits) - 1) | (1u << 16);
        continue;
      }
      for (uint32_t bits = h1[it] | h2o[it]; bits; bits &= bits - 1u) {  // a word across chunks: hit by hit
        const int j = __ffs(bits) - 1, pos = p0 + j, pch = chunk_of(pos, width);
        const uint32_t below_j = (1u << j) - 1u;
        const uint32_t before = (uint32_t)__popc(h1[it] & below_j) | ((uint32_t)__popc(h2o[it] & below_j) << 16);
        const uint32_t rel = pre[it] + before - pick(at, pch);
        const bool r1 = (h1[it] >> j) & 1u;
        const int rank = r1 ? (int)(rel & 0xffffu) : pick(c1cnt, pch) + (int)(rel >> 16);
        if (rank < budget) srow[pick(base, pch) + rank] = (uint32_t)pos | (1u << 16) | (r1 ? 1u << 24 : 0u);
      }
    }
    __syncwarp();
    const uint32_t pad = (uint32_t)q_first & 0xffffu;
    if (k2 % 8 == 0) write_row<8>(srow, kept, k2, pad, idx_p + row * k2, validslot + row * k2, m1slot + row * k2);
    else write_row<4>(srow, kept, k2, pad, idx_p + row * k2, validslot + row * k2, m1slot + row * k2);
    __syncwarp();
  }
}

}  // namespace

extern "C" int unopose_first_k_select(const float* pts, const float* pts_p, const int* perm,
                                      const int* inv_perm, int batch, int n, int k1, int k2,
                                      float r1sq, float r2sq, int16_t* idx_p,
                                      uint8_t* validslot, uint8_t* m1slot, int* cnt1, int* enc1,
                                      int* total2, int* q_first, int* overflow,
                                      cudaStream_t stream) {
  if (n > kMaxN || n % kChunks != 0 || k2 % kChunks != 0 || k2 > n || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int words2 = ((n + 31) / 32 + 1) & ~1;
  // halve the warps a block until its cloud, words and rows fit (at N = k2 = 4096: 4 warps)
  int warps = kWarps;
  auto smem_of = [&](int w) {
    return (size_t)words2 * 32 * (sizeof(float4) + sizeof(int)) + (size_t)w * kCentres * 2 * words2 * 4 +
           (size_t)w * k2 * 4;
  };
  while (warps > 1 && smem_of(warps) > (size_t)optin) warps /= 2;
  const size_t smem = smem_of(warps);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(first_k_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (n + warps * kCentres - 1) / (warps * kCentres);  // a block for each group of centres
  first_k_select_kernel<<<dim3(groups, batch), warps * 32, smem, stream>>>(
      pts, pts_p, perm, inv_perm, n, k2 / kChunks, k1, k2, r1sq, r2sq, idx_p, validslot, m1slot, cnt1, enc1,
      total2, q_first, overflow);
  return (int)cudaGetLastError();
}
