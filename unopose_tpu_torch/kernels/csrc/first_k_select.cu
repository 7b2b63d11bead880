// Two-scale first_k neighbour selection with a chunked budget and global
// left compaction, one warp per centre row.
//
// Replaces the TPU pair unopose_tpu/ops/ball_query.py:_first_k_keys_pallas
// (int8-mask mode) + _compact_stage_pallas. The TPU pipeline streams d2
// blocks through VMEM, writes 2-bit masks to HBM, and ranks and compacts
// them in a second kernel with triangular matmuls and shift rounds. Here one
// warp owns a row: it scans the N candidates (already in the fixed
// permuted order) 32 at a time, turns the two radius tests into
// __ballot_sync words kept in shared memory, and then emits the kept hits
// straight to their compacted slots with __popc prefix ranks. Nothing but
// the final (B, N, k2) selection reaches device memory. Any N % 4 == 0 up
// to 4096, as the JAX select takes (see kAligned for N % 128 != 0).
//
// Bound: N * N distance evaluations (6 flops each) and N * k2 slot writes
// per cloud; at N = 2048 that is ~25 Mflop and ~2.5 MB of output per cloud,
// so the kernel is bound by the issue rate of the scan, not by bytes.
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
// radius masks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxN = 4096;
constexpr int kMaxWords = kMaxN / 32;
constexpr int kChunks = 4;  // ops/ball_query.py:CHUNKS

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// kAligned: n % 128 == 0, so every chunk of W = n / 4 positions fills whole
// 32-position words, and each word's hits are counted at once by __popc of
// its ballot. Otherwise a chunk may start and end inside a word: each lane
// counts the hits of its own position in its chunk (the counts summed over
// the warp after the scan), and the compaction masks each word to the
// chunk's bits.
template <bool kAligned>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
first_k_select_kernel(const float* __restrict__ pts, const float* __restrict__ pts_p,
                      const int* __restrict__ perm, const int* __restrict__ inv_perm, int batch,
                      int n, int budget, int k1, int k2, float r1sq, float r2sq,
                      int16_t* __restrict__ idx_p, uint8_t* __restrict__ validslot,
                      uint8_t* __restrict__ m1slot, int* __restrict__ cnt1_out,
                      int* __restrict__ enc1_out, int* __restrict__ total2_out,
                      int* __restrict__ q_first_out, int* __restrict__ overflow) {
  __shared__ uint32_t s_m1[kWarpsPerBlock][kMaxWords];
  __shared__ uint32_t s_m2[kWarpsPerBlock][kMaxWords];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= (long long)batch * n) return;  // whole warps exit together
  const int b = (int)(row / n);
  const float* ctr = pts + row * 3;
  const float cx = ctr[0], cy = ctr[1], cz = ctr[2];
  const float cn = dot3(cx, cy, cz, cx, cy, cz);
  const float* cand = pts_p + (size_t)b * n * 3;

  const int words = (n + 31) >> 5;
  const int width = n / kChunks;
  const int words_per_chunk = words / kChunks;  // kAligned only
  int ccnt[kChunks];
  int c1cnt[kChunks];
  for (int c = 0; c < kChunks; ++c) {
    ccnt[c] = 0;
    c1cnt[c] = 0;
  }
  int first2 = n;         // smallest original index among r2 hits
  int enc1 = n * 4096;    // min over r1 hits of original * 4096 + permuted position

  for (int g = 0; g < words; ++g) {
    const int pos = (g << 5) + lane;
    const bool in = kAligned || pos < n;
    bool m2 = false, m1 = false;
    if (in) {
      const float px = __ldg(cand + 3 * pos);
      const float py = __ldg(cand + 3 * pos + 1);
      const float pz = __ldg(cand + 3 * pos + 2);
      const float pn = dot3(px, py, pz, px, py, pz);
      const float xy = dot3(cx, cy, cz, px, py, pz);
      const float d2 = __fadd_rn(__fsub_rn(cn, __fmul_rn(2.0f, xy)), pn);
      m2 = d2 < r2sq;
      m1 = d2 < r1sq;
    }
    const uint32_t b2 = __ballot_sync(0xffffffffu, m2);
    const uint32_t b1 = __ballot_sync(0xffffffffu, m1);
    if (lane == 0) {
      s_m2[warp][g] = b2;
      s_m1[warp][g] = b1;
    }
    if (in) {
      const int orig = __ldg(perm + pos);
      if (m2) first2 = min(first2, orig);
      if (m1) enc1 = min(enc1, orig * 4096 + pos);
    }
    if (kAligned) {
      const int c = g / words_per_chunk;
      ccnt[c] += __popc(b2);
      c1cnt[c] += __popc(b1);
    } else if (m2) {
      const int c = pos / width;
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        ccnt[cc] += cc == c;
        c1cnt[cc] += cc == c && m1;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    first2 = min(first2, __shfl_xor_sync(0xffffffffu, first2, off));
    enc1 = min(enc1, __shfl_xor_sync(0xffffffffu, enc1, off));
  }
  if (!kAligned) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      for (int off = 16; off > 0; off >>= 1) {
        ccnt[c] += __shfl_xor_sync(0xffffffffu, ccnt[c], off);
        c1cnt[c] += __shfl_xor_sync(0xffffffffu, c1cnt[c], off);
      }
    }
  }
  int total2 = 0, cnt1 = 0;
  bool over = false;
  for (int c = 0; c < kChunks; ++c) {
    total2 += ccnt[c];
    cnt1 += c1cnt[c];
    over |= ccnt[c] > budget;
  }
  over |= total2 > k2 || cnt1 > k1;
  const int q_first = __ldg(inv_perm + (total2 > 0 ? first2 : 0));
  if (lane == 0) {
    cnt1_out[row] = cnt1;
    enc1_out[row] = enc1;
    total2_out[row] = total2;
    q_first_out[row] = q_first;
    if (over) atomicOr(overflow, 1);
  }
  __syncwarp();

  int16_t* out_idx = idx_p + row * k2;
  uint8_t* out_valid = validslot + row * k2;
  uint8_t* out_m1 = m1slot + row * k2;
  const uint32_t below = (1u << lane) - 1u;
  int base = 0;
  for (int c = 0; c < kChunks; ++c) {
    int r1rank = 0, r2rank = 0;
    const int c1 = c1cnt[c];
    const int lo = c * width, hi = lo + width;  // the chunk's permuted positions [lo, hi)
    for (int g = lo >> 5; g <= (hi - 1) >> 5; ++g) {
      uint32_t b1 = s_m1[warp][g];
      uint32_t b2only = s_m2[warp][g] & ~b1;
      if (!kAligned) {  // the word's bits inside the chunk
        const int from = max(lo - (g << 5), 0), to = min(hi - (g << 5), 32);
        const uint32_t in_chunk = (to == 32 ? 0xffffffffu : (1u << to) - 1u) & ~((1u << from) - 1u);
        b1 &= in_chunk;
        b2only &= in_chunk;
      }
      const int pos = (g << 5) + lane;
      if ((b1 >> lane) & 1u) {
        const int rank = r1rank + __popc(b1 & below);
        if (rank < budget) {
          out_idx[base + rank] = (int16_t)pos;
          out_valid[base + rank] = 1;
          out_m1[base + rank] = 1;
        }
      }
      if ((b2only >> lane) & 1u) {
        const int rank = c1 + r2rank + __popc(b2only & below);
        if (rank < budget) {
          out_idx[base + rank] = (int16_t)pos;
          out_valid[base + rank] = 1;
          out_m1[base + rank] = 0;
        }
      }
      r1rank += __popc(b1);
      r2rank += __popc(b2only);
    }
    base += min(ccnt[c], budget);
  }
  for (int s = base + lane; s < k2; s += 32) {
    out_idx[s] = (int16_t)q_first;
    out_valid[s] = 0;
    out_m1[s] = 0;
  }
}

}  // namespace

extern "C" int unopose_first_k_select(const float* pts, const float* pts_p, const int* perm,
                                      const int* inv_perm, int batch, int n, int k1, int k2,
                                      float r1sq, float r2sq, int16_t* idx_p,
                                      uint8_t* validslot, uint8_t* m1slot, int* cnt1, int* enc1,
                                      int* total2, int* q_first, int* overflow,
                                      cudaStream_t stream) {
  if (n > kMaxN || n % kChunks != 0 || k2 % kChunks != 0 || k2 > n) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)batch * n;
  if (rows == 0) return 0;
  const unsigned blocks = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  auto kernel = n % (32 * kChunks) == 0 ? first_k_select_kernel<true> : first_k_select_kernel<false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      pts, pts_p, perm, inv_perm, batch, n, k2 / kChunks, k1, k2, r1sq, r2sq, idx_p,
      validslot, m1slot, cnt1, enc1, total2, q_first, overflow);
  return (int)cudaGetLastError();
}
