// Fine-PE MLP and pool: per point and scale, the folded-BatchNorm MLP
// 6 -> 32 -> 64 -> 128 (bf16 operands, float32 accumulation, bias + ReLU and
// a bf16 cast after each layer) over the point's slots, then the max over
// the slots whose multiset weight is > 0. Output (B, P, 256) float32: scale 1
// in channels 0-127, scale 2 in 128-255, ahead of the PE's output Dense.
//
// Replaces the TPU kernel B of unopose_tpu/ops/pe_fused.py:pe_fused_v5
// (_pe_kernel_mlp_v5). The TPU kernel packs both scales into one
// block-diagonal 12 -> 64 -> 128 -> 256 MLP to fill its 128 x 128 matrix unit
// and runs it on 64-slot chunks of 128 points. Here the two scales run
// separately, which halves the products (the off-diagonal blocks contribute
// exact zeros), on the tensor cores with mma.sync m16n8k16 bf16. A warp walks
// its points' items in order, an item being one scale of one 64-slot chunk:
// - Only kept slots. The chunk's slots whose weight is > 0 are packed to its
//   front (ballot ranks, their slot indices in the warp's 64 bytes of shared
//   memory) and only ceil(kept / 16) m-tiles of 16 of them run (on the main
//   path's clouds ~5 of 64 slots are kept in scale 1 and ~32 in scale 2); a
//   masked slot never decides a max. A row of the last m-tile past the
//   kept ones repeats the first kept slot, so no row is masked.
// - Products in registers. Each of an m-tile's B fragments is read from the
//   weights in shared memory by ldmatrix (x4: two n-tiles, or one n-tile's
//   two k-steps), and a layer's float32 accumulator fragment, biased, ReLU'd
//   and packed to bf16 pairs, is the next layer's A fragment. Layers 1 and 2
//   read their biases into registers once per m-tile. (Sharing each B
//   fragment among an item's m-tiles reads shared memory a quarter as often
//   but needs four times the A and accumulator registers and code for each
//   count of m-tiles: it is slower, tools/kernel_variants.py's b64.)
// - The max on raw sums. The last layer goes n-tile by n-tile into a running
//   max of its raw sums over the rows: bias + ReLU + bf16 rounding is
//   monotone non-decreasing, so applied once per column after the max across
//   the lanes it gives, bit for bit, the max of the per-slot outputs (and 0,
//   relu of -inf, for a scale with no kept slot).
// - Loads ahead. While an item's products run, the next item's kept rows
//   (its layer-1 A words) are copied by cp.async into the warp's second
//   buffer in shared memory (held in registers instead, they make the
//   80-register build spill) and the weights of the one after it are loaded.
// - Balance. A block takes a contiguous share of the points, and its warps
//   take them one by one from a counter in shared memory, so a point of 4
//   chunks and one of 1 spread over the block's warps.
// The weights of both scales, transposed to (out, in) with K padded to 16 for
// the first layer and each row padded by 8 bf16 (conflict-free ldmatrix
// rows), sit in shared memory (51 KB) for a persistent grid of 3 blocks of 8
// warps an SM (67 KB each with the warps' buffers). The output is the first
// design's (pe_common.cuh:point_pool, which K21 shares) bit for bit: the
// same products in the same k-step order, the same roundings and the max
// over the same values.
//
// A point runs ceil(total2 / 64) 64-slot chunks (at least one), the slots
// the channels kernel (pe_channels.cu) wrote: every slot past total2 has
// weight 0 in both scales, so the pool equals the TPU kernel's over its
// block tier.
//
// Bound: operations. 2 x (6*32 + 32*64 + 64*128) = 20.9 kFLOP of bf16
// products per kept slot and scale (~53 GFLOP on the main path's cubes at
// B = 32, N = 2048, ~0.054 ms at 989 TFLOP/s), against 4 bytes of weights
// read per slot of the needed chunks, 12 bytes of channels per kept slot and
// scale and 1 KB written per point (~115 MB, ~0.034 ms at 3.35 TB/s).
// mma.sync reaches about half the tensor cores' wgmma rate; the
// padding of the first layer (K 6 -> 16) and of each item's last m-tile is
// not counted in the bound.

#include "pe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 3;  // blocks an SM (24 warps): at most 80 registers a thread
constexpr int kChunk = 64;  // slots a warp carries at once
constexpr int kTiles = kChunk / 16;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// pe_common.cuh's mma_bf16 without volatile: the compiler may schedule these products like any arithmetic
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// An item is one scale of one 64-slot chunk of a point.
struct Item {
  long long pt;
  int sc, ch, chunks;  // chunks: the point's
};

// the item's slot weights as a lane holds them: the raw bf16 of slots lane and 32 + lane of its chunk
__device__ __forceinline__ void load_weights(const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
                                             const Item& it, int s2, unsigned short& wlo, unsigned short& whi) {
  const unsigned short* wm =
      reinterpret_cast<const unsigned short*>(it.sc ? w2 : w1) + it.pt * s2 + it.ch * kChunk + (threadIdx.x & 31);
  wlo = wm[0];
  whi = wm[32];
}

// The chunk's kept slots (weight > 0) packed to its front in slot order: sidx[j] (the warp's 64 bytes of
// shared memory) is the slot of the j-th of their n; returns the m-tiles of 16 rows they fill. A masked slot
// never decides a max, so the products run only on kept slots.
__device__ __forceinline__ int compact(unsigned short wlo, unsigned short whi, unsigned char* sidx, int& n) {
  const int lane = threadIdx.x & 31;
  const bool klo = __bfloat162float(__ushort_as_bfloat16(wlo)) > 0.0f;
  const bool khi = __bfloat162float(__ushort_as_bfloat16(whi)) > 0.0f;
  const unsigned lo = __ballot_sync(kAll, klo), hi = __ballot_sync(kAll, khi), below = (1u << lane) - 1u;
  const int nlo = __popc(lo);
  n = nlo + __popc(hi);
  __syncwarp();  // the previous chunk's reads of sidx are done
  if (klo) sidx[__popc(lo & below)] = (unsigned char)lane;
  if (khi) sidx[nlo + __popc(hi & below)] = (unsigned char)(32 + lane);
  __syncwarp();
  return (n + 15) >> 4;
}

// The layer-1 A words of an item's first 16 * tiles packed rows (lane t < 3: channels 6 sc + 2t, +1 of the
// rows 16 mt + g and 16 mt + g + 8), copied by cp.async into the lane's words buf[(2 mt + h) * 32 + lane] of
// the warp's buffer (lane t = 3's stay 0: K's padding) as one commit group. A row past the n kept ones reads
// the first kept slot's: its outputs repeat that slot's and never change a max, so no row needs a mask.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ chans, const Item& it, int s2, int tiles,
                                          int n, const unsigned char* sidx, uint32_t* buf) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* c = chans + (it.pt * s2 + it.ch * kChunk) * 12 + 6 * it.sc + 2 * t;
  for (int mt = 0; mt < tiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = mt * 16 + g + 8 * h;
      if (t < 3)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(static_cast<uint32_t>(
                         __cvta_generic_to_shared(buf + (2 * mt + h) * 32 + lane))),
                     "l"(c + sidx[j < n ? j : 0] * 12)
                     : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The next point of the block's range for the calling warp (all its lanes), from the block's counter in
// shared memory: a warp takes its next point when it has finished the last, so the warps of a block share
// its points' unequal costs; past the range, last.
__device__ __forceinline__ long long take_point(unsigned long long* s_next, long long last) {
  unsigned long long v = 0;
  if ((threadIdx.x & 31) == 0) v = atomicAdd(s_next, 1ull);
  return min((long long)__shfl_sync(kAll, v, 0), last);
}

// the item after it in a warp's walk: each scale's chunks, then the warp's next point, whose chunk count is
// read here
__device__ __forceinline__ Item next_item(const Item& it, const int* __restrict__ total2, unsigned long long* s_next,
                                          long long last, int s2) {
  Item n = it;
  if (++n.ch == it.chunks) {
    n.ch = 0;
    n.sc = it.sc ^ 1;
    if (it.sc == 1) {
      n.pt = take_point(s_next, last);
      n.chunks = n.pt < last ? max(1, min((total2[n.pt] + 63) >> 6, s2 >> 6)) : 0;
    }
  }
  return n;
}

// the lane's layer-1 and layer-2 biases of one scale (B0: its biases in shared memory)
__device__ __forceinline__ void load_bias(const float* B0, float (&b0)[8], float (&b1)[16]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float2 v = *reinterpret_cast<const float2*>(B0 + nt * 8 + 2 * t);
    b0[2 * nt] = v.x, b0[2 * nt + 1] = v.y;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 v = *reinterpret_cast<const float2*>(B0 + 32 + nt * 8 + 2 * t);
    b1[2 * nt] = v.x, b1[2 * nt + 1] = v.y;
  }
}

// one m-tile of packed rows (a: its layer-1 A words) through the scale's three layers (W0 / B0: its packed
// weights and biases in shared memory; layers 1 and 2's biases are read into registers once) into the running
// max mx of this lane's columns of the raw layer-3 sums
__device__ __forceinline__ void mlp_mtile(const uint32_t (&a)[2], const __nv_bfloat16* W0, const float* B0,
                                          float (&mx)[16][2]) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  const __nv_bfloat16* W1 = W0 + kW0;
  const __nv_bfloat16* W2 = W1 + kW1;
  float b0[8], b1[16];
  load_bias(B0, b0, b1);
  // layer 1: 6 -> 32, K zero-padded to 16; an ldmatrix.x4 gives n-tiles 2np and 2np + 1, both k halves
  const uint32_t af[4] = {a[0], a[1], 0u, 0u};
  uint32_t a2[2][4];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t bq[4];
    ldsm_x4(bq, W0 + ((2 * np + (i >> 1)) * 8 + r) * kLd0 + (i & 1) * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * np + h;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma16816(c, af, bq[2 * h], bq[2 * h + 1]);
      a2[nt >> 1][(nt & 1) * 2] = relu_pack(c[0] + b0[2 * nt], c[1] + b0[2 * nt + 1]);
      a2[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[2] + b0[2 * nt], c[3] + b0[2 * nt + 1]);
    }
  }
  // layer 2: 32 -> 64; an ldmatrix.x4 gives one n-tile's two k-steps
  uint32_t a3[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    uint32_t bq[4];
    ldsm_x4(bq, W1 + (nt * 8 + r) * kLd1 + i * 8);
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) mma16816(c, a2[kt], bq[2 * kt], bq[2 * kt + 1]);
    a3[nt >> 1][(nt & 1) * 2] = relu_pack(c[0] + b1[2 * nt], c[1] + b1[2 * nt + 1]);
    a3[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(c[2] + b1[2 * nt], c[3] + b1[2 * nt + 1]);
  }
  // layer 3: 64 -> 128, n-tile by n-tile into the running max of the raw sums
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    uint32_t bq[2][4];
    ldsm_x4(bq[0], W2 + (nt * 8 + r) * kLd2 + i * 8);
    ldsm_x4(bq[1], W2 + (nt * 8 + r) * kLd2 + 32 + i * 8);
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) mma16816(c, a3[kt], bq[kt >> 1][(kt & 1) * 2], bq[kt >> 1][(kt & 1) * 2 + 1]);
    mx[nt][0] = fmaxf(mx[nt][0], fmaxf(c[0], c[2]));
    mx[nt][1] = fmaxf(mx[nt][1], fmaxf(c[1], c[3]));
  }
}

// The running max reduced across the 8 row groups, then bias + ReLU + bf16 rounding once per column
// (B2: the scale's layer-3 biases), stored to out[0..127]; mx is reset for the next point and scale.
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
      *reinterpret_cast<float2*>(out + col) = make_float2(relu_bf16(mx[nt][0] + B2[col]), relu_bf16(mx[nt][1] + B2[col + 1]));
    }
    mx[nt][0] = mx[nt][1] = neg_inf();
  }
}

__global__ void __launch_bounds__(kThreads, kBlocks)
pe_mlp_pool_kernel(const __nv_bfloat16* __restrict__ chans, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2, const int* __restrict__ total2,
                   const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack,
                   float* __restrict__ out, long long points, int s2) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_b = reinterpret_cast<float*>(s_w + 2 * kWScale);
  unsigned long long* s_next = reinterpret_cast<unsigned long long*>(s_b + 2 * kBScale);
  // the warp's two buffers of A words (an item's and the next one's), [2][kTiles * 2][32], then its sidx
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* abuf = reinterpret_cast<uint32_t*>(s_next + 1) + warp * 2 * kTiles * 2 * 32;
  unsigned char* sidx = reinterpret_cast<unsigned char*>(reinterpret_cast<uint32_t*>(s_next + 1) +
                                                         kWarps * 2 * kTiles * 2 * 32) + warp * kChunk;
  for (int i = 0; i < 2 * kTiles * 2; ++i) abuf[i * 32 + lane] = 0u;
  // the block's points: a contiguous range of the persistent grid's equal shares
  const long long share = (points + gridDim.x - 1) / gridDim.x, first = blockIdx.x * share;
  const long long last = min(points, first + share);
  for (int i = threadIdx.x; i < 2 * kWScale * 2 / 16; i += kThreads) smem[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < 2 * kBScale; i += kThreads) s_b[i] = bpack[i];
  if (threadIdx.x == 0) *s_next = (unsigned long long)first;
  __syncthreads();

  Item cur{take_point(s_next, last), 0, 0, 0};
  if (cur.pt >= last) return;
  cur.chunks = max(1, min((total2[cur.pt] + 63) >> 6, s2 >> 6));
  // the warp's items in order; while one item's products run, the next one's kept rows are loaded and the
  // weights of the one after it
  unsigned short wlo, whi;
  load_weights(w1, w2, cur, s2, wlo, whi);
  int n;
  int tiles = compact(wlo, whi, sidx, n), b = 0;
  load_rows(chans, cur, s2, tiles, n, sidx, abuf);
  Item nxt = next_item(cur, total2, s_next, last, s2);
  if (nxt.pt < last) load_weights(w1, w2, nxt, s2, wlo, whi);
  float mx[16][2];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) mx[nt][0] = mx[nt][1] = neg_inf();
  while (true) {
    const bool more = nxt.pt < last;
    int ntiles = 0;
    if (more) ntiles = compact(wlo, whi, sidx, n);
    load_rows(chans, nxt, s2, ntiles, n, sidx, abuf + (b ^ 1) * kTiles * 2 * 32);  // an empty group past the last
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this item's words have landed
    const Item after = more ? next_item(nxt, total2, s_next, last, s2) : nxt;
    if (more && after.pt < last) load_weights(w1, w2, after, s2, wlo, whi);

    const __nv_bfloat16* W0 = s_w + cur.sc * kWScale;
    const float* B0 = s_b + cur.sc * kBScale;
    const uint32_t* ab = abuf + b * kTiles * 2 * 32 + lane;
    for (int q = 0; q < tiles; ++q) {  // the packed m-tiles one by one (none where no slot is kept)
      const uint32_t aq[2] = {ab[2 * q * 32], ab[(2 * q + 1) * 32]};
      mlp_mtile(aq, W0, B0, mx);
    }
    if (cur.ch == cur.chunks - 1) store_pool(mx, B0 + 96, out + cur.pt * 256 + cur.sc * 128);
    if (!more) break;
    cur = nxt;
    nxt = after;
    tiles = ntiles;
    b ^= 1;
  }
}

}  // namespace

// wpack: both scales' transposed, padded bf16 weights (2 x kWScale); bpack:
// their float32 biases (2 x kBScale); chans 4-byte aligned
extern "C" int unopose_pe_mlp_pool(const void* chans, const void* w1, const void* w2, const int* total2,
                                   const void* wpack, const float* bpack, float* out, long long points, int s2,
                                   cudaStream_t stream) {
  if (s2 > kMaxSlots || s2 % 64 != 0 || s2 == 0) return (int)cudaErrorInvalidValue;
  if (points == 0) return 0;
  const size_t smem = (size_t)2 * kWScale * sizeof(__nv_bfloat16) + (size_t)2 * kBScale * sizeof(float) +
                      sizeof(unsigned long long) + (size_t)kWarps * (2 * kTiles * 2 * 32 * 4 + kChunk);
  cudaError_t err = cudaFuncSetAttribute(pe_mlp_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_mlp_pool_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (points + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  pe_mlp_pool_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(chans), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), total2, static_cast<const __nv_bfloat16*>(wpack), bpack, out, points,
      s2);
  return (int)cudaGetLastError();
}
