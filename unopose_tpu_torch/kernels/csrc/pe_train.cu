// Fine-PE train stack: per cloud and scale, the shared MLP 6 -> 32 -> 64 ->
// 128 with batch-statistics BatchNorm (flax's: biased fast variance
// E[z^2] - E[z]^2 clipped at 0, eps 1e-5) and ReLU after each layer, then
// the max over each point's S slots, forward and backward. Five kernels:
//
//   K11 pe_train_stats (depth d = 1, 2, 3): recompute the chain below layer
//       d with the affines of the layers above, and the sums of z and z^2
//       per channel of layer d from the Gram sums of its input
//       (stats_wg_kernel, warpgroup products);
//   K12 pe_train_fwd: the whole chain, the max over the slots and its tie
//       count per (point, channel) (fwd_wg_kernel, warpgroup products);
//   K13 pe_train_bwd_sums (layer L = 3, 2, 1): recompute the chain, the
//       pool backward (ties split evenly) and the BN backward of the layers
//       below L, then sum g and g * zhat of layer L (its dbeta and dgamma);
//   K14 pe_train_bwd_dw: recompute everything, every layer's dz, and the
//       weight gradients dW_l = y_{l-1}^T dz_l (dw_wg_kernel, warpgroup
//       products);
//   K18 pe_train_frozen_bwd: the backward of the frozen-BN variant, whose BN
//       normalises with the running statistics (constants): one sweep that
//       recomputes the chain, takes the pool backward and, per layer, g =
//       dy relu', dz = a g (a = gamma / sigma, no batch-statistics terms),
//       the sums of g (dbeta) and g zhat (dgamma), and K14's dW; its
//       forward is K12 on an affine filled from the running statistics.
//
// Replaces the TPU kernels of unopose_tpu/ops/pe_train.py:
// pe_mlp_bn_pool_train (_kernel_stats, _kernel_fwd, _kernel_bwdA,
// _kernel_bwdB) and pe_mlp_bn_pool_frozen (_kernel_fwd,
// _kernel_bwd_frozen), with the same pass structure and rounding points: chans,
// W, the post-ReLU activations and dz are rounded to bf16 before each
// product, products accumulate in float32 (mma.sync m16n8k16 or wgmma
// m64nNk16, in the same k order: the same bits), and the statistics, zhat
// and the affines are float32.
//
// K12 and K14 (fwd_wg_kernel, dw_wg_kernel) run the chain on warpgroup
// products: a warpgroup takes a 64-slot tile of a point, its layers as
// wgmma m64n32k16, m64n64k16 x 2 and m64n64k16 x 4 twice (layer 3 in two
// halves, the second's products in flight during the first's epilogue), A
// from registers (the previous layer's accumulators, affine'd and packed to
// bf16 with the ReLU, are mma.sync's A fragments) and B by descriptor from
// one copy of the weights in shared memory (8 x 8 core matrices, no
// swizzle), which the backward reads again MN-major for W^T (dy2 = dz3 W3^T
// m64n64k16 x 8, dy1 = dz2 W2^T m64n32k16 x 4). K12: four warpgroups a
// block, 16 warps an SM; a thread's running max and tie count of its 32
// channels sit in its row of shared memory (a row pair of a column is one
// max and one compare: the ReLU comes after the max), merged per point in a
// fixed order; pooled and cnt are the first design's bits. K14: two chain
// warpgroups (K12's forward, then dz3, dy2, dz2, dy1 and dz1, each tile's
// chans, y1, y2 and dz staged in its stage of a ring of two) and a dW
// warpgroup that accumulates dW3 (M 64, N 128), dW2^T and dW1^T over the
// staged tiles with A and B both by descriptor, and makes the chains' pool
// rows; 12 warps an SM. What holds them back: K12 the compare-and-select
// work of the max and tie count beside the products (more warps an SM did
// not help), K14 the chains' CUDA-core epilogues (dz3's pool and BN
// backward) and their five product waits a tile, with two chain
// warpgroups an SM (registers); the dW warpgroup waits most of the time.
// Both run the forward through one function (forward_tile). Their products
// overlap other warpgroups' epilogues, not their own: two warpgroups taking
// turns on named barriers (0.420 ms at S 256) and two tiles a warpgroup a
// layer apart (0.485) lost to four independent warpgroups (0.398; PERF.md).
// tools/kernel_variants.py builds other warpgroup counts, rings and chain
// counts beside them.
//
// K11 (moments_kernel at depth 1, stats_wg_kernel at 2 and 3) takes layer d's sums from its input's Gram sums:
// with Y the bf16 input of layer d (chans, y1 or y2) and w_c column c of W_d
// rounded to bf16, z_c = w_c . y, so the sum of z_c is w_c . (the sum of Y)
// and the sum of z_c^2 is w_c^T (Y^T Y) w_c. A warpgroup runs the chain
// below layer d on a 64-slot tile as forward_tile does, stages Y with a ones
// feature in dw_wg_kernel's layout and adds the product Y^T [Y | 1] (wgmma,
// A and B from the stage; M 64, N 40 or 72) to float32 totals in its
// registers, one product a tile, so that no accumulation runs long in the
// tensor cores; the tiles' chans come by 16-byte cp.async, a ring of four a
// warp. A block adds its warpgroups' totals in order and takes each
// channel's two sums from them in double; the last block to finish (a
// counter in device memory that it resets) adds the blocks' rows in block
// order into the statistics, so one launch does the pass and the finish. A
// tile at depth 3 is 2 x (16 x 32 + 32 x 64 + 64 x 72) = 14,336 FLOP a slot
// against the chain's 20,864 and no per-element epilogue of layer d; at
// depths 1 and 2 the pass reads the 100 MB of chans once; at depth 1 the 6 x 6 Gram sums of the chans take
// the CUDA cores only (a warpgroup tile's barrier and product round trips cost more than that read). Against the
// direct sums the Gram form's float32 totals of nonnegative products (y is
// past a ReLU) moved the variance by at most 1.7e-5 of itself on the card
// (the gate is 1e-4; PERF.md). What still holds it back: a tile's chain of
// wgmma round trips, its barrier and its fence, which cost more than the
// first design's independent warps at depth 2, and at depth 3 the CUDA-core
// epilogues of layers 1 and 2.
//
// K13 and K18 run one template body (pe_train_kernel), whose kFwd and
// kBwdDw modes are K12's and K14's first designs (the mma_sync builds of
// tools/kernel_variants.py). A persistent grid of blocks loops over the
// points; each warp owns one point at a time and runs its S slots 16 at a
// time (an m-tile) through the three layers in registers: a layer's float32
// accumulator fragment, affine'd and packed to bf16 pairs with the ReLU in
// the conversion, is the next layer's A fragment. Each block writes its partial sums to a scratch row and a second
// kernel of the same launch adds the rows in block order (in double), so a
// run is deterministic; the rows' rounding follows the block count, which
// follows the occupancy.
//
// What holds the backward back on this card is the warps an SM, the
// instructions beside the products and the shared-memory traffic of every
// warp's fragments; the design:
// - Warps. Nothing that can be recomputed or read back is held: the backward
//   takes z1 and z2 for zhat from the bf16 A fragments again (the forward's
//   products in the forward's k order, so the same bits), and dz3, dz2 and
//   y2 (dy2's ReLU gates) from its staging in shared memory, in groups of 4
//   n-tiles of dy (K13) or 8 (K14, K18). K11-K13 are held to 128 registers
//   (two blocks of 8 warps an SM); K14 and K18 run one block of 16 warps an
//   SM, the most whose staging fits.
// - Fragments. Every B fragment is an ldmatrix.x4 from one copy of the
//   weights, (out, in) rows padded by 8 bf16 (conflict-free rows): the
//   forward's two n-tiles or k-steps a load, the backward's W^T the same rows
//   read transposed. Per layer and column pair, the constants (a, b), (mu,
//   1/sigma), (sum g, sum g zhat) / n and the point's pool row (its max and
//   cotangent share) are one float4 each, one 128-bit load for a lane's two
//   columns.
// - Loads ahead. The next m-tile's chans (lane t < 3: planes 2t, 2t + 1 at
//   rows g, g + 8) are loaded into registers while this one's products run,
//   across the point boundary too.
// - Two m-tiles a step where the pass stops at the pool (K13's layer 3): each
//   B fragment serves both, whose product chains run side by side.
// - The pool backward. A point's max and share are read once per point into
//   the warp's pool row, the max replaced by NaN where it is 0 (no slot's y3
//   is above 0 there, so no slot takes a share): a slot takes the share where
//   its pre-activation equals the row's value, one compare for the forward's
//   (y == max) && (pre > 0). The forward's max and tie count come from K12,
//   whose y3 the recompute repeats bit for bit (-fmad=false for every source).
// - Sums. The sums of g zhat are taken as 1/sigma sum g (z - mu), the
//   product by fused multiply-adds and 1/sigma applied once per channel in
//   the second pass (the per-element values that feed dz keep their
//   roundings). Each step reduces an n-tile pair's 32 sums over the warp's
//   row groups by a fixed shuffle tree (7 shuffles) into one register a lane
//   for the whole run: 2-8 registers for K13's layer, 14 for K18's three.
// - The dW passes (K14, K18). A block's 16 warps stage their 16-slot tiles of
//   chans, y1, y2, dz1, dz2 and dz3 in shared memory transposed (feature rows,
//   256 slot columns) by stmatrix.trans, one instruction per 16 x 16 tile;
//   the warp reads its dz3 and dz2 back from there (ldmatrix.trans) for the
//   layer below. After a block barrier each warp multiplies its share of the
//   dW tiles over the block's 256 staged slots (ldmatrix fragments),
//   accumulating in registers for the whole run: dW3 4 tiles, dW2 1, dW1 one
//   n-tile over a quarter of the slots.
//
// Several ranks (parallel/mesh.py). Under data parallelism the statistics
// and the backward's centering terms span the global batch, as GSPMD's
// BatchNorm does in the JAX package. K11 then runs as two entry points: the
// pass with the blocks' rows added per channel in double (by its last block)
// into the host's sums (unopose_pe_train_stats_partial), which the host all-reduces
// across the ranks, and the finish from the reduced sums
// (unopose_pe_train_stats_finish, over the global count R B P S): the same
// sums and the same float32 arithmetic as unopose_pe_train_stats, which
// world size 1 keeps. K13's outputs are linear in its sums once the forward's
// 1/sigma is global, so it keeps its one call and the host all-reduces the
// layer's sum g and sum g zhat rows of bn in place. load_quads divides those
// sums by the count that the host writes as 1/n into the buffer's spare row
// (kInvN, layer 0, column 0; 0 there means the local count B P S): K13's and
// K14's centering terms take the global count, their signatures unchanged.
//
// Bound: operations. A chain is 10,432 MACs a slot: at B = 8, P = 2048,
// S = 256 (4.19 M slots) 87.5 GFLOP, 0.088 ms at 989 TFLOP/s (K11 at depth
// 3 counted so, though its Gram form does 0.69 of it); K11 at depth
// 1 and 2 is bound by reading the 100 MB of float32 chans (0.030 ms), K14
// and K18 do 62,208 FLOP a slot (0.26 ms). mma.sync from registers reaches
// about half the tensor cores' wgmma rate; the bf16 rounding, affine and
// gating of every element run on the CUDA cores beside the products, which
// no product shape takes off them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

// the template's passes (their numbers name the instantiations whose ptxas lines tools/kernel_variants.py reads)
enum Mode { kFwd = 1, kBwdSums = 2, kBwdDw = 3, kBwdFrozen = 4 };
// rows of the per-layer statistics buffer bn (3, kBnRows, 128), ops/pe_train.py
// (kInvN: 1/n of the count the sums of g and g zhat are divided by, layer 0 column 0; 0 for the local B P S)
enum BnRow { kMu = 0, kVar = 1, kInv = 2, kA = 3, kB = 4, kSg = 5, kSgz = 6, kInvN = 7, kBnRows = 8 };

__host__ __device__ constexpr bool has_dw(int mode) { return mode == kBwdDw || mode == kBwdFrozen; }
// warps a block: 16 for the passes that stage their slots for the dW products (one block an SM), else 8
__host__ __device__ constexpr int warps_of(int mode) { return has_dw(mode) ? 16 : 8; }
// blocks an SM a build is held to (at most 65536 / (threads x blocks) registers a thread): two blocks of 8 warps,
// or one of 16
__host__ __device__ constexpr int min_blocks_of(int mode) { return has_dw(mode) ? 1 : 2; }
// whether a backward pass reads its dz3 and dz2 back from the staging for the layer below (else holds them)
__host__ __device__ constexpr bool reads_dz_back(int mode) { return mode == kBwdSums || has_dw(mode); }
// the n-tiles of a dy accumulated together (even): more read each staged dz k-step back fewer times, fewer hold
// fewer accumulators
__host__ __device__ constexpr int group_of(int mode, int depth) { return has_dw(mode) ? 8 : 4; }
// whether a backward pass sums g and g zhat at a layer: K13 at its own, K18 at every layer
__host__ __device__ constexpr bool sums_at(int mode, int depth, int layer) {
  return mode == kBwdFrozen || (mode == kBwdSums && depth == layer);
}
// the m-tiles a warp takes through the forward at once, each B fragment serving all of them: K13's layer-3
// pass, whose backward stops at the pool (more would not fit its 128 registers)
__host__ __device__ constexpr int m_tiles_of(int mode, int depth) { return mode == kBwdSums && depth == 3 ? 2 : 1; }
__host__ __device__ constexpr int width_of(int layer) { return layer == 1 ? 32 : layer == 2 ? 64 : 128; }

// bf16 weights in shared memory: each layer's (out, in) rows, layer 1's K padded 6 -> 16, each row padded by
// 8 bf16 for conflict-free ldmatrix rows
constexpr int kLd0 = 16 + 8, kLd1 = 32 + 8, kLd2 = 64 + 8;
constexpr int kOff1 = 32 * kLd0, kOff2 = kOff1 + 64 * kLd1, kWElems = kOff2 + 128 * kLd2;
// per layer, kind and column pair (2p, 2p + 1) one float4: (a, a, b, b), (mu, mu, inv, inv),
// (sum g / n, sum g / n, sum g zhat / n, sum g zhat / n)
enum QKind { kQAb = 0, kQMuInv = 1, kQG = 2 };
constexpr int kQuads = 3 * 3 * 64;
// The staging: feature rows x (the block's warps x 16 slots) bf16, transposed, each row padded by 8 bf16. K14
// and K18 stage chans (rows 6, 7 zero), y1, y2, dz1, dz2 and dz3; K13 dz3, y2 (the ReLU gates of dy2) and dz2, as
// far as its pass reaches.
constexpr int kSChans = 0, kSY1 = 8, kSD1 = 104, kSRows = 328;
__host__ __device__ constexpr int st_ld(int mode) { return warps_of(mode) * 16 + 8; }
__host__ __device__ constexpr int st_d3(int mode) { return has_dw(mode) ? 200 : 0; }
__host__ __device__ constexpr int st_y2(int mode) { return has_dw(mode) ? 40 : 128; }
__host__ __device__ constexpr int st_d2(int mode) { return has_dw(mode) ? 136 : 192; }
__host__ __device__ constexpr int st_rows(int mode, int depth) {
  if (has_dw(mode)) return kSRows;
  return mode == kBwdSums && reads_dz_back(mode) ? (depth == 1 ? 256 : depth == 2 ? 192 : 0) : 0;
}
constexpr int kDW = 6 * 32 + 32 * 64 + 64 * 128;
constexpr int kDW2 = 6 * 32, kDW3 = 6 * 32 + 32 * 64;  // offsets of dW2 and dW3 in a dW row
// K18's sums of g and g zhat per layer (32, 64, 128 channels), each layer's g then its g zhat
constexpr int kSums = 2 * (32 + 64 + 128);
__host__ __device__ constexpr int sums_base(int layer) { return layer == 1 ? 0 : layer == 2 ? 64 : 192; }
// the sum registers (one a lane an n-tile pair): K13's layer's (at most 8), K18's of layers 1, 2, 3 from pair_base
constexpr int kPairRegs = 2 + 4 + 8;
__host__ __device__ constexpr int pair_base(int mode, int layer) {
  return mode == kBwdFrozen ? (layer == 1 ? 0 : layer == 2 ? 2 : 6) : 0;
}

// dynamic shared memory of a pass: the weights, the constants, each warp's pool row, the staging
__host__ __device__ constexpr size_t smem_bytes(int mode, int depth) {
  return (size_t)kWElems * 2 + (size_t)kQuads * 16 + (size_t)warps_of(mode) * 64 * 16 +
         (size_t)st_rows(mode, depth) * st_ld(mode) * 2;
}

// fragments of the weights (written once, before the first barrier)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}
// fragments of the staging, which the warps rewrite every m-tile: ordered with the stores
__device__ __forceinline__ void ldst4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}
__device__ __forceinline__ void ldst4t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}
__device__ __forceinline__ void ldst2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(saddr(p))
               : "memory");
}
// an A fragment (16 slots x 16 features, or x 8 for x2) stored transposed: feature rows, slot columns
__device__ __forceinline__ void stst4t(__nv_bfloat16* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(saddr(p)), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void stst2t(__nv_bfloat16* p, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(saddr(p)), "r"(r0), "r"(r1)
               : "memory");
}

// not volatile: the compiler may schedule the products like any arithmetic
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a bf16 pair, low half = lower column
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the ReLU and the bf16 pair in one conversion (a zero's sign aside, the bits of fmaxf(x, 0) rounded)
__device__ __forceinline__ uint32_t relu_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// the ReLU gate of a packed post-ReLU activation (y > 0; -0 is not positive)
__device__ __forceinline__ bool pos_lo(uint32_t v) { return (v & 0x7fffu) != 0u; }
__device__ __forceinline__ bool pos_hi(uint32_t v) { return (v & 0x7fff0000u) != 0u; }

// online max with a tie count
__device__ __forceinline__ void max_count(float& m, float& c, float v) {
  if (v > m) {
    m = v;
    c = 1.0f;
  } else if (v == m) {
    c += 1.0f;
  }
}

// the chans of point pt: plane c at + c * P * S (the point's index fits 32 bits, as it does for any chans that
// fit the card's memory: the division is the 32-bit one, not 64-bit code that costs registers)
__device__ __forceinline__ const float* point_chans(const float* chans, long long pt, int P, int S) {
  const unsigned b = (unsigned)pt / (unsigned)P, p = (unsigned)pt - b * (unsigned)P;
  return chans + ((long long)b * 6 * P + p) * S;
}

// lane t < 3's chans of the m-tile at slot s0: planes 2t and 2t + 1 at rows g and g + 8
__device__ __forceinline__ void load_tile(float (&v)[4], const float* cb, int s0, long long plane, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (t < 3) {
    const float* c = cb + 2 * t * plane + s0 + g;
    v[0] = c[0];
    v[1] = c[plane];
    v[2] = c[8];
    v[3] = c[plane + 8];
  }
}

// layer 2's (32 -> 64) B fragments of n-tile nt, both k-steps
__device__ __forceinline__ void b_layer2(uint32_t (&b)[4], const __nv_bfloat16* s_w, int nt, int lane) {
  ldsm4(b, s_w + kOff1 + (nt * 8 + (lane & 7)) * kLd1 + (lane >> 3) * 8);
}

// z of an n-tile of layer 2 from the layer's A fragments, in the forward's k order
__device__ __forceinline__ void z_layer2(float (&z)[4], const uint32_t (&a)[2][4], const uint32_t (&b)[4]) {
  z[0] = z[1] = z[2] = z[3] = 0.0f;
  mma(z, a[0], b[0], b[1]);
  mma(z, a[1], b[2], b[3]);
}

// layer 3's (64 -> 128) B fragments of n-tile nt, four k-steps
__device__ __forceinline__ void b_layer3(uint32_t (&b)[2][4], const __nv_bfloat16* s_w, int nt, int lane) {
  const __nv_bfloat16* row = s_w + kOff2 + (nt * 8 + (lane & 7)) * kLd2 + (lane >> 3) * 8;
  ldsm4(b[0], row);
  ldsm4(b[1], row + 32);
}

__device__ __forceinline__ void z_layer3(float (&z)[4], const uint32_t (&a)[4][4], const uint32_t (&b)[2][4]) {
  z[0] = z[1] = z[2] = z[3] = 0.0f;
  mma(z, a[0], b[0][0], b[0][1]);
  mma(z, a[1], b[0][2], b[0][3]);
  mma(z, a[2], b[1][0], b[1][1]);
  mma(z, a[3], b[1][2], b[1][3]);
}

// A lane's partials of one n-tile's sums over a step's m-tiles: g of its columns col, col + 1 over its rows
// g, g + 8, then g (z - mu) of them (by fused multiply-adds; the second pass applies the layer's 1/sigma)
template <int kM>
__device__ __forceinline__ void lane_partials(float* v, const float (&gv)[kM][4], const float (&zc)[kM][4]) {
  v[0] = v[1] = v[2] = v[3] = 0.0f;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    v[0] += gv[m][0] + gv[m][2];
    v[1] += gv[m][1] + gv[m][3];
    v[2] = __fmaf_rn(gv[m][2], zc[m][2], __fmaf_rn(gv[m][0], zc[m][0], v[2]));
    v[3] = __fmaf_rn(gv[m][3], zc[m][3], __fmaf_rn(gv[m][1], zc[m][1], v[3]));
  }
}

// The 32 sums of an n-tile pair (g and g (z - mu) of its 16 columns) from each lane's partials vp (the even
// n-tile's four, then the odd one's), reduced over the warp's 8 row groups by a fixed tree (lane bits 4, 3, 2:
// each step keeps half the values and hands the other half to the partner): the lane ends with the sum of n-tile
// (lane bit 4) of the pair, kind (bit 3: g, g (z - mu)) and column col + (bit 2)
__device__ __forceinline__ float pair_sums(const float (&vp)[8], int lane) {
  const bool b4 = (lane & 16) != 0, b3 = (lane & 8) != 0, b2 = (lane & 4) != 0;
  float k[4], k2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    k[i] = (b4 ? vp[4 + i] : vp[i]) + __shfl_xor_sync(0xffffffffu, b4 ? vp[i] : vp[4 + i], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i) k2[i] = (b3 ? k[2 + i] : k[i]) + __shfl_xor_sync(0xffffffffu, b3 ? k[i] : k[2 + i], 8);
  return (b2 ? k2[1] : k2[0]) + __shfl_xor_sync(0xffffffffu, b2 ? k2[0] : k2[1], 4);
}

// the channel of the sum pair_sums leaves on this lane, of pair p
__device__ __forceinline__ int pair_col(int p, int lane) {
  return (2 * p + ((lane >> 4) & 1)) * 8 + 2 * (lane & 3) + ((lane >> 2) & 1);
}

// One n-tile's dz of a layer from its g and centred z (z - mu), packed to bf16 pairs: a g (frozen BN) or
// a ((g - sum g / n) - zhat sum g zhat / n), zhat = (z - mu) inv (Q: the layer's constants)
template <int kMode>
__device__ __forceinline__ void tile_dz(const float4* Q, int nt, int lane, const float (&gv)[4], const float (&zc)[4],
                                        uint32_t (&dz)[2]) {
  const int p = nt * 4 + (lane & 3);
  const float4 ab = Q[kQAb * 64 + p];
  float d[4];
  if (kMode == kBwdFrozen) {
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = (j & 1 ? ab.y : ab.x) * gv[j];
  } else {
    const float4 q = Q[kQG * 64 + p], mq = Q[kQMuInv * 64 + p];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float zh = zc[j] * (j & 1 ? mq.w : mq.z);
      d[j] = (j & 1 ? ab.y : ab.x) * ((gv[j] - (j & 1 ? q.y : q.x)) - zh * (j & 1 ? q.w : q.z));
    }
  }
  dz[0] = pack(d[0], d[1]);
  dz[1] = pack(d[2], d[3]);
}

// The layers' constants into s_q ([layer][kind][pair], QKind), the sums of g and g zhat over the n slots (the
// host's count where it gave one, kInvN)
__device__ void load_quads(float4* s_q, const float* bn, int B, int P, int S) {
  const float host_inv_n = bn[kInvN * 128];
  const float inv_n = host_inv_n > 0.0f ? host_inv_n : (float)(1.0 / ((double)B * (double)P * (double)S));
  for (int i = threadIdx.x; i < 3 * 64; i += blockDim.x) {
    const int l = i >> 6, p = i & 63;
    const float* r = bn + l * kBnRows * 128 + 2 * p;
    float4* q = s_q + l * 3 * 64 + p;
    q[kQAb * 64] = make_float4(r[kA * 128], r[kA * 128 + 1], r[kB * 128], r[kB * 128 + 1]);
    q[kQMuInv * 64] = make_float4(r[kMu * 128], r[kMu * 128 + 1], r[kInv * 128], r[kInv * 128 + 1]);
    q[kQG * 64] = make_float4(r[kSg * 128] * inv_n, r[kSg * 128 + 1] * inv_n, r[kSgz * 128] * inv_n,
                              r[kSgz * 128 + 1] * inv_n);
  }
}

// Column pair p of a point's pool row from its max, tie count and cotangent rows: (max, max, share, share), the max
// NaN where it is 0 (no slot's y3 is above 0 there, so no slot takes a share), the share the cotangent over the
// tie count
__device__ __forceinline__ void pool_row(float4* pool, const float* mrow, const float* crow, const float* drow, int p) {
  const float nan = __int_as_float(0x7fffffff);
  const float2 m = *reinterpret_cast<const float2*>(mrow + 2 * p);
  const float2 c = *reinterpret_cast<const float2*>(crow + 2 * p);
  const float2 d = *reinterpret_cast<const float2*>(drow + 2 * p);
  pool[p] = make_float4(m.x > 0.0f ? m.x : nan, m.y > 0.0f ? m.y : nan, (1.0f / c.x) * d.x, (1.0f / c.y) * d.y);
}

template <int kMode, int kDepth>
__global__ void __launch_bounds__(warps_of(kMode) * 32, min_blocks_of(kMode))
pe_train_kernel(const float* __restrict__ chans, const float* __restrict__ w0, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ bn, const float* __restrict__ pooled_in,
                const float* __restrict__ cnt_in, const float* __restrict__ dpool, float* __restrict__ pooled_out,
                float* __restrict__ cnt_out, float* __restrict__ partial, int B, int P, int S) {
  constexpr int kWarps = warps_of(kMode), kThreads = kWarps * 32;
  // the layer whose per-channel sums K13 accumulates, and its n-tiles of 8 channels
  constexpr int kSumTiles = kMode == kBwdSums ? width_of(kDepth) / 8 : 1;
  constexpr bool kBackward = kMode == kBwdSums || has_dw(kMode);
  constexpr bool kDw = has_dw(kMode);  // the weight gradients, over staged tiles
  constexpr bool kFrozen = kMode == kBwdFrozen;
  constexpr int kLowest = kDw ? 0 : kDepth;  // the lowest layer the backward reaches
  constexpr bool kReadBack = reads_dz_back(kMode);
  constexpr int kLdS = st_ld(kMode), kSD2 = st_d2(kMode), kSD3 = st_d3(kMode), kSY2 = st_y2(kMode);
  constexpr int kGroup = group_of(kMode, kDepth);
  constexpr int kM = m_tiles_of(kMode, kDepth);  // the m-tiles of a step
  static_assert(kM == 1 || kLowest == 3, "a step of several m-tiles stops at the pool");

  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* s_q = reinterpret_cast<float4*>(s_w + kWElems);  // [layer][kind][pair]
  float4* s_pool = s_q + kQuads;                            // per warp: (max, max, share, share) per pair
  __nv_bfloat16* s_st = reinterpret_cast<__nv_bfloat16*>(s_pool + kWarps * 64);

  for (int i = threadIdx.x; i < 32 * kLd0; i += kThreads) {
    const int o = i / kLd0, k = i % kLd0;
    s_w[i] = __float2bfloat16_rn(k < 6 ? w0[k * 32 + o] : 0.0f);
  }
  for (int i = threadIdx.x; i < 64 * kLd1; i += kThreads) {
    const int o = i / kLd1, k = i % kLd1;
    s_w[kOff1 + i] = __float2bfloat16_rn(k < 32 ? w1[k * 64 + o] : 0.0f);
  }
  for (int i = threadIdx.x; i < 128 * kLd2; i += kThreads) {
    const int o = i / kLd2, k = i % kLd2;
    s_w[kOff2 + i] = __float2bfloat16_rn(k < 64 ? w2[k * 128 + o] : 0.0f);
  }
  load_quads(s_q, bn, B, P, S);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;                   // row group of the mma fragments
  const int t = lane & 3;                    // thread in group
  const int mi = lane >> 3, mr = lane & 7;   // the ldmatrix / stmatrix matrix and row this lane addresses
  const long long points = (long long)B * P;
  const long long plane = (long long)P * S;  // one channel of one cloud
  const int mtiles = S >> 4;
  const float4* Q1 = s_q;
  const float4* Q2 = s_q + 3 * 64;
  const float4* Q3 = s_q + 6 * 64;
  float4* pool = s_pool + warp * 64;
  // this lane's row of a staged 16 x 16 tile (feature rows, the warp's 16 slot columns) in an x4 stmatrix or
  // ldmatrix: add (first feature row) * kLdS
  __nv_bfloat16* st_lane = s_st + ((mi >> 1) * 8 + mr) * kLdS + warp * 16 + (mi & 1) * 8;

  float fs[kPairRegs];  // K13, K18: the sums of g and g (z - mu), one a lane an n-tile pair (pair_sums)
#pragma unroll
  for (int i = 0; i < kPairRegs; ++i) fs[i] = 0.0f;
  float dw3[4][4], dw2[4], dw1[4];  // K14's and K18's share of the dW tiles
#pragma unroll
  for (int j = 0; j < 4; ++j) dw3[j][0] = dw3[j][1] = dw3[j][2] = dw3[j][3] = dw2[j] = dw1[j] = 0.0f;

  const long long stride = (long long)gridDim.x * kWarps;
  long long pt = (long long)blockIdx.x * kWarps + warp;
  const float* cb = point_chans(chans, pt < points ? pt : 0, P, S);
  float nx[kM][4];  // the next step's chans, in flight
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    nx[m][0] = nx[m][1] = nx[m][2] = nx[m][3] = 0.0f;
    if (pt < points && m < mtiles) load_tile(nx[m], cb, m * 16, plane, lane);
  }
  for (long long base = (long long)blockIdx.x * kWarps; base < points; base += stride, pt += stride) {
    const bool active = pt < points;
    if (!kDw && !active) break;
    const long long npt = pt + stride;
    const float* nb = point_chans(chans, npt < points ? npt : 0, P, S);
    if (kBackward) {
      __syncwarp();
      if (active) {
        for (int p = lane; p < 64; p += 32) {
          pool_row(pool, pooled_in + pt * 128, cnt_in + pt * 128, dpool + pt * 128, p);
        }
      }
      __syncwarp();
    }
    float mx[16][2], ct[16][2];  // K12: running max and tie count per channel
    if (kMode == kFwd) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        mx[nt][0] = mx[nt][1] = __int_as_float(0xff800000);  // -inf
        ct[nt][0] = ct[nt][1] = 0.0f;
      }
    }

#pragma unroll 1
    for (int mt = 0; mt < mtiles; mt += kM) {
      bool live[kM];  // a step's m-tiles inside the point (the last of an odd count runs idle)
      uint32_t a1[kM][4];  // chans (bf16), K 6 padded to 16
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        live[m] = mt + m < mtiles;
        a1[m][0] = pack(nx[m][0], nx[m][1]);
        a1[m][1] = pack(nx[m][2], nx[m][3]);
        a1[m][2] = a1[m][3] = 0u;
      }
      // the next step's chans: this point's next m-tiles, else the warp's next point's first
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (mt + kM < mtiles) {
          if (active && mt + kM + m < mtiles) load_tile(nx[m], cb, (mt + kM + m) * 16, plane, lane);
        } else if (npt < points && m < mtiles) {
          load_tile(nx[m], nb, m * 16, plane, lane);
        }
      }
      if (active) {
        // layer 1: 6 -> 32; an ldmatrix.x4 gives the 4 n-tiles' k 0..7 (k 8..15 are K's zero padding)
        uint32_t bw1[4];
        ldsm4(bw1, s_w + (mi * 8 + mr) * kLd0);
        uint32_t a2[kM][2][4];  // y1 (bf16)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float4 q = Q1[nt * 4 + t];
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma(z, a1[m], bw1[nt], 0u);
            a2[m][nt >> 1][(nt & 1) * 2] = relu_pack(q.x * z[0] + q.z, q.y * z[1] + q.w);
            a2[m][nt >> 1][(nt & 1) * 2 + 1] = relu_pack(q.x * z[2] + q.z, q.y * z[3] + q.w);
          }
        }
        if (kDw) {
          stst2t(st_lane + kSChans * kLdS, a1[0][0], a1[0][1]);
          stst4t(st_lane + kSY1 * kLdS, a2[0][0]);
          stst4t(st_lane + (kSY1 + 16) * kLdS, a2[0][1]);
        }
        // layer 2: 32 -> 64
        uint32_t a3[kM][4][4];  // y2 (bf16)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t b[4];
          b_layer2(b, s_w, nt, lane);
          const float4 q = Q2[nt * 4 + t];
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            float z[4];
            z_layer2(z, a2[m], b);
            a3[m][nt >> 1][(nt & 1) * 2] = relu_pack(q.x * z[0] + q.z, q.y * z[1] + q.w);
            a3[m][nt >> 1][(nt & 1) * 2 + 1] = relu_pack(q.x * z[2] + q.z, q.y * z[3] + q.w);
          }
        }
        if (kReadBack && !kDw && kLowest < 3) __syncwarp();  // this warp's reads of the last m-tile's staging are done
        if (kDw || (kReadBack && kLowest < 3)) {
#pragma unroll
          for (int kt = 0; kt < 4; ++kt) stst4t(st_lane + (kSY2 + kt * 16) * kLdS, a3[0][kt]);
        }
        // layer 3: 64 -> 128, one n-tile of 8 channels at a time
        uint32_t d3[8][4];  // dz3 (bf16), staged or held
        float vp[8];        // an n-tile pair's lane partials of the sums
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          uint32_t b[2][4];
          b_layer3(b, s_w, nt, lane);
          float z[kM][4];
#pragma unroll
          for (int m = 0; m < kM; ++m) z_layer3(z[m], a3[m], b);
          const float4 ab = Q3[nt * 4 + t];
          if (kMode == kFwd) {
#pragma unroll
            for (int m = 0; m < kM; ++m) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float pre = (j & 1 ? ab.y : ab.x) * z[m][j] + (j & 1 ? ab.w : ab.z);
                if (live[m]) max_count(mx[nt][j & 1], ct[nt][j & 1], fmaxf(pre, 0.0f));
              }
            }
            continue;
          }
          const float4 pq = pool[nt * 4 + t];
          const float4 mq = Q3[kQMuInv * 64 + nt * 4 + t];
          float gv[kM][4], zc[kM][4];  // g and the centred z, z - mu
#pragma unroll
          for (int m = 0; m < kM; ++m) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float pre = (j & 1 ? ab.y : ab.x) * z[m][j] + (j & 1 ? ab.w : ab.z);
              gv[m][j] = pre == (j & 1 ? pq.y : pq.x) ? (j & 1 ? pq.w : pq.z) : 0.0f;  // the pool backward
              gv[m][j] = live[m] ? gv[m][j] : 0.0f;
              zc[m][j] = z[m][j] - (j & 1 ? mq.y : mq.x);
            }
          }
          if (sums_at(kMode, kDepth, 3)) {
            lane_partials(vp + (nt & 1) * 4, gv, zc);
            if (nt & 1) fs[pair_base(kMode, 3) + (nt >> 1)] += pair_sums(vp, lane);
          }
          if (kLowest < 3) {
            uint32_t dz[2];
            tile_dz<kMode>(Q3, nt, lane, gv[0], zc[0], dz);
            d3[nt >> 1][(nt & 1) * 2] = dz[0];
            d3[nt >> 1][(nt & 1) * 2 + 1] = dz[1];
            if ((kDw || kReadBack) && (nt & 1)) stst4t(st_lane + (kSD3 + (nt >> 1) * 16) * kLdS, d3[nt >> 1]);
          }
        }
        uint32_t d2[4][4];  // dz2 (bf16)
        if (kLowest < 3) {
          if (kReadBack) __syncwarp();  // dz3 is read back from the staging
          // dy2 = dz3 W3^T (W3's rows read transposed), kGroup n-tiles at a time, gated by y2 > 0
#pragma unroll
          for (int n0 = 0; n0 < 8; n0 += kGroup) {
            float dy[kGroup][4];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) dy[j][0] = dy[j][1] = dy[j][2] = dy[j][3] = 0.0f;
#pragma unroll
            for (int kt = 0; kt < 8; ++kt) {
              uint32_t a[4];
              if (kReadBack) {
                ldst4t(a, st_lane + (kSD3 + kt * 16) * kLdS);
              } else {
                a[0] = d3[kt][0], a[1] = d3[kt][1], a[2] = d3[kt][2], a[3] = d3[kt][3];
              }
#pragma unroll
              for (int j = 0; j < kGroup; j += 2) {
                uint32_t b[4];
                ldsm4t(b, s_w + kOff2 + (kt * 16 + (mi & 1) * 8 + mr) * kLd2 + (n0 + j + (mi >> 1)) * 8);
                mma(dy[j], a, b[0], b[1]);
                mma(dy[j + 1], a, b[2], b[3]);
              }
            }
            uint32_t y2[4];  // y2's k-tile of the n-tile pair: its ReLU gates
            float vp[8];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
              const int nt = n0 + j;
              uint32_t b[4];
              float z[4];
              b_layer2(b, s_w, nt, lane);
              z_layer2(z, a2[0], b);  // z2 again, the forward's bits
              if (!(nt & 1)) {
                if (kReadBack) {
                  ldst4t(y2, st_lane + (kSY2 + (nt >> 1) * 16) * kLdS);
                } else {
                  y2[0] = a3[0][nt >> 1][0], y2[1] = a3[0][nt >> 1][1], y2[2] = a3[0][nt >> 1][2];
                  y2[3] = a3[0][nt >> 1][3];
                }
              }
              const uint32_t y_g = y2[(nt & 1) * 2], y_g8 = y2[(nt & 1) * 2 + 1];
              const bool on[4] = {pos_lo(y_g), pos_hi(y_g), pos_lo(y_g8), pos_hi(y_g8)};
              const float4 mq = Q2[kQMuInv * 64 + nt * 4 + t];
              float gv[1][4], zc[1][4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                gv[0][k] = on[k] ? dy[j][k] : 0.0f;
                zc[0][k] = z[k] - (k & 1 ? mq.y : mq.x);
              }
              if (sums_at(kMode, kDepth, 2)) {
                lane_partials(vp + (nt & 1) * 4, gv, zc);
                if (nt & 1) fs[pair_base(kMode, 2) + (nt >> 1)] += pair_sums(vp, lane);
              }
              if (kLowest < 2) {
                uint32_t dz[2];
                tile_dz<kMode>(Q2, nt, lane, gv[0], zc[0], dz);
                d2[nt >> 1][(nt & 1) * 2] = dz[0];
                d2[nt >> 1][(nt & 1) * 2 + 1] = dz[1];
                if ((kDw || kReadBack) && (nt & 1)) stst4t(st_lane + (kSD2 + (nt >> 1) * 16) * kLdS, d2[nt >> 1]);
              }
            }
          }
        }
        if (kLowest < 2) {
          if (kReadBack) __syncwarp();  // dz2 is read back from the staging
          // dy1 = dz2 W2^T, gated by y1 > 0; z1 again from the chans' fragment
          ldsm4(bw1, s_w + (mi * 8 + mr) * kLd0);
          uint32_t d1[2][4];  // dz1 (bf16), K14 / K18 only
          constexpr int kGroup1 = kGroup < 4 ? kGroup : 4;
#pragma unroll
          for (int n0 = 0; n0 < 4; n0 += kGroup1) {
            float dy[kGroup1][4];
#pragma unroll
            for (int j = 0; j < kGroup1; ++j) dy[j][0] = dy[j][1] = dy[j][2] = dy[j][3] = 0.0f;
#pragma unroll
            for (int kt = 0; kt < 4; ++kt) {
              uint32_t a[4];
              if (kReadBack) {
                ldst4t(a, st_lane + (kSD2 + kt * 16) * kLdS);
              } else {
                a[0] = d2[kt][0], a[1] = d2[kt][1], a[2] = d2[kt][2], a[3] = d2[kt][3];
              }
#pragma unroll
              for (int j = 0; j < kGroup1; j += 2) {
                uint32_t b[4];
                ldsm4t(b, s_w + kOff1 + (kt * 16 + (mi & 1) * 8 + mr) * kLd1 + (n0 + j + (mi >> 1)) * 8);
                mma(dy[j], a, b[0], b[1]);
                mma(dy[j + 1], a, b[2], b[3]);
              }
            }
            float vp[8];
#pragma unroll
            for (int j = 0; j < kGroup1; ++j) {
              const int nt = n0 + j;
              float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma(z, a1[0], bw1[nt], 0u);  // z1 again, the forward's bits
              const uint32_t y_g = a2[0][nt >> 1][(nt & 1) * 2], y_g8 = a2[0][nt >> 1][(nt & 1) * 2 + 1];
              const bool on[4] = {pos_lo(y_g), pos_hi(y_g), pos_lo(y_g8), pos_hi(y_g8)};
              const float4 mq = Q1[kQMuInv * 64 + nt * 4 + t];
              float gv[1][4], zc[1][4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                gv[0][k] = on[k] ? dy[j][k] : 0.0f;
                zc[0][k] = z[k] - (k & 1 ? mq.y : mq.x);
              }
              if (sums_at(kMode, kDepth, 1)) {
                lane_partials(vp + (nt & 1) * 4, gv, zc);
                if (nt & 1) fs[pair_base(kMode, 1) + (nt >> 1)] += pair_sums(vp, lane);
              }
              if (kDw) {
                uint32_t dz[2];
                tile_dz<kMode>(Q1, nt, lane, gv[0], zc[0], dz);
                d1[nt >> 1][(nt & 1) * 2] = dz[0];
                d1[nt >> 1][(nt & 1) * 2 + 1] = dz[1];
                if (nt & 1) stst4t(st_lane + (kSD1 + (nt >> 1) * 16) * kLdS, d1[nt >> 1]);
              }
            }
          }
        }
      } else if (kDw) {  // a warp past the last point stages zeros
        for (int i = lane; i < kSRows * 2; i += 32)
          *reinterpret_cast<uint4*>(s_st + (i >> 1) * kLdS + warp * 16 + (i & 1) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
      if (kDw) {
        // every warp takes its dW tiles over the block's 256 staged slots
        __syncthreads();
#pragma unroll 4
        for (int ks = 0; ks < 16; ++ks) {
          const int k0 = ks * 16;
          uint32_t a[4], b[4], b2[2];
          // dW3 (64 x 128): row tile warp % 4, n-tiles 4 (warp / 4) ..
          ldst4(a, s_st + (kSY2 + (warp & 3) * 16 + (mi & 1) * 8 + mr) * kLdS + k0 + (mi >> 1) * 8);
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            ldst4(b, s_st + (kSD3 + ((warp >> 2) * 4 + j + (mi >> 1)) * 8 + mr) * kLdS + k0 + (mi & 1) * 8);
            mma(dw3[j], a, b[0], b[1]);
            mma(dw3[j + 1], a, b[2], b[3]);
          }
          // dW2 (32 x 64): row tile warp % 2, n-tile warp / 2
          ldst4(a, s_st + (kSY1 + (warp & 1) * 16 + (mi & 1) * 8 + mr) * kLdS + k0 + (mi >> 1) * 8);
          ldst2(b2, s_st + (kSD2 + (warp >> 1) * 8 + mr) * kLdS + k0 + (mi & 1) * 8);
          mma(dw2, a, b2[0], b2[1]);
        }
        // dW1 (6 x 32, rows padded to 16): n-tile warp % 4 over the k-steps of quarter warp / 4
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k0 = ((warp >> 2) * 4 + q) * 16;
          uint32_t x[2], b2[2];
          ldst2(x, s_st + (kSChans + mr) * kLdS + k0 + (mi & 1) * 8);
          ldst2(b2, s_st + (kSD1 + (warp & 3) * 8 + mr) * kLdS + k0 + (mi & 1) * 8);
          const uint32_t a[4] = {x[0], 0u, x[1], 0u};
          mma(dw1, a, b2[0], b2[1]);
        }
        __syncthreads();
      }
    }

    if (kMode == kFwd) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float m = mx[nt][j], c = ct[nt][j];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, m, off);
            const float oc = __shfl_xor_sync(0xffffffffu, c, off);
            if (om > m) {
              m = om;
              c = oc;
            } else if (om == m) {
              c += oc;
            }
          }
          if (g == 0) {
            pooled_out[pt * 128 + nt * 8 + 2 * t + j] = m;
            cnt_out[pt * 128 + nt * 8 + 2 * t + j] = c;
          }
        }
      }
    }
    cb = nb;
  }

  if (kMode == kBwdSums) {
    // per block: the row groups by shuffles, the warps in order through shared memory (each warp's pool row)
    float* s_red = reinterpret_cast<float*>(s_pool);
    float* red = s_red + warp * 256;
    // pair_sums' lanes hold the warp's sums: g, then g (z - mu)
#pragma unroll
    for (int p = 0; p < kSumTiles / 2; ++p) red[(lane & 8 ? 128 : 0) + pair_col(p, lane)] = fs[p];
    __syncthreads();
    for (int c = threadIdx.x; c < 256; c += kThreads) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += s_red[w * 256 + c];
      partial[(long long)blockIdx.x * 256 + c] = (c & 127) < kSumTiles * 8 ? v : 0.0f;
    }
  }
  if (kDw) {
    float* out = partial + (long long)blockIdx.x * (kFrozen ? kDW + kSums : kDW);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (warp & 3) * 16 + g, c = ((warp >> 2) * 4 + j) * 8 + 2 * t;
      out[kDW3 + r * 128 + c] = dw3[j][0];
      out[kDW3 + r * 128 + c + 1] = dw3[j][1];
      out[kDW3 + (r + 8) * 128 + c] = dw3[j][2];
      out[kDW3 + (r + 8) * 128 + c + 1] = dw3[j][3];
    }
    {
      const int r = (warp & 1) * 16 + g, c = (warp >> 1) * 8 + 2 * t;
      out[kDW2 + r * 64 + c] = dw2[0];
      out[kDW2 + r * 64 + c + 1] = dw2[1];
      out[kDW2 + (r + 8) * 64 + c] = dw2[2];
      out[kDW2 + (r + 8) * 64 + c + 1] = dw2[3];
    }
    // the staging is free (every warp passed the last m-tile's barrier): the warps' dW1 quarters (6 rows x 8
    // columns each) and K18's sums, added in warp order
    float* s_d1 = reinterpret_cast<float*>(s_st);
    float* s_fs = s_d1 + kWarps * 48;
    if (g < 6) {
      s_d1[warp * 48 + g * 8 + 2 * t] = dw1[0];
      s_d1[warp * 48 + g * 8 + 2 * t + 1] = dw1[1];
    }
    if (kFrozen) {
#pragma unroll
      for (int i = 0; i < kPairRegs; ++i) {
        const int layer = i < pair_base(kBwdFrozen, 2) ? 1 : i < pair_base(kBwdFrozen, 3) ? 2 : 3;
        const int p = i - pair_base(kBwdFrozen, layer);
        s_fs[warp * kSums + sums_base(layer) + (lane & 8 ? width_of(layer) : 0) + pair_col(p, lane)] = fs[i];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 6 * 32; i += kThreads) {
      const int row = i >> 5, c = i & 31;
      float v = 0.0f;
      for (int q = 0; q < 4; ++q) v += s_d1[(q * 4 + (c >> 3)) * 48 + row * 8 + (c & 7)];
      out[i] = v;
    }
    if (kFrozen) {
      for (int c = threadIdx.x; c < kSums; c += kThreads) {
        float v = 0.0f;
        for (int w = 0; w < kWarps; ++w) v += s_fs[w * kSums + c];
        out[kDW + c] = v;
      }
    }
  }
}

// The blocks' rows of K13's scratch added per channel (in double) by kFinRows threads a channel, each
// taking every kFinRows-th row, their sums then added in thread order: a run is deterministic and the rows'
// loads are in flight together. Thread k * 128 + c holds channel c's sums (s1, s2) where k == 0.
constexpr int kFinRows = 8;
__device__ __forceinline__ bool finish_rows(const float* __restrict__ partial, int blocks, double& s1, double& s2) {
  __shared__ double s_part[kFinRows][256];
  const int c = threadIdx.x & 127, k = threadIdx.x >> 7;
  double a = 0.0, b = 0.0;
  for (int i = k; i < blocks; i += kFinRows) {
    a += partial[(long long)i * 256 + c];
    b += partial[(long long)i * 256 + 128 + c];
  }
  s_part[k][c] = a;
  s_part[k][128 + c] = b;
  __syncthreads();
  if (k != 0) return false;
  s1 = s2 = 0.0;
  for (int j = 0; j < kFinRows; ++j) {
    s1 += s_part[j][c];
    s2 += s_part[j][128 + c];
  }
  return true;
}

// Channel c's flax batch statistics and affine from its sums of z and z^2 over n slots
__device__ __forceinline__ void stats_from_sums(double s1, double s2, const float* __restrict__ gb,
                                                float* __restrict__ bn, int c, float n, float eps) {
  const float sz = (float)s1, sz2 = (float)s2;
  const float mu = sz / n;
  const float var = fmaxf(sz2 / n - mu * mu, 0.0f);
  const float inv = 1.0f / sqrtf(var + eps);
  const float gam = gb[c], bet = gb[128 + c];
  bn[kMu * 128 + c] = mu;
  bn[kVar * 128 + c] = var;
  bn[kInv * 128 + c] = inv;
  bn[kA * 128 + c] = gam * inv;
  bn[kB * 128 + c] = bet - gam * mu * inv;
}

// second pass of K13: sum g (dbeta) and sum g zhat (dgamma) of the layer, the second as 1/sigma sum g (z - mu)
__global__ void sums_finish(const float* __restrict__ partial, int blocks, float* __restrict__ bn, int width) {
  double s1, s2;
  const int c = threadIdx.x;
  if (!finish_rows(partial, blocks, s1, s2) || c >= width) return;
  bn[kSg * 128 + c] = (float)s1;
  bn[kSgz * 128 + c] = (float)s2 * bn[kInv * 128 + c];
}

// K11's finish from the ranks' reduced sums
__global__ void stats_from_reduced(const double* __restrict__ sums, const float* __restrict__ gb,
                                   float* __restrict__ bn, int width, float n, float eps) {
  const int c = threadIdx.x;
  if (c < width) stats_from_sums(sums[c], sums[128 + c], gb, bn, c, n, eps);
}

// second pass of K14: the three dW, in the (in, out) layout, one after the other
__global__ void dw_finish(const float* __restrict__ partial, int blocks, float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kDW) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * kDW + i];
  dw[i] = (float)s;
}

// second pass of K18: K14's dW, then each layer's sum g (dbeta) and sum g zhat (dgamma, 1/sigma sum g (z - mu))
// into bn
__global__ void frozen_finish(const float* __restrict__ partial, int blocks, float* __restrict__ dw,
                              float* __restrict__ bn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kDW + kSums) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * (kDW + kSums) + i];
  if (i < kDW) {
    dw[i] = (float)s;
    return;
  }
  const int j = i - kDW;
  const int layer = j < sums_base(2) ? 1 : j < sums_base(3) ? 2 : 3;
  const int k = j - sums_base(layer), w = width_of(layer);
  float* r = bn + (layer - 1) * kBnRows * 128;
  r[(k < w ? kSg : kSgz) * 128 + k % w] = k < w ? (float)s : (float)s * r[kInv * 128 + k % w];
}

// ---------------------------------------------------------------- K12 and K14: warpgroup products (wgmma)

// The weights as wgmma reads them: each layer's (out, in) bf16 in core matrices of 8 outputs x 8 inputs (an
// output's 8 inputs a 16-byte row, 128 bytes a matrix), matrix (output group og, input group ig) at
// (og * in / 8 + ig) * 128 bytes, layer 1's inputs padded 6 -> 16. The forward reads a layer K-major (K = in:
// the two k halves 128 bytes apart, the output groups in * 16), dy of the backward the same bytes MN-major with
// the transpose bit (K = out: the k halves in * 16 bytes apart, the input groups 128).
constexpr int kGw1 = 32 * 16, kGw2 = kGw1 + 64 * 32, kGwElems = kGw2 + 128 * 64;
__device__ __forceinline__ int gw_at(int o, int i, int in) {
  return ((o >> 3) * (in >> 3) + (i >> 3)) * 64 + (o & 7) * 8 + (i & 7);
}

__device__ void load_gw(__nv_bfloat16* s_w, const float* w0, const float* w1, const float* w2) {
  for (int e = threadIdx.x; e < kGwElems; e += blockDim.x) {
    if (e < kGw1) {
      const int o = e >> 4, i = e & 15;
      s_w[gw_at(o, i, 16)] = __float2bfloat16_rn(i < 6 ? w0[i * 32 + o] : 0.0f);
    } else if (e < kGw2) {
      const int o = (e - kGw1) >> 5, i = (e - kGw1) & 31;
      s_w[kGw1 + gw_at(o, i, 32)] = __float2bfloat16_rn(w1[i * 64 + o]);
    } else {
      const int o = (e - kGw2) >> 6, i = (e - kGw2) & 63;
      s_w[kGw2 + gw_at(o, i, 64)] = __float2bfloat16_rn(w2[i * 128 + o]);
    }
  }
}

// the forward's B of layer 1 (K 16), of layer 2's k-step ks, of layer 3's k-step ks for output half h
__device__ __forceinline__ uint64_t b_l1(const __nv_bfloat16* s_w) { return gdesc(s_w, 128, 256); }
__device__ __forceinline__ uint64_t b_l2(const __nv_bfloat16* s_w, int ks) {
  return gdesc(s_w + kGw1 + ks * 128, 128, 512);
}
__device__ __forceinline__ uint64_t b_l3(const __nv_bfloat16* s_w, int h, int ks) {
  return gdesc(s_w + kGw2 + h * 4096 + ks * 128, 128, 1024);
}
// the backward's W3^T (dy2 = dz3 W3^T) and W2^T of k-step kb (outputs 16 kb ..), read MN-major
__device__ __forceinline__ uint64_t b_w3t(const __nv_bfloat16* s_w, int kb) {
  return gdesc(s_w + kGw2 + kb * 1024, 1024, 128);
}
__device__ __forceinline__ uint64_t b_w2t(const __nv_bfloat16* s_w, int kb) {
  return gdesc(s_w + kGw1 + kb * 512, 512, 128);
}

// d (+)= A B, m64nNk16 with A and B both MN-major in shared memory (wgmma.cuh's wgmma_rs: A from registers)
__device__ __forceinline__ void wgmma_tt8(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3"
               "}, %4, %5, p, 1, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
               "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt40(float (&d)[20], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19"
               "}, %20, %21, p, 1, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
               : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt72(float (&d)[36], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35"
               "}, %36, %37, p, 1, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
               : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
               "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
               : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

// The chans of the next tile in flight: lane t < 3 copies its 4 floats of the 16 rows at slot s0 (planes 2t,
// 2t + 1 at rows g, g + 8, as load_tile) into its own 16 bytes of shared memory by cp.async, which passes the
// registers (loads in flight into registers hold up the next wgmma.fence or wait), and reads them back after its
// copies landed
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_tile(float* dst, const float* cb, int s0, long long plane, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (t < 3) {
    const float* c = cb + 2 * t * plane + s0 + g;
    cp_async4(dst, c);
    cp_async4(dst + 1, c + plane);
    cp_async4(dst + 2, c + 8);
    cp_async4(dst + 3, c + plane + 8);
  }
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// chans' A fragment (K 6 padded to 16) from a lane's copied floats; zeros for lane t = 3 and rows past S
__device__ __forceinline__ void chans_frag(uint32_t (&a)[4], const float* src, bool copied) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  a[0] = copied ? pack(v.x, v.y) : 0u;
  a[1] = copied ? pack(v.z, v.w) : 0u;
  a[2] = a[3] = 0u;
}

// A layer's epilogue (layer 1 or 2, kN outputs): the affine and the ReLU with the bf16 rounding in one conversion;
// the accumulators of n-tile nt (rows g, g + 8, columns 2t, 2t + 1) are the next layer's A fragment, as mma.sync's
template <int kN>
__device__ __forceinline__ void relu_frags(uint32_t (&a)[kN / 16][4], const float (&d)[kN / 2], const float4* Q,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
    const float4 q = Q[nt * 4 + t];
    a[nt >> 1][(nt & 1) * 2] = relu_pack(q.x * d[4 * nt] + q.z, q.y * d[4 * nt + 1] + q.w);
    a[nt >> 1][(nt & 1) * 2 + 1] = relu_pack(q.x * d[4 * nt + 2] + q.z, q.y * d[4 * nt + 3] + q.w);
  }
}

// (m, c) merged with another running max and count (v, n)
__device__ __forceinline__ void merge_tie(float& m, float& c, float v, float n) {
  const float tie = v == m ? c + n : c;
  c = v > m ? n : tie;
  m = fmaxf(m, v);
}

// A column's max and tie count over two rows (pre-activations v0, v1) merged into the running (m, c) without a
// branch: the ReLU comes after the max (K12's pool), so a row pair is one max and one compare
__device__ __forceinline__ void max_tie(float& m, float& c, float v0, float v1) {
  merge_tie(m, c, fmaxf(v0, v1), v0 == v1 ? 2.0f : 1.0f);
}

// layer 3's epilogue in K12 for n-tiles nt0 .. nt0 + 7 (d: their accumulators): the affine and the running max of
// the pre-activations, rows g and g + 8 of each column together, into the thread's row of the point's (max, count)
// state in shared memory (a float4 (m, c, m, c) a column pair; a point's first tile starts it)
template <int kNt0>
__device__ __forceinline__ void pool_tiles(float* row, const float (&d)[32], const float4* Q3, int t, bool first) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 ab = Q3[(kNt0 + j) * 4 + t];
    float4* at = reinterpret_cast<float4*>(row + (kNt0 + j) * 16 + 4 * t);
    float4 mc = make_float4(__int_as_float(0xff800000), 0.0f, __int_as_float(0xff800000), 0.0f);
    if (!first) mc = *at;
    max_tie(mc.x, mc.y, ab.x * d[4 * j] + ab.z, ab.x * d[4 * j + 2] + ab.z);
    max_tie(mc.z, mc.w, ab.y * d[4 * j + 1] + ab.w, ab.y * d[4 * j + 3] + ab.w);
    *at = mc;
  }
}
// a warp past S in a point's first tile: its rows of the state start empty
__device__ __forceinline__ void pool_empty(float* row, int t) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
    *reinterpret_cast<float4*>(row + nt * 16 + 4 * t) =
        make_float4(__int_as_float(0xff800000), 0.0f, __int_as_float(0xff800000), 0.0f);
}

// The forward on a warpgroup's 64-slot tile (a1: the warp's A fragment of its 16 slots' chans), K12's and K14's:
// layers 1 and 2 as wgmma with A from registers and their epilogues into y1 (a2) and y2 (a3), each handed to
// staged() once made; layer 3 in two halves of 64 outputs, the second half's products in flight during the first's
// epilogue, each half's accumulators handed to half(h, d) (h: std::integral_constant 0 or 1)
template <typename Staged, typename Half>
__device__ __forceinline__ void forward_tile(const uint32_t (&a1)[4], uint32_t (&a2)[2][4], uint32_t (&a3)[4][4],
                                             const __nv_bfloat16* s_w, const float4* Q1, const float4* Q2, int t,
                                             Staged staged, Half half) {
  float d1[16], d2[32], d3[2][32];
  wg_fence();
  wgmma_rs32<0>(d1, a1, b_l1(s_w), 0);
  wg_commit();
  wg_wait<0>();
  hold(d1);
  relu_frags<32>(a2, d1, Q1, t);
  staged(a2);
  wg_fence();
  wgmma_rs64<0>(d2, a2[0], b_l2(s_w, 0), 0);
  wgmma_rs64<0>(d2, a2[1], b_l2(s_w, 1), 1);
  wg_commit();
  wg_wait<0>();
  hold(d2);
  relu_frags<64>(a3, d2, Q2, t);
  staged(a3);
  wg_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs64<0>(d3[h], a3[ks], b_l3(s_w, h, ks), ks);
    wg_commit();
  }
  wg_wait<1>();
  hold(d3[0]);
  half(std::integral_constant<int, 0>(), d3[0]);
  wg_wait<0>();
  hold(d3[1]);
  half(std::integral_constant<int, 1>(), d3[1]);
}

// K12's launch: warpgroups a block, and blocks an SM the build is held to (its registers)
constexpr int kFwdGroups = 4, kFwdBlocks = 1;
// a warpgroup's point state: each thread's row (warp, row group) of (max, count) for its 32 channels, as 128
// channel pairs, rows padded by 64 bytes (conflict-free float4 rows)
constexpr int kRedLd = 2 * 128 + 16;
__host__ __device__ constexpr size_t fwd_smem(int groups) {
  return (size_t)kGwElems * 2 + (size_t)kQuads * 16 + (size_t)groups * 32 * kRedLd * 4;
}

// K12: each warpgroup walks its points (a static stride over the grid's warpgroups), a point's S slots in tiles
// of 64 (warp w's 16 rows 16 w .. 16 w + 15, a ragged last tile's warps past S masked out of the max), the next
// tile's chans in registers in flight, each tile through forward_tile; each thread's running max and tie count of
// its 32 channels in its row of shared memory, the point's 32 rows merged at its end, one thread a channel.
template <int kGroups, int kBlocks>
__global__ void __launch_bounds__(kGroups * 128, kBlocks)
fwd_wg_kernel(const float* __restrict__ chans, const float* __restrict__ w0, const float* __restrict__ w1,
              const float* __restrict__ w2, const float* __restrict__ bn, float* __restrict__ pooled,
              float* __restrict__ cnt, int B, int P, int S) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* s_q = reinterpret_cast<float4*>(s_w + kGwElems);  // [layer][kind][pair]
  float* s_red = reinterpret_cast<float*>(s_q + kQuads);
  load_gw(s_w, w0, w1, w2);
  load_quads(s_q, bn, B, P, S);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the weights, stored by threads, read by wgmma
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long points = (long long)B * P, plane = (long long)P * S;
  const int tiles = (S + 63) >> 6;
  const float4 *Q1 = s_q, *Q2 = s_q + 3 * 64, *Q3 = s_q + 6 * 64;
  float* red = s_red + wg * 32 * kRedLd;
  float* row = red + (warp * 8 + g) * kRedLd;  // this thread's row of the point state
  const long long stride = (long long)gridDim.x * kGroups, first = (long long)blockIdx.x * kGroups;
  long long pt = first + wg;
  // every warpgroup of the block walks as many points as the first, idle past the last point (its products only)
  const long long rounds = first < points ? (points - 1 - first) / stride + 1 : 0;

  const float* cb = point_chans(chans, pt < points ? pt : 0, P, S);
  float nx[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the next tile's chans, in flight
  if (pt < points && 16 * warp < S) load_tile(nx, cb, 16 * warp, plane, lane);
  for (long long r = 0; r < rounds; ++r, pt += stride) {
    const bool active = pt < points;
    const long long npt = pt + stride;
    const float* nb = point_chans(chans, npt < points ? npt : 0, P, S);
#pragma unroll 1
    for (int k = 0; k < tiles; ++k) {
      const bool live = active && k * 64 + 16 * warp < S;
      const uint32_t a1[4] = {pack(nx[0], nx[1]), pack(nx[2], nx[3]), 0u, 0u};
      // the next tile's chans: this point's next, else the warpgroup's next point's first
      if (k + 1 < tiles) {
        const int s0 = (k + 1) * 64 + 16 * warp;
        if (active && s0 < S) load_tile(nx, cb, s0, plane, lane);
      } else if (npt < points && 16 * warp < S) {
        load_tile(nx, nb, 16 * warp, plane, lane);
      }
      uint32_t a2[2][4], a3[4][4];
      forward_tile(a1, a2, a3, s_w, Q1, Q2, t, [](const auto&) {}, [&](auto h, const float(&d)[32]) {
        if (live) {
          pool_tiles<decltype(h)::value * 8>(row, d, Q3, t, k == 0);
        } else if (decltype(h)::value == 0 && k == 0) {
          pool_empty(row, t);
        }
      });
    }
    if (active) {
      // the point's (max, count) by channel: thread c merges channel c's 32 rows
      bar_sync(1 + wg, 128);
      const int c = threadIdx.x & 127;
      float mq[4], nq[4];  // four independent merges of 8 rows each, then theirs
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mq[j] = __int_as_float(0xff800000);
        nq[j] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(red + i * kRedLd + 2 * c);
        merge_tie(mq[i & 3], nq[i & 3], v.x, v.y);
      }
      float m = mq[0], n = nq[0];
#pragma unroll
      for (int j = 1; j < 4; ++j) merge_tie(m, n, mq[j], nq[j]);
      // after the ReLU: the max, and every slot ties at 0 where no pre-activation is above 0
      pooled[pt * 128 + c] = fmaxf(m, 0.0f);
      cnt[pt * 128 + c] = m > 0.0f ? n : (float)S;
      bar_sync(1 + wg, 128);  // the rows are rewritten by the next point
    }
    cb = nb;
  }
}

// K14's block: kDwChains chain warpgroups, then the dW warpgroup; a ring of kDwStages stages, which the chain
// warpgroups' tiles take in turn (chain c the stages c, c + kDwChains, ..)
constexpr int kDwChains = 2, kDwStages = 2;
// A stage: 64 slot rows of chans (8 features, the last two zero), y1 (32), y2 (64), dz1 (32), dz2 (64) and dz3
// (128) in bf16, each array's feature group of 8 a column of 8 core matrices (8 slots x 8 features, 128 bytes):
// element (s, f) at ((f / 8) * 8 + s / 8) * 64 + (s % 8) * 8 + f % 8. The dW products read them MN-major (the
// transpose bits): a 16-slot k-step's two slot groups 128 bytes apart, the feature groups 1024. dz1 comes just
// before dz2, so that dW1's 64-row A (dz1^T: 32 rows, then dz2's first 32, output rows that are not kept) stays
// inside the stage.
constexpr int kStC = 0, kStY1 = 64 * 8, kStY2 = kStY1 + 64 * 32, kStD1 = kStY2 + 64 * 64, kStD2 = kStD1 + 64 * 32,
              kStD3 = kStD2 + 64 * 64, kStElems = kStD3 + 64 * 128;
__host__ __device__ constexpr size_t dw_smem(int chains, int stages) {
  return (size_t)kGwElems * 2 + (size_t)kQuads * 16 + (size_t)chains * (2 * 64 * 16 + 2 * 128 * 16 + 16) +
         (size_t)stages * (kStElems * 2 + 16);
}
// the descriptor of a staged array's k-step ks (slots 16 ks ..)
__device__ __forceinline__ uint64_t st_desc(const __nv_bfloat16* x, int ks) { return gdesc(x + ks * 128, 128, 1024); }


// an A fragment (the warp's 16 slots x features f0 .. f0 + 15) into a staged array: this lane's row address for
// stmatrix (x4: matrix lane / 8, row lane % 8; x2: lanes 0-15, features f0 .. f0 + 7)
__device__ __forceinline__ __nv_bfloat16* st_row(__nv_bfloat16* x, int warp, int lane, int f0) {
  const int mi = lane >> 3, s = warp * 16 + (mi & 1) * 8 + (lane & 7), f = f0 + (mi >> 1) * 8;
  return x + ((f >> 3) * 8 + (s >> 3)) * 64 + (s & 7) * 8;
}
__device__ __forceinline__ void stst4(__nv_bfloat16* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(saddr(p)), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void stst2(__nv_bfloat16* p, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(saddr(p)), "r"(r0), "r"(r1)
               : "memory");
}

// dz of a layer (kN outputs) from dy, the ReLU gates y (the layer's packed post-ReLU output, as A fragments) and
// z: g = dy where y > 0, then the BN backward (tile_dz); zeros for a warp past S
template <int kN>
__device__ __forceinline__ void dz_frags(uint32_t (&dz)[kN / 16][4], const float (&dy)[kN / 2],
                                         const float (&z)[kN / 2], const uint32_t (&y)[kN / 16][4], const float4* Q,
                                         int lane, bool live) {
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
    const uint32_t y_g = y[nt >> 1][(nt & 1) * 2], y_g8 = y[nt >> 1][(nt & 1) * 2 + 1];
    const bool on[4] = {pos_lo(y_g), pos_hi(y_g), pos_lo(y_g8), pos_hi(y_g8)};
    const float4 mq = Q[kQMuInv * 64 + nt * 4 + (lane & 3)];
    float gv[4], zc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gv[k] = on[k] ? dy[4 * nt + k] : 0.0f;
      zc[k] = z[4 * nt + k] - (k & 1 ? mq.y : mq.x);
    }
    uint32_t d[2];
    tile_dz<kBwdDw>(Q, nt, lane, gv, zc, d);
    dz[nt >> 1][(nt & 1) * 2] = live ? d[0] : 0u;
    dz[nt >> 1][(nt & 1) * 2 + 1] = live ? d[1] : 0u;
  }
}

// dz3 of n-tiles nt0 .. nt0 + 7 (d: their accumulators): the affine, the pool backward (a slot takes its point's
// share where its pre-activation equals the row's max, NaN where the max is 0) and the BN backward
template <int kNt0>
__device__ __forceinline__ void dz3_tiles(uint32_t (&dz)[8][4], const float (&d)[32], const float4* Q3,
                                          const float4* pool, int lane, bool live) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int nt = kNt0 + j, p = nt * 4 + (lane & 3);
    const float4 ab = Q3[p], pq = pool[p], mq = Q3[kQMuInv * 64 + p];
    float gv[4], zc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pre = (k & 1 ? ab.y : ab.x) * d[4 * j + k] + (k & 1 ? ab.w : ab.z);
      gv[k] = pre == (k & 1 ? pq.y : pq.x) ? (k & 1 ? pq.w : pq.z) : 0.0f;  // the pool backward, K14
      zc[k] = d[4 * j + k] - (k & 1 ? mq.y : mq.x);
    }
    uint32_t z[2];
    tile_dz<kBwdDw>(Q3, nt, lane, gv, zc, z);
    dz[nt >> 1][(nt & 1) * 2] = live ? z[0] : 0u;
    dz[nt >> 1][(nt & 1) * 2 + 1] = live ? z[1] : 0u;
  }
}

// K14: warp-specialised. Each chain warpgroup walks its points (a static stride over the grid's chain
// warpgroups) in tiles of 64 slots, the next tile's chans in flight by cp.async: K12's forward, dz3 in registers
// (pool and BN backward), dy2 = dz3 W3^T and dy1 = dz2 W2^T as wgmma with A from registers and W^T read by the
// transpose bit (z2 and z1 recomputed with the forward's bits in the same groups), staging chans, y1, y2 and every
// dz in its stages of the ring. The dW warpgroup takes the chain warpgroups' tiles in turn (tile k of each, k = 0,
// 1, ...) and accumulates dW3 = y2^T dz3 (M 64, N 128), dW2^T = dz2^T y1 (M 64, N 32) and dW1^T = dz1^T chans (M
// 64 of which 32 kept, N 8) in registers for the whole run, A and B both read from the stage MN-major; between
// stages it makes each chain's next pool rows; it writes the block's dW row at the end.
template <int kChains, int kStages>
__global__ void __launch_bounds__((kChains + 1) * 128, 1)
dw_wg_kernel(const float* __restrict__ chans, const float* __restrict__ w0, const float* __restrict__ w1,
             const float* __restrict__ w2, const float* __restrict__ bn, const float* __restrict__ pooled_in,
             const float* __restrict__ cnt_in, const float* __restrict__ dpool, float* __restrict__ partial, int B,
             int P, int S) {
  static_assert(kStages % kChains == 0, "the chains share the ring's stages evenly");
  constexpr int kPer = kStages / kChains;  // a chain's stages
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* s_q = reinterpret_cast<float4*>(s_w + kGwElems);  // [layer][kind][pair]
  float4* s_pool = s_q + kQuads;  // per chain, 2 points: (max, max, share, share) per pair
  float* s_cx = reinterpret_cast<float*>(s_pool + kChains * 2 * 64);  // per chain: 2 slots of each thread's 4 chans
  __nv_bfloat16* s_st = reinterpret_cast<__nv_bfloat16*>(s_cx + kChains * 2 * 128 * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_st + kStages * kStElems);
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;  // per chain, 2 points: its pool row is made
  load_gw(s_w, w0, w1, w2);
  load_quads(s_q, bn, B, P, S);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 4);   // lane 0 of each chain warp, once its stores are fenced
      mbar_init(&empty[s], 4);  // lane 0 of each dW warp, once its products are done
    }
    for (int s = 0; s < kChains * 2; ++s) mbar_init(&ready[s], 4);  // lane 0 of each dW warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const long long points = (long long)B * P, plane = (long long)P * S;
  const int tiles = (S + 63) >> 6;
  const long long stride = (long long)gridDim.x * kChains;

  if (wg == kChains) {  // the dW warpgroup
    int count[kChains];  // the tiles of each chain warpgroup
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const long long first = (long long)blockIdx.x * kChains + c;
      count[c] = first < points ? (int)((points - 1 - first) / stride + 1) * tiles : 0;
    }
    float dw3[64], dw2[16], dw1[4];
#pragma unroll
    for (int i = 0; i < 64; ++i) dw3[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dw2[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) dw1[i] = 0.0f;
    // chain c's j-th point's pool row into its buffer j % 2 (the chain reads it once ready[] says so): the dW
    // warpgroup, idle while it waits for the stages, takes the rows' loads and divisions off the chains
    auto pool_for = [&](int c, int j) {
      const long long pt = (long long)blockIdx.x * kChains + c + j * stride;
      const int tid = threadIdx.x & 127;
      if (tid < 64) {
        pool_row(s_pool + (c * 2 + (j & 1)) * 64, pooled_in + pt * 128, cnt_in + pt * 128, dpool + pt * 128, tid);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[c * 2 + (j & 1)]);
    };
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      for (int j = 0; j < 2 && j * tiles < count[c]; ++j) pool_for(c, j);
    }
    for (int k = 0; k < count[0]; ++k) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        if (k >= count[c]) continue;
        const int s = (k % kPer) * kChains + c;
        const __nv_bfloat16* st = s_st + s * kStElems;
        mbar_wait(&full[s], (k / kPer) & 1);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_tt128(dw3, st_desc(st + kStY2, ks), st_desc(st + kStD3, ks), 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_tt32(dw2, st_desc(st + kStD2, ks), st_desc(st + kStY1, ks), 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_tt8(dw1, st_desc(st + kStD1, ks), st_desc(st + kStC, ks), 1);
        wg_commit();
        wg_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        // the last tile of the chain's point j: its buffer takes point j + 2
        const int j = k / tiles;
        if (k % tiles == tiles - 1 && (j + 2) * tiles < count[c]) pool_for(c, j + 2);
      }
    }
    hold(dw3);
    hold(dw2);
    hold(dw1);
    // the block's row: dW3 (rows y2's 64 features, columns 128 outputs), dW2 and dW1 from their transposes
    float* out = partial + (long long)blockIdx.x * kDW;
    const int g = lane >> 2, t = lane & 3, r = warp * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = nt * 8 + 2 * t;
      out[kDW3 + r * 128 + c] = dw3[4 * nt];
      out[kDW3 + r * 128 + c + 1] = dw3[4 * nt + 1];
      out[kDW3 + (r + 8) * 128 + c] = dw3[4 * nt + 2];
      out[kDW3 + (r + 8) * 128 + c + 1] = dw3[4 * nt + 3];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = nt * 8 + 2 * t;
      out[kDW2 + c * 64 + r] = dw2[4 * nt];
      out[kDW2 + (c + 1) * 64 + r] = dw2[4 * nt + 1];
      out[kDW2 + c * 64 + r + 8] = dw2[4 * nt + 2];
      out[kDW2 + (c + 1) * 64 + r + 8] = dw2[4 * nt + 3];
    }
    if (r < 32 && t < 3) {
      out[2 * t * 32 + r] = dw1[0];
      out[(2 * t + 1) * 32 + r] = dw1[1];
      out[2 * t * 32 + r + 8] = dw1[2];
      out[(2 * t + 1) * 32 + r + 8] = dw1[3];
    }
    return;
  }

  // a chain warpgroup
  const int t = lane & 3;
  const float4 *Q1 = s_q, *Q2 = s_q + 3 * 64, *Q3 = s_q + 6 * 64;
  long long pt = (long long)blockIdx.x * kChains + wg;
  const float* cb = point_chans(chans, pt < points ? pt : 0, P, S);
  float* cx = s_cx + (wg * 2 * 128 + (threadIdx.x & 127)) * 4;  // tile q's chans at cx + (q & 1) * 512
  if (pt < points && 16 * warp < S) copy_tile(cx, cb, 16 * warp, plane, lane);
  int q = 0;  // this warpgroup's tiles so far
  for (int j = 0; pt < points; pt += stride, ++j) {
    const long long npt = pt + stride;
    const float* nb = point_chans(chans, npt < points ? npt : 0, P, S);
    const float4* pool = s_pool + (wg * 2 + (j & 1)) * 64;
    mbar_wait(&ready[wg * 2 + (j & 1)], (j >> 1) & 1);
#pragma unroll 1
    for (int k = 0; k < tiles; ++k, ++q) {
      const bool live = k * 64 + 16 * warp < S;
      uint32_t a1[4];
      cp_async_wait_all();
      chans_frag(a1, cx + (q & 1) * 512, live && t < 3);
      // the next tile's chans: this point's next, else the next point's first
      float* nx = cx + (~q & 1) * 512;
      if (k + 1 < tiles) {
        if ((k + 1) * 64 + 16 * warp < S) copy_tile(nx, cb, (k + 1) * 64 + 16 * warp, plane, lane);
      } else if (npt < points && 16 * warp < S) {
        copy_tile(nx, nb, 16 * warp, plane, lane);
      }
      const int s = (q % kPer) * kChains + wg;
      __nv_bfloat16* st = s_st + s * kStElems;
      if (q >= kPer) mbar_wait(&empty[s], (q / kPer - 1) & 1);  // the stage's last tile is consumed
      stst2(st_row(st + kStC, warp, lane, 0), a1[0], a1[1]);
      // the forward, K12's products, y1 and y2 staged once made; layer 3's halves into dz3
      uint32_t a2[2][4], a3[4][4], d3[8][4];
      forward_tile(
          a1, a2, a3, s_w, Q1, Q2, t,
          [&](const auto& y) {  // y1 (2 k-tiles of 16 features) or y2 (4)
            constexpr int kTiles = sizeof(y) / sizeof(y[0]);
            __nv_bfloat16* x = st + (kTiles == 2 ? kStY1 : kStY2);
#pragma unroll
            for (int kt = 0; kt < kTiles; ++kt) stst4(st_row(x, warp, lane, 16 * kt), y[kt]);
          },
          [&](auto h, const float(&z)[32]) { dz3_tiles<decltype(h)::value * 8>(d3, z, Q3, pool, lane, live); });
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) stst4(st_row(st + kStD3, warp, lane, 16 * kt), d3[kt]);
      // dy2 = dz3 W3^T, and z2 again
      uint32_t dz2[4][4];
      {
        float dy[32], z[32];
        wg_fence();
#pragma unroll
        for (int kb = 0; kb < 8; ++kb) wgmma_rs64<1>(dy, d3[kb], b_w3t(s_w, kb), kb);
        wgmma_rs64<0>(z, a2[0], b_l2(s_w, 0), 0);
        wgmma_rs64<0>(z, a2[1], b_l2(s_w, 1), 1);
        wg_commit();
        wg_wait<0>();
        hold(dy);
        hold(z);
        dz_frags<64>(dz2, dy, z, a3, Q2, lane, live);
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) stst4(st_row(st + kStD2, warp, lane, 16 * kt), dz2[kt]);
      // dy1 = dz2 W2^T, and z1 again
      {
        float dy[16], z[16];
        uint32_t dz1[2][4];
        wg_fence();
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) wgmma_rs32<1>(dy, dz2[kb], b_w2t(s_w, kb), kb);
        wgmma_rs32<0>(z, a1, b_l1(s_w), 0);
        wg_commit();
        wg_wait<0>();
        hold(dy);
        hold(z);
        dz_frags<32>(dz1, dy, z, a2, Q1, lane, live);
        stst4(st_row(st + kStD1, warp, lane, 0), dz1[0]);
        stst4(st_row(st + kStD1, warp, lane, 16), dz1[1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stage, read by the dW products
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    cb = nb;
  }
}

// ---------------------------------------------------------------- K11: the statistics from Gram sums (wgmma)

// K11's launch: warpgroups a block (one block an SM) and the chans tiles a warp keeps in flight (its ring)
constexpr int kStatGroups = 4, kStatRing = 4;
// Layer d's input (chans, y1 or y2) and the N of its Gram product: the input's features, then a group of 8 whose
// first feature is 1 on every live slot (its column of the product holds the sums of the input's features)
__host__ __device__ constexpr int gram_in(int depth) { return depth == 1 ? 6 : depth == 2 ? 32 : 64; }
__host__ __device__ constexpr int gram_n(int depth) { return depth == 1 ? 8 : gram_in(depth) + 8; }
// a stage's feature groups: N / 8, and at least the 8 that the product's A (M 64) reads
__host__ __device__ constexpr int gram_groups(int depth) { return gram_n(depth) > 64 ? gram_n(depth) / 8 : 8; }
constexpr int kStatSlice = 6 * 16;  // floats of a warp's 16 slots of chans, plane by plane
// a warpgroup's shared memory: its warps' rings, then two stages (dw_wg_kernel's layout: st_row, st_desc)
__host__ __device__ constexpr size_t stat_group_bytes(int depth) {
  return (size_t)4 * kStatRing * kStatSlice * 4 + (size_t)2 * gram_groups(depth) * 512 * 2;
}
// the block's end (stats_end): G (F x N floats), W_d (F x W floats), each channel's partial sums (q threads a channel)
__host__ __device__ constexpr size_t stat_end_bytes(int depth, int q) {
  return (size_t)gram_in(depth) * (gram_n(depth) + width_of(depth)) * 4 + (size_t)q * 2 * 128 * 8;
}
__host__ __device__ constexpr size_t stats_smem(int depth) {
  return (size_t)kGwElems * 2 + (size_t)kQuads * 16 +
         (kStatGroups * stat_group_bytes(depth) > stat_end_bytes(depth, kStatGroups)
              ? kStatGroups * stat_group_bytes(depth)
              : stat_end_bytes(depth, kStatGroups));
}

// a warp's 16 slots of chans at slot s0 into buf (6 planes of 16 floats) by 16-byte cp.async: lane l < 24 copies
// plane l / 4's quarter l % 4
__device__ __forceinline__ void copy_slice(float* buf, const float* cb, int s0, long long plane, int lane) {
  if (lane < 24) {
    const int c = lane >> 2, q = lane & 3;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(buf + c * 16 + q * 4)),
                 "l"(cb + c * plane + s0 + q * 4)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the Gram product of one staged 16-slot k-step (d: m64nN accumulators)
template <int kN>
__device__ __forceinline__ void wgmma_gram(float (&d)[kN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kN == 40) {
    wgmma_tt40(d, a, b, scale_d);
  } else {
    wgmma_tt72(d, a, b, scale_d);
  }
}

// The end of K11's pass in every block: s_g holds the block's G (F x N floats: the Gram sums of layer d's input
// and, in column F, its sums); channel c's sums of z = w_c . (column F) and of z^2 = w_c^T G w_c (w_c: column c of
// W_d rounded to bf16, as the products round it) in double, into the block's row of partial; then the last block to
// finish (g_stats_done, which it resets) adds the rows in block order in double, as finish_rows does, into flax's
// statistics and affine of layer d in bn, or, with sums, into the ranks' sums (unopose_pe_train_stats_partial).
// The space after s_g holds W_d and the channels' partial sums (stat_end_bytes).
__device__ unsigned g_stats_done;

template <int kDepth, int kThreads>
__device__ void stats_end(float* s_g, const float* __restrict__ wd, const float* __restrict__ gb,
                          float* __restrict__ bn, float* __restrict__ partial, double* __restrict__ sums, int B,
                          int P, int S, float eps) {
  constexpr int F = gram_in(kDepth), N = gram_n(kDepth), W = width_of(kDepth), kQ = kThreads / 128;
  float* s_wq = s_g + F * N;                               // W_d rounded to bf16, (F, W)
  double* s_p = reinterpret_cast<double*>(s_wq + F * W);  // [kQ][2][128]
  for (int i = threadIdx.x; i < F * W; i += kThreads) s_wq[i] = __bfloat162float(__float2bfloat16_rn(wd[i]));
  __syncthreads();
  // channel c's sums, thread (c, qq) over the input rows f = qq, qq + kQ, ..
  const int c = threadIdx.x & 127, qq = threadIdx.x >> 7;
  double p1 = 0.0, p2 = 0.0;
  if (c < W) {
#pragma unroll 1
    for (int f = qq; f < F; f += kQ) {
      const float* row = s_g + f * N;
      double h0 = 0.0, h1 = 0.0;
#pragma unroll 4
      for (int e = 0; e < F; e += 2) {
        h0 += (double)row[e] * (double)s_wq[e * W + c];
        if (e + 1 < F) h1 += (double)row[e + 1] * (double)s_wq[(e + 1) * W + c];
      }
      const double wf = (double)s_wq[f * W + c];
      p1 += wf * (double)row[F];
      p2 += wf * (h0 + h1);
    }
  }
  s_p[(qq * 2) * 128 + c] = p1;
  s_p[(qq * 2 + 1) * 128 + c] = p2;
  __syncthreads();
  if (qq == 0) {
    double a = 0.0, b = 0.0;
    for (int k = 0; k < kQ; ++k) {
      a += s_p[(k * 2) * 128 + c];
      b += s_p[(k * 2 + 1) * 128 + c];
    }
    partial[(long long)blockIdx.x * 256 + c] = c < W ? (float)a : 0.0f;
    partial[(long long)blockIdx.x * 256 + 128 + c] = c < W ? (float)b : 0.0f;
  }

  // the last block adds the rows: 8 of a thread's rows loaded at once, then added in row order
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&g_stats_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  if (threadIdx.x == 0) g_stats_done = 0u;  // every block has counted: the next launch counts from 0
  __threadfence();
  const int blocks = (int)gridDim.x;
  double a = 0.0, b = 0.0;
  for (int i0 = qq; i0 < blocks; i0 += 8 * kQ) {
    float va[8], vb[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kQ;
      va[u] = i < blocks ? __ldcg(partial + (long long)i * 256 + c) : 0.0f;
      vb[u] = i < blocks ? __ldcg(partial + (long long)i * 256 + 128 + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) a += (double)va[u], b += (double)vb[u];
  }
  __syncthreads();  // every thread is done with s_p's block sums
  s_p[(qq * 2) * 128 + c] = a;
  s_p[(qq * 2 + 1) * 128 + c] = b;
  __syncthreads();
  if (qq != 0 || c >= W) return;
  double s1 = 0.0, s2 = 0.0;
  for (int k = 0; k < kQ; ++k) {
    s1 += s_p[(k * 2) * 128 + c];
    s2 += s_p[(k * 2 + 1) * 128 + c];
  }
  if (sums) {
    sums[c] = s1;
    sums[128 + c] = s2;
  } else {
    stats_from_sums(s1, s2, gb + (kDepth - 1) * 256, bn + (kDepth - 1) * kBnRows * 128, c,
                    (float)((double)B * P * S), eps);
  }
}


// K11 at depth d = 2, 3. Each warpgroup walks its points (a static stride over the grid's warpgroups) in tiles of
// 64 slots, its warps' next tiles of chans in flight by cp.async (a ring of kStatRing a warp); a tile runs the chain
// below layer d on wgmma (forward_tile's layers, A from registers), stages layer d's input Y (y1 or y2, the rows of
// dead slots zero) with a ones feature, and adds the Gram product Y^T [Y | 1] (A and B MN-major from the stage) to
// the thread's float32 totals, one product a tile. The block adds its warpgroups' totals in order into G and ends
// in stats_end.
template <int kDepth>
__global__ void __launch_bounds__(kStatGroups * 128, 1)
stats_wg_kernel(const float* __restrict__ chans, const float* __restrict__ w0, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ gb, float* __restrict__ bn,
                float* __restrict__ partial, double* __restrict__ sums, int B, int P, int S, float eps) {
  static_assert(kDepth >= 2, "depth 1 runs moments_kernel");
  constexpr int F = gram_in(kDepth), N = gram_n(kDepth), kGroupsSt = gram_groups(kDepth);
  constexpr int kThreads = kStatGroups * 128;
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* s_q = reinterpret_cast<float4*>(s_w + kGwElems);  // [layer][kind][pair]
  unsigned char* s_groups = reinterpret_cast<unsigned char*>(s_q + kQuads);
  load_gw(s_w, w0, w1, w2);
  load_quads(s_q, bn, B, P, S);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the weights, stored by threads, read by wgmma
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* mine = s_groups + wg * stat_group_bytes(kDepth);
  float* ring = reinterpret_cast<float*>(mine) + warp * kStatRing * kStatSlice;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(mine + 4 * kStatRing * kStatSlice * 4);
  const long long points = (long long)B * P, plane = (long long)P * S;
  const int tiles = (S + 63) >> 6;
  const long long stride = (long long)gridDim.x * kStatGroups;
  const float4 *Q1 = s_q, *Q2 = s_q + 3 * 64;

  // the tiles' copies, kStatRing - 1 ahead of the products: one commit group a tile (empty past the last)
  long long ipt = (long long)blockIdx.x * kStatGroups + wg;
  int ik = 0, fetched = 0;
  auto prefetch = [&]() {
    if (ipt < points) {
      const int s0 = ik * 64 + 16 * warp;
      if (s0 < S) copy_slice(ring + (fetched & (kStatRing - 1)) * kStatSlice, point_chans(chans, ipt, P, S), s0, plane,
                             lane);
      if (++ik == tiles) {
        ik = 0;
        ipt += stride;
      }
    }
    cp_async_commit();
    ++fetched;
  };
#pragma unroll 1
  for (int j = 0; j < kStatRing - 1; ++j) prefetch();

  float tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) tot[i] = 0.0f;
  int q = 0;  // this warpgroup's tiles so far
  for (long long pt = (long long)blockIdx.x * kStatGroups + wg; pt < points; pt += stride) {
#pragma unroll 1
    for (int k = 0; k < tiles; ++k, ++q) {
      prefetch();
      cp_async_wait<kStatRing - 1>();
      __syncwarp();
      const bool live = k * 64 + 16 * warp < S;
      const float* x = ring + (q & (kStatRing - 1)) * kStatSlice;
      uint32_t a1[4] = {0u, 0u, 0u, 0u};  // chans (bf16), K 6 padded to 16
      if (live && t < 3) {
        a1[0] = pack(x[2 * t * 16 + g], x[(2 * t + 1) * 16 + g]);
        a1[1] = pack(x[2 * t * 16 + g + 8], x[(2 * t + 1) * 16 + g + 8]);
      }
      __syncwarp();  // the slot is refilled by the next tile's copy
      const uint32_t one = live ? pack(1.0f, 0.0f) : 0u;
      __nv_bfloat16* st = stages + (q & 1) * kGroupsSt * 512;
      {
        uint32_t a2[2][4];  // y1
        {
          float d1[16];
          wg_fence();
          wgmma_rs32<0>(d1, a1, b_l1(s_w), 0);
          wg_commit();
          wg_wait<0>();
          hold(d1);
          relu_frags<32>(a2, d1, Q1, t);
        }
        if (kDepth == 2) {
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a2[kt][i] = live ? a2[kt][i] : 0u;
            stst4(st_row(st, warp, lane, 16 * kt), a2[kt]);
          }
        } else {
          uint32_t a3[4][4];  // y2
          float d2[32];
          wg_fence();
          wgmma_rs64<0>(d2, a2[0], b_l2(s_w, 0), 0);
          wgmma_rs64<0>(d2, a2[1], b_l2(s_w, 1), 1);
          wg_commit();
          wg_wait<0>();
          hold(d2);
          relu_frags<64>(a3, d2, Q2, t);
#pragma unroll
          for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a3[kt][i] = live ? a3[kt][i] : 0u;
            stst4(st_row(st, warp, lane, 16 * kt), a3[kt]);
          }
        }
        stst2(st_row(st, warp, lane, F), t == 0 ? one : 0u, t == 0 ? one : 0u);  // the ones in feature F
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stage, read by the Gram product
      bar_sync(1 + wg, 128);  // every warp's rows are staged (the other stage is free: its product was waited for)
      float d[N / 2];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_gram<N>(d, st_desc(st, ks), st_desc(st, ks), ks);
      wg_commit();
      wg_wait<0>();
      hold(d);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) tot[i] += d[i];
    }
  }
  cp_async_wait<0>();

  // the block's G (F x N floats: rows of the input's features, columns theirs and the sums), the warpgroups'
  // totals added in warpgroup order, over the rings and stages
  __syncthreads();
  float* s_g = reinterpret_cast<float*>(s_groups);
#pragma unroll 1
  for (int k = 0; k < kStatGroups; ++k) {
    if (wg == k) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g + 8 * h;
          if (r < F) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* at = s_g + r * N + 8 * j + 2 * t + e;
              *at = k == 0 ? tot[4 * j + 2 * h + e] : *at + tot[4 * j + 2 * h + e];
            }
          }
        }
      }
    }
    __syncthreads();
  }
  stats_end<kDepth, kThreads>(s_g, kDepth == 2 ? w1 : w2, gb, bn, partial, sums, B, P, S, eps);
}

// K11 at depth 1 on the CUDA cores: the pass only reads the chans, so a thread takes 4 slots of every plane at a
// time (16-byte loads, two steps' loads in flight) and adds, in float32, the 6 sums and 21 products of their bf16
// values (exact in float32); the block adds its threads' by a fixed xor tree a warp, then the warps in order,
// into G (F 6 x N 8: the products, the sums in column 6) and ends as stats_wg_kernel does.
constexpr int kMomThreads = 256;
__global__ void __launch_bounds__(kMomThreads)
moments_kernel(const float* __restrict__ chans, const float* __restrict__ w0, const float* __restrict__ gb,
               float* __restrict__ bn, float* __restrict__ partial, double* __restrict__ sums, int B, int P, int S,
               float eps) {
  constexpr int kWarps = kMomThreads / 32, kAcc = 6 + 21;
  __shared__ float s_warp[kWarps][kAcc];
  __shared__ __align__(16) unsigned char s_end[stat_end_bytes(1, kMomThreads / 128)];
  const long long quads = (long long)P * S / 4, total = (long long)B * quads;
  const long long stride = (long long)gridDim.x * kMomThreads;
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  auto add = [&](const float4 (&v)[6]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float r = e == 0 ? v[c].x : e == 1 ? v[c].y : e == 2 ? v[c].z : v[c].w;
        x[c] = __bfloat162float(__float2bfloat16_rn(r));
        acc[c] += x[c];
      }
      int k = 6;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] += x[a] * x[b];
      }
    }
  };
  for (long long q = (long long)blockIdx.x * kMomThreads + threadIdx.x; q < total; q += 2 * stride) {
    float4 v[2][6];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long qh = q + h * stride;
      const long long b = qh / quads;
      const float4* src = reinterpret_cast<const float4*>(chans) + b * 6 * quads + (qh - b * quads);
#pragma unroll
      for (int c = 0; c < 6; ++c) v[h][c] = qh < total ? __ldcs(src + c * quads) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    add(v[0]);
    add(v[1]);  // past the end: zeros, which add nothing
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) s_warp[warp][k] = v;
  }
  __syncthreads();
  float* s_g = reinterpret_cast<float*>(s_end);
  if (threadIdx.x < kAcc) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += s_warp[w][threadIdx.x];
    const int k = threadIdx.x;
    if (k < 6) {
      s_g[k * 8 + 6] = v;
    } else {
      int a = 0, r = k - 6;  // the upper triangle's entry r, row by row
      while (r >= 6 - a) r -= 6 - a++;
      s_g[a * 8 + a + r] = v;
      s_g[(a + r) * 8 + a] = v;
    }
  }
  __syncthreads();
  stats_end<1, kMomThreads>(s_g, w0, gb, bn, partial, sums, B, P, S, eps);
}

// the launch of K12 (warpgroups) or K14 (chain warpgroups, stages) on at most cap blocks (0: no cap)
template <typename Kernel>
cudaError_t wg_blocks(Kernel kernel, int threads, size_t smem, long long want, int cap, int* blocks, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem)) != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if (*per_sm == 0) return cudaErrorInvalidConfiguration;
  long long n = want < (long long)sms * *per_sm ? want : (long long)sms * *per_sm;
  if (cap > 0 && n > cap) n = cap;
  *blocks = (int)(n > 0 ? n : 1);
  return cudaSuccess;
}

cudaError_t launch_fwd(const float* chans, const float* w0, const float* w1, const float* w2, const float* bn,
                       float* pooled, float* cnt, int B, int P, int S, cudaStream_t stream) {
  auto kernel = fwd_wg_kernel<kFwdGroups, kFwdBlocks>;
  int blocks = 0, per_sm = 0;
  const long long points = (long long)B * P;
  cudaError_t err = wg_blocks(kernel, kFwdGroups * 128, fwd_smem(kFwdGroups), (points + kFwdGroups - 1) / kFwdGroups,
                              0, &blocks, &per_sm);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kFwdGroups * 128, fwd_smem(kFwdGroups), stream>>>(chans, w0, w1, w2, bn, pooled, cnt, B, P, S);
  return cudaGetLastError();
}

cudaError_t launch_dw(const float* chans, const float* w0, const float* w1, const float* w2, const float* bn,
                      const float* pooled, const float* cnt, const float* dpool, float* partial, int cap, int B, int P,
                      int S, int* blocks, cudaStream_t stream) {
  auto kernel = dw_wg_kernel<kDwChains, kDwStages>;
  int per_sm = 0;
  const long long points = (long long)B * P;
  cudaError_t err = wg_blocks(kernel, (kDwChains + 1) * 128, dw_smem(kDwChains, kDwStages),
                              (points + kDwChains - 1) / kDwChains, cap, blocks, &per_sm);
  if (err != cudaSuccess) return err;
  kernel<<<*blocks, (kDwChains + 1) * 128, dw_smem(kDwChains, kDwStages), stream>>>(
      chans, w0, w1, w2, bn, pooled, cnt, dpool, partial, B, P, S);
  return cudaGetLastError();
}

int resident_fwd(int* warps) {
  int blocks = 0, per_sm = 0;
  const cudaError_t err = wg_blocks(fwd_wg_kernel<kFwdGroups, kFwdBlocks>, kFwdGroups * 128,
                                    fwd_smem(kFwdGroups), 1, 0, &blocks, &per_sm);
  *warps = per_sm * kFwdGroups * 4;
  return (int)err;
}

int resident_dw(int* warps) {
  int blocks = 0, per_sm = 0;
  const cudaError_t err = wg_blocks(dw_wg_kernel<kDwChains, kDwStages>, (kDwChains + 1) * 128,
                                    dw_smem(kDwChains, kDwStages), 1, 0, &blocks, &per_sm);
  *warps = per_sm * (kDwChains + 1) * 4;
  return (int)err;
}

// the kernel's shared memory set, and the blocks of it an SM holds
template <int kMode, int kDepth>
cudaError_t occupancy(int* per_sm) {
  auto kernel = pe_train_kernel<kMode, kDepth>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(kMode, kDepth));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, warps_of(kMode) * 32, smem_bytes(kMode, kDepth));
}

template <int kMode, int kDepth>
cudaError_t launch(const float* chans, const float* w0, const float* w1, const float* w2, const float* bn,
                   const float* pooled_in, const float* cnt_in, const float* dpool, float* pooled_out,
                   float* cnt_out, float* partial, int cap, int B, int P, int S, int* blocks_out,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = occupancy<kMode, kDepth>(&per_sm);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long points = (long long)B * P;
  long long blocks = (points + warps_of(kMode) - 1) / warps_of(kMode);
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (cap > 0 && blocks > cap) blocks = cap;
  pe_train_kernel<kMode, kDepth><<<(unsigned)blocks, warps_of(kMode) * 32, smem_bytes(kMode, kDepth), stream>>>(
      chans, w0, w1, w2, bn, pooled_in, cnt_in, dpool, pooled_out, cnt_out, partial, B, P, S);
  *blocks_out = (int)blocks;
  return cudaGetLastError();
}

template <int kMode, int kDepth>
int resident(int* warps) {
  int per_sm = 0;
  const cudaError_t err = occupancy<kMode, kDepth>(&per_sm);
  *warps = per_sm * warps_of(kMode);
  return (int)err;
}

// K11's launch at depth d: the blocks an SM holds (one), at most one a warpgroup's point and at most cap
template <int kDepth>
cudaError_t launch_stats_at(const float* chans, const float* w0, const float* w1, const float* w2, const float* gb,
                            float* bn, float* partial, double* sums, int cap, int B, int P, int S, float eps,
                            cudaStream_t stream) {
  auto kernel = stats_wg_kernel<kDepth>;
  int blocks = 0, per_sm = 0;
  const long long points = (long long)B * P;
  cudaError_t err = wg_blocks(kernel, kStatGroups * 128, stats_smem(kDepth), (points + kStatGroups - 1) / kStatGroups,
                              cap, &blocks, &per_sm);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kStatGroups * 128, stats_smem(kDepth), stream>>>(chans, w0, w1, w2, gb, bn, partial, sums, B, P, S,
                                                                     eps);
  return cudaGetLastError();
}

// depth 1: moments_kernel, two blocks an SM at most, at most one a thread's two steps of 4 slots and at most cap
cudaError_t launch_moments(const float* chans, const float* w0, const float* gb, float* bn, float* partial,
                           double* sums, int cap, int B, int P, int S, float eps, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const long long quads = (long long)B * P * S / 4;
  long long blocks = (quads + 2 * kMomThreads - 1) / (2 * kMomThreads);
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  if (blocks > cap) blocks = cap;
  moments_kernel<<<(unsigned)blocks, kMomThreads, 0, stream>>>(chans, w0, gb, bn, partial, sums, B, P, S, eps);
  return cudaGetLastError();
}

cudaError_t launch_stats(const float* chans, const float* w0, const float* w1, const float* w2, const float* gb,
                         float* bn, float* partial, double* sums, int cap, int B, int P, int S, int depth, float eps,
                         cudaStream_t stream) {
  if (depth == 1) return launch_moments(chans, w0, gb, bn, partial, sums, cap, B, P, S, eps, stream);
  if (depth == 2) return launch_stats_at<2>(chans, w0, w1, w2, gb, bn, partial, sums, cap, B, P, S, eps, stream);
  return launch_stats_at<3>(chans, w0, w1, w2, gb, bn, partial, sums, cap, B, P, S, eps, stream);
}

template <int kDepth>
int resident_stats(int* warps) {
  int blocks = 0, per_sm = 0;
  const cudaError_t err = wg_blocks(stats_wg_kernel<kDepth>, kStatGroups * 128, stats_smem(kDepth), 1, 0, &blocks,
                                    &per_sm);
  *warps = per_sm * kStatGroups * 4;
  return (int)err;
}

int resident_moments(int* warps) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, moments_kernel, kMomThreads, 0);
  *warps = per_sm * kMomThreads / 32;
  return (int)err;
}

bool bad_shape(int B, int P, int S) { return B <= 0 || P <= 0 || S <= 0 || S % 16 != 0; }

}  // namespace

// K11. chans (B, 6, P, S) float32; w0 (6, 32), w1 (32, 64), w2 (64, 128) float32; gb (3, 2, 128) gammas
// and betas; bn (3, 8, 128): reads the affines of the layers above depth, writes mu, var, inv, a, b of
// layer depth; partial: cap x 256 floats of scratch.
extern "C" int unopose_pe_train_stats(const float* chans, const float* w0, const float* w1, const float* w2,
                                      const float* gb, float* bn, float* partial, int cap, int B, int P, int S,
                                      int depth, float eps, cudaStream_t stream) {
  if (bad_shape(B, P, S) || depth < 1 || depth > 3 || cap <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_stats(chans, w0, w1, w2, gb, bn, partial, nullptr, cap, B, P, S, depth, eps, stream);
}

// K11 on several ranks, its block pass: layer depth's sums of z and z^2 over this rank's B P S slots, added over
// the blocks in double as unopose_pe_train_stats adds them, into sums (2 x 128 doubles; the host zeroes it and
// all-reduces it across the ranks). Arguments as unopose_pe_train_stats'.
extern "C" int unopose_pe_train_stats_partial(const float* chans, const float* w0, const float* w1, const float* w2,
                                              const float* bn, float* partial, int cap, int B, int P, int S,
                                              int depth, double* sums, cudaStream_t stream) {
  if (bad_shape(B, P, S) || depth < 1 || depth > 3 || cap <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_stats(chans, w0, w1, w2, nullptr, const_cast<float*>(bn), partial, sums, cap, B, P, S, depth,
                           0.0f, stream);
}

// K11 on several ranks, its finish: layer depth's mu, var, inv, a, b of bn from the ranks' reduced sums over n
// slots (R B P S).
extern "C" int unopose_pe_train_stats_finish(const double* sums, const float* gb, float* bn, int depth, double n,
                                             float eps, cudaStream_t stream) {
  if (depth < 1 || depth > 3 || !(n > 0.0)) return (int)cudaErrorInvalidValue;
  stats_from_reduced<<<1, 128, 0, stream>>>(sums, gb + (depth - 1) * 256, bn + (depth - 1) * kBnRows * 128,
                                            depth == 1 ? 32 : depth == 2 ? 64 : 128, (float)n, eps);
  return (int)cudaGetLastError();
}

// K12. pooled and cnt (B, P, 128) float32: the max over the slots of the last layer's ReLU output, and
// how many slots reach it.
extern "C" int unopose_pe_train_fwd(const float* chans, const float* w0, const float* w1, const float* w2,
                                    const float* bn, float* pooled, float* cnt, int B, int P, int S,
                                    cudaStream_t stream) {
  if (bad_shape(B, P, S)) return (int)cudaErrorInvalidValue;
  return (int)launch_fwd(chans, w0, w1, w2, bn, pooled, cnt, B, P, S, stream);
}

// K13. dpool (B, P, 128) float32, the cotangent of pooled; bn: every layer's statistics and affine, and
// the sums of the layers below depth; writes sum g and sum g zhat of layer depth.
extern "C" int unopose_pe_train_bwd_sums(const float* chans, const float* w0, const float* w1, const float* w2,
                                         float* bn, const float* pooled, const float* cnt, const float* dpool,
                                         float* partial, int cap, int B, int P, int S, int depth,
                                         cudaStream_t stream) {
  if (bad_shape(B, P, S) || depth < 1 || depth > 3 || cap <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err;
  if (depth == 3) {
    err = launch<kBwdSums, 3>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B, P, S,
                              &blocks, stream);
  } else if (depth == 2) {
    err = launch<kBwdSums, 2>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B, P, S,
                              &blocks, stream);
  } else {
    err = launch<kBwdSums, 1>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap, B, P, S,
                              &blocks, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int width = depth == 1 ? 32 : depth == 2 ? 64 : 128;
  sums_finish<<<1, 128 * kFinRows, 0, stream>>>(partial, blocks, bn + (depth - 1) * kBnRows * 128, width);
  return (int)cudaGetLastError();
}

// K14. dw: 6 * 32 + 32 * 64 + 64 * 128 floats, dW1, dW2, dW3 each (in, out) row-major; partial: cap x
// that many floats of scratch.
extern "C" int unopose_pe_train_bwd_dw(const float* chans, const float* w0, const float* w1, const float* w2,
                                       const float* bn, const float* pooled, const float* cnt, const float* dpool,
                                       float* partial, int cap, float* dw, int B, int P, int S, cudaStream_t stream) {
  if (bad_shape(B, P, S) || cap <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = launch_dw(chans, w0, w1, w2, bn, pooled, cnt, dpool, partial, cap, B, P, S, &blocks, stream);
  if (err != cudaSuccess) return (int)err;
  dw_finish<<<(kDW + 255) / 256, 256, 0, stream>>>(partial, blocks, dw);
  return (int)cudaGetLastError();
}

// K18. The frozen-BN backward: bn holds every layer's mu, inv and affine (from the running statistics);
// writes dw as K14 does and each layer's sum g (row kSg) and sum g zhat (row kSgz) into bn; partial: cap x
// (dW floats + 448) floats of scratch.
extern "C" int unopose_pe_train_frozen_bwd(const float* chans, const float* w0, const float* w1, const float* w2,
                                           float* bn, const float* pooled, const float* cnt, const float* dpool,
                                           float* partial, int cap, float* dw, int B, int P, int S,
                                           cudaStream_t stream) {
  if (bad_shape(B, P, S) || cap <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = launch<kBwdFrozen, 0>(chans, w0, w1, w2, bn, pooled, cnt, dpool, nullptr, nullptr, partial, cap,
                                          B, P, S, &blocks, stream);
  if (err != cudaSuccess) return (int)err;
  frozen_finish<<<(kDW + kSums + 255) / 256, 256, 0, stream>>>(partial, blocks, dw, bn);
  return (int)cudaGetLastError();
}

// The warps an SM holds of a pass's kernel (the runtime's occupancy query at its launch's shared memory):
// kernel 11 (depth 1-3), 12, 13 (layer 1-3), 14 or 18.
extern "C" int unopose_pe_train_resident_warps(int kernel, int depth, int* warps) {
  switch (kernel * 4 + depth) {
    case 11 * 4 + 1: return resident_moments(warps);
    case 11 * 4 + 2: return resident_stats<2>(warps);
    case 11 * 4 + 3: return resident_stats<3>(warps);
    case 12 * 4 + 3: return resident_fwd(warps);
    case 13 * 4 + 1: return resident<kBwdSums, 1>(warps);
    case 13 * 4 + 2: return resident<kBwdSums, 2>(warps);
    case 13 * 4 + 3: return resident<kBwdSums, 3>(warps);
    case 14 * 4 + 0: return resident_dw(warps);
    case 18 * 4 + 0: return resident<kBwdFrozen, 0>(warps);
    default: return (int)cudaErrorInvalidValue;
  }
}
