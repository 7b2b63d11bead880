// The three micro-kernels of benchmarks/profile_compact_micro.py (rows
// 21-23), which time the parts of the first_k grouping's compaction stage on
// the TPU. The script's blocks: ROWS = 256 rows of C x W = 4 x 512 int32
// words and K2 = 256 outputs a row; here each kernel takes the rows of all
// blocks as one (rows, ...) array. Integers only: the outputs are exact.
//
// compact_rounds (K25) replaces _k_rounds (:34, its pallas_call at :120):
// on each 512-word chunk of a row, nrounds LSB-first shift rounds (s = 1, 2,
// 4, ...): w_in[j] = work[(j + s) mod 512] (pltpu.roll by width - s, a roll
// left by s), move_in = (w_in & s) != 0 and j < 512 - s, stay = (work & s)
// == 0, work = move_in ? w_in - s : (stay ? work : 0); the XOR of the four
// chunks, its first 256 words out. One warp per row: a lane holds words
// lane + 32 u of the chunk in registers and reads the rolled word from the
// warp's 2 KB of shared memory, a barrier of the warp between the reads and
// the writes of each round. Bound: operations (~8 integer operations a word
// and round, an estimate; tools/tpu_profile_bounds.py); 8 KB read a row.
//
// compact_gather (K26) replaces _k_gather (:54, its pallas_call at :127):
// out[r, j] = x[r, bi * 128 + li] where 0 <= bi < 16, else 0 (the select
// chain over 16 banks of 128 words); li must lie in [0, 128), as the
// script draws it: it is not checked. Bound: bytes, the 32-byte sectors of
// x that the draws touch (~63% of a row's), both indices and the output:
// ~541 MB, 0.162 ms at 3.35 TB/s on the script's 65536 rows (every word of
// x: 738 MB, 0.220 ms). The 256 draws of a row touch ~86% of its 64-byte
// bursts, so at the DRAM's 64-byte access the gathers read ~665 MB
// (0.198 ms), as scattered 32-byte requests into a 537 MB x that no L2
// holds: the time goes to keeping enough of them in flight. The first design (a thread per 4 outputs over a grid capped at
// residency, each step an index load then four dependent gathers) kept too
// few. Here each thread takes kQuads quads of outputs, issues all their
// index loads (16 bytes of li and of bi a quad) before any gather, then the
// 4 * kQuads gathers, and stores 16 bytes a quad, with streaming cache hints
// (every byte is used once), over a grid of every quad. What each part
// bought (tools/kernel_variants.py --only K26, NVIDIA H100 80GB HBM3, 700
// W, ms): the first design 0.256; this one, 8 quads a thread (101
// registers), 0.223; 4 quads 0.226, 2 quads 0.238; the gathers cached in L2
// only 0.232; no cache hints 0.229; the rows streamed in order through a
// ring of 4 shared-memory stages of 4 rows by bulk copies on mbarriers
// (every byte of x read once, the bound's own count) 0.242; one
// torch.gather of the flat int64 indices beside them 0.248.
//
// compact_wherechain (K27) replaces the prefix search kern of wherechain
// (:134, its pallas_call at :144): pref[k] = sum(li[r, :128] * (k + 1)) % 64
// for k < 16, c_of[j] = #{k < 15 : pref[k] + k <= j}, out[r, j] = c_of * 64
// + (j - pref[c_of]) for j < 256. One warp per row: the 16 sums by warp
// reduction, then 8 outputs a lane. Bound: operations (an estimate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;         // W
constexpr int kChunks = 4;          // C
constexpr int kRowWords = kChunk * kChunks;
constexpr int kOut = 256;           // K2
constexpr int kBanks = kRowWords / 128;

__global__ void __launch_bounds__(kThreads)
compact_rounds_kernel(const int* __restrict__ x, int* __restrict__ out, int rows, int nrounds) {
  __shared__ int s_work[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* sw = s_work[warp];
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows; r += (long long)gridDim.x * kWarps) {
    int acc[kOut / 32];
#pragma unroll
    for (int u = 0; u < kOut / 32; ++u) acc[u] = 0;
    for (int c = 0; c < kChunks; ++c) {
      int work[kChunk / 32];
#pragma unroll
      for (int u = 0; u < kChunk / 32; ++u) work[u] = x[r * kRowWords + c * kChunk + u * 32 + lane];
      int s = 1;
      for (int k = 0; k < nrounds; ++k, s *= 2) {
#pragma unroll
        for (int u = 0; u < kChunk / 32; ++u) sw[u * 32 + lane] = work[u];
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kChunk / 32; ++u) {
          const int j = u * 32 + lane;
          const int w_in = sw[(j + s) & (kChunk - 1)];
          const bool move_in = (w_in & s) != 0 && j < kChunk - s;
          const bool stay = (work[u] & s) == 0;
          work[u] = move_in ? w_in - s : (stay ? work[u] : 0);
        }
        __syncwarp();  // every read of this round before the next round's writes
      }
#pragma unroll
      for (int u = 0; u < kOut / 32; ++u) acc[u] ^= work[u];
    }
#pragma unroll
    for (int u = 0; u < kOut / 32; ++u) out[r * kOut + u * 32 + lane] = acc[u];
  }
}

constexpr int kQuads = 8;  // quads of outputs a thread of the gather

__global__ void __launch_bounds__(kThreads)
compact_gather_kernel(const int* __restrict__ x, const int* __restrict__ li, const int* __restrict__ bi,
                      int* __restrict__ out, int rows) {
  const long long quads = (long long)rows * (kOut / 4);
  const long long q0 = (long long)blockIdx.x * kQuads * kThreads + threadIdx.x;
  int4 l[kQuads], b[kQuads];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {  // every index load in flight before the first gather
    const long long q = q0 + k * kThreads;
    if (q < quads) {
      l[k] = __ldcs(reinterpret_cast<const int4*>(li) + q);
      b[k] = __ldcs(reinterpret_cast<const int4*>(bi) + q);
    }
  }
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const long long q = q0 + k * kThreads;
    if (q < quads) {
      const int* row = x + (q / (kOut / 4)) * kRowWords;
      int4 o;
      o.x = (unsigned)b[k].x < (unsigned)kBanks ? __ldcs(row + b[k].x * 128 + l[k].x) : 0;
      o.y = (unsigned)b[k].y < (unsigned)kBanks ? __ldcs(row + b[k].y * 128 + l[k].y) : 0;
      o.z = (unsigned)b[k].z < (unsigned)kBanks ? __ldcs(row + b[k].z * 128 + l[k].z) : 0;
      o.w = (unsigned)b[k].w < (unsigned)kBanks ? __ldcs(row + b[k].w * 128 + l[k].w) : 0;
      __stcs(reinterpret_cast<int4*>(out) + q, o);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
compact_wherechain_kernel(const int* __restrict__ li, int* __restrict__ out, int rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows; r += (long long)gridDim.x * kWarps) {
    const int4 v = reinterpret_cast<const int4*>(li + r * kOut)[lane];  // the row's first 128 indices
    int pref[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      int p = v.x * (k + 1) + v.y * (k + 1) + v.z * (k + 1) + v.w * (k + 1);
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      pref[k] = p % 64;  // the sums are >= 0: the floored and the truncated remainder agree
    }
#pragma unroll
    for (int u = 0; u < kOut / 32; ++u) {
      const int j = u * 32 + lane;
      int c_of = 0;
#pragma unroll
      for (int k = 0; k < 15; ++k) c_of += pref[k] + k <= j ? 1 : 0;
      int cumb = pref[0];
#pragma unroll
      for (int k = 1; k < 16; ++k) cumb = c_of == k ? pref[k] : cumb;
      out[r * kOut + j] = c_of * 64 + (j - cumb);
    }
  }
}

int grid_for(const void* kernel, long long units) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess) {
    return -1;
  }
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(blocks < resident ? blocks : resident);
}

}  // namespace

// x (rows, 2048) int32 -> out (rows, 256) int32; nrounds 1..9
extern "C" int unopose_compact_rounds(const int* x, int* out, int rows, int nrounds, cudaStream_t stream) {
  if (rows < 0 || nrounds < 1 || nrounds > 9) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int blocks = grid_for((const void*)compact_rounds_kernel, (long long)rows * 32);
  if (blocks < 0) return (int)cudaGetLastError();
  compact_rounds_kernel<<<blocks, kThreads, 0, stream>>>(x, out, rows, nrounds);
  return (int)cudaGetLastError();
}

// x (rows, 2048), li and bi (rows, 256) int32 -> out (rows, 256) int32; every pointer 16-byte aligned
extern "C" int unopose_compact_gather(const int* x, const int* li, const int* bi, int* out, int rows,
                                      cudaStream_t stream) {
  if (rows < 0 || ((uintptr_t)x | (uintptr_t)li | (uintptr_t)bi | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long quads = (long long)rows * (kOut / 4);
  const long long blocks = (quads + kQuads * kThreads - 1) / (kQuads * kThreads);
  compact_gather_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(x, li, bi, out, rows);
  return (int)cudaGetLastError();
}

// li (rows, 256) int32 -> out (rows, 256) int32
extern "C" int unopose_compact_wherechain(const int* li, int* out, int rows, cudaStream_t stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int blocks = grid_for((const void*)compact_wherechain_kernel, (long long)rows * 32);
  if (blocks < 0) return (int)cudaGetLastError();
  compact_wherechain_kernel<<<blocks, kThreads, 0, stream>>>(li, out, rows);
  return (int)cudaGetLastError();
}
