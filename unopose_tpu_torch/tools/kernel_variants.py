"""What each part of the K1 (FPS) and K7 (ViT attention) designs buys, on one CUDA card.

    python -m unopose_tpu_torch.tools.kernel_variants [--parent DIR] [--reps 20] [--out FILE]

Builds the shipped sources ``kernels/csrc/fps.cu`` and ``kernels/csrc/vit_attn.cu`` and variants of each,
every variant the shipped text with one design choice replaced, each into a library of its own (``nvcc`` with
the package's flags, all builds started together), and times every build on the same inputs at the main path's
shapes with CUDA events: K1 at 16 x 5000 -> 2048 and 16 x 2048 -> 196, K7 at 32 x 261 x 768 bf16 with 12
heads read in place from the qkv output. The builds run in turns, forward then backward, and each reports the
median of its two times. ``--parent DIR``: a checkout of another commit, whose two sources join as the builds
``parent``.

Variants of K1 (shipped: 256 threads a cloud up to 6144 points, the points in registers, a packed-key argmax,
one barrier a step): ``t1024`` and ``t512``, that many threads a cloud; ``cluster2`` and ``cluster4``, a
cluster of 2 or 4 CTAs a cloud, each holding its share of the points and sending its warps' keys to every CTA
of the cluster through distributed shared memory, one cluster barrier a step.
Variants of K7 (shipped: K and V rows of hd 64 XOR-swizzled, three blocks an SM, the division without its
slow path, every tile over all 17 key steps): ``ieee_division``, the plain ``e / l``, whose slow path is a
call; ``padded_two_blocks``, rows padded by one 16-byte chunk and two blocks an SM; ``runtime_steps``, the
key loops ended at ceil(N / 16) steps at run time. Beside them, ``scaled_dot_product_attention`` on the same
q, k, v (PyTorch's own kernel, the yardstick; the port never calls it).

Every build's output is checked: K1's indices equal to the plain loop's, K7's outputs bitwise equal to the
shipped kernel's (for ``parent``, the first version, the share of equal outputs is reported too). Prints the
card's name and power limit, then one JSON line; ``--out`` writes the JSON there too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from unopose_tpu_torch.kernels import build
from unopose_tpu_torch.ops.fps import fps_plain
from unopose_tpu_torch.ops.lrf import global_lrf

_P = ctypes.c_void_p

CLUSTER_FPS = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
namespace cg = cooperative_groups;
namespace {
constexpr int kThreads = 1024, kWarps = 32, CL = CLUSTER;

template <int PER>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ pts, int n, int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float *xs = smem, *ys = xs + n, *zs = ys + n;
  __shared__ unsigned s_bits[2][CL * kWarps];
  __shared__ int s_idx[2][CL * kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cloud = blockIdx.x / CL;
  const float* p = pts + (size_t)cloud * n * 3;
  int* o = out + (size_t)cloud * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += kThreads) { xs[i] = p[3 * i]; ys[i] = p[3 * i + 1]; zs[i] = p[3 * i + 2]; }
  float px[PER], py[PER], pz[PER], md[PER];
  for (int u = 0; u < PER; ++u) {
    const int i = tid + (u * CL + rank) * kThreads;
    md[u] = 1e10f;
    if (i < n) { px[u] = p[3 * i]; py[u] = p[3 * i + 1]; pz[u] = p[3 * i + 2]; }
  }
  unsigned* rb[CL];
  int* ri[CL];
  for (int c = 0; c < CL; ++c) {
    rb[c] = cluster.map_shared_rank(&s_bits[0][0], c);
    ri[c] = cluster.map_shared_rank(&s_idx[0][0], c);
  }
  if (tid == 0 && rank == 0) o[0] = 0;
  cluster.sync();
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float x1 = xs[last], y1 = ys[last], z1 = zs[last];
    float best = -1.0f;
    int besti = INT_MAX;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + (u * CL + rank) * kThreads;
      if (i < n) {
        const float dx = __fsub_rn(px[u], x1), dy = __fsub_rn(py[u], y1), dz = __fsub_rn(pz[u], z1);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float m = fminf(md[u], d);
        md[u] = m;
        if (m > best) { best = m; besti = i; }
      }
    }
    unsigned bits = besti < n ? __float_as_uint(best) : 0u;
    unsigned top = __reduce_max_sync(0xffffffffu, bits);
    int idx = __reduce_min_sync(0xffffffffu, bits == top ? besti : INT_MAX);
    const int par = j & 1;
    if (lane < CL) {
      rb[lane][par * CL * kWarps + rank * kWarps + warp] = top;
      ri[lane][par * CL * kWarps + rank * kWarps + warp] = idx;
    }
    cluster.sync();
    unsigned bb = 0u;
    int bi = INT_MAX;
    for (int c = 0; c < CL; ++c) {
      const unsigned b2 = s_bits[par][c * kWarps + lane];
      const int i2 = s_idx[par][c * kWarps + lane];
      if (b2 > bb || (b2 == bb && i2 < bi)) { bb = b2; bi = i2; }
    }
    top = __reduce_max_sync(0xffffffffu, bb);
    idx = __reduce_min_sync(0xffffffffu, bb == top ? bi : INT_MAX);
    last = idx;
    if (tid == 0 && rank == 0) o[j] = last;
  }
  cluster.sync();
}

template <int PER>
int launch(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<PER><<<batch * CL, kThreads, smem, stream>>>(pts, n, npoint, out);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int unopose_fps(const float* pts, int* out, int batch, int n, int npoint, cudaStream_t stream) {
  switch ((n + CL * kThreads - 1) / (CL * kThreads)) {
    case 1: return launch<1>(pts, out, batch, n, npoint, stream);
    case 2: return launch<2>(pts, out, batch, n, npoint, stream);
    case 3: return launch<3>(pts, out, batch, n, npoint, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"the shipped source no longer holds {old[:60]!r}: update this variant")
    return text.replace(old, new)


def sources(parent: Path | None) -> dict:
    """{build name: (kernel, CUDA source text)}."""
    fps = (build.CSRC / "fps.cu").read_text()
    attn = (build.CSRC / "vit_attn.cu").read_text()
    out = {"fps": ("K1", fps), "vit_attn": ("K7", attn)}
    for threads, per in ((1024, 6), (512, 12)):
        text = _sub(fps, "constexpr int kSmallT = 256;", f"constexpr int kSmallT = {threads};")
        text = _sub(text, "constexpr int kSmallPer = 24;", f"constexpr int kSmallPer = {per};")
        out[f"fps_t{threads}"] = ("K1", text)
    for cl in (2, 4):
        out[f"fps_cluster{cl}"] = ("K1", CLUSTER_FPS.replace("CLUSTER", str(cl)))
    out["vit_attn_ieee_division"] = ("K7", _sub(
        attn, "return kExact ? div_exact(e, l, y) : div_fast(e, l, y);", "return e / l;"))
    text = _sub(attn, "  return HD % 64 == 0 ? HD : HD + 8;", "  return HD + 8;")
    text = _sub(text, "  return HD % 64 == 0 ? r * HD + ((c ^ (r & 7)) << 3) : r * (HD + 8) + c * 8;",
                "  return r * (HD + 8) + c * 8;")
    out["vit_attn_padded_two_blocks"] = ("K7", _sub(text, "__launch_bounds__(kThreads, HD <= 64 ? 3 : 2)",
                                                    "__launch_bounds__(kThreads, 2)"))
    text = attn.replace("p < kSteps; ++p)", "p < kSteps && 16 * p < n; ++p)")
    text = text.replace("nt < 2 * kSteps; ++nt)", "nt < 2 * kSteps && 16 * (nt >> 1) < n; ++nt)")
    out["vit_attn_runtime_steps"] = ("K7", _sub(text, "kk < kSteps; ++kk)", "kk < kSteps && 16 * kk < n; ++kk)"))
    if parent is not None:
        csrc = parent / "unopose_tpu_torch" / "kernels" / "csrc"
        out["fps_parent"] = ("K1", (csrc / "fps.cu").read_text())
        out["vit_attn_parent"] = ("K7", (csrc / "vit_attn.cu").read_text())
    return out


def compile_all(srcs: dict, workdir: Path) -> dict:
    """Build every source into workdir/<name>.so, all nvcc processes at once; {name: ctypes.CDLL}."""
    workdir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, (_, text) = item
        src, lib = workdir / f"{name}.cu", workdir / f"{name}.so"
        src.write_text(text)
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise build.KernelBuildError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(srcs)) as ex:
        return dict(ex.map(one, srcs.items()))


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    srcs = sources(args.parent)
    libs = compile_all(srcs, build.BUILD_DIR / "variants")
    stream = lambda: _P(torch.cuda.current_stream().cuda_stream)

    rng = np.random.default_rng(0)
    clouds = {}
    for b, n, k in ((16, 5000, 2048), (16, 2048, 196)):
        pts = rng.uniform(-0.1, 0.1, size=(b, n, 3)).astype(np.float32) + np.array([0, 0, 0.6], np.float32)
        pts = global_lrf(torch.from_numpy(pts).to(dev)).contiguous()
        clouds[f"{b}x{n}->{k}"] = (pts, k, fps_plain(pts, k), torch.empty((b, k), dtype=torch.int32, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, N, H, hd = 32, 261, 12, 64
    qkv = torch.randn(B, N, 3 * H * hd, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * hd, dim=-1)

    for name, lib in libs.items():
        fn = lib.unopose_fps if srcs[name][0] == "K1" else lib.unopose_mha_fused
        fn.argtypes = build._SIGNATURES["unopose_fps" if srcs[name][0] == "K1" else "unopose_mha_fused"]

    def run_case(name: str, key: str):
        lib = libs[name]
        if srcs[name][0] == "K1":
            pts, npoint, _, out = clouds[key]
            call = lambda: lib.unopose_fps(_P(pts.data_ptr()), _P(out.data_ptr()), pts.shape[0], pts.shape[1],
                                           npoint, stream())
        else:
            out = torch.empty((B, N, H * hd), dtype=torch.bfloat16, device=dev)
            call = lambda: lib.unopose_mha_fused(_P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
                                                 _P(out.data_ptr()), B, N, H, hd, q.stride(0), q.stride(1), 1,
                                                 hd**-0.5, stream())
        err = call()
        if err:
            raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
        return call, out

    cases = [(name, key) for name in srcs for key in (clouds if srcs[name][0] == "K1" else ("32x261x768",))]
    times = {c: [] for c in cases}
    heads = [x.reshape(B, N, H, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
    sdpa = []
    for order in (cases, cases[::-1]):
        sdpa.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads), args.reps))
        for name, key in order:
            call, _ = run_case(name, key)
            times[(name, key)].append(cuda_ms(call, args.reps))
    shipped_attn = run_case("vit_attn", "32x261x768")[1].clone()
    results = []
    for name, key in cases:
        _, out = run_case(name, key)
        torch.cuda.synchronize()
        if srcs[name][0] == "K1":
            check = dict(indices_equal_plain=bool(torch.equal(out, clouds[key][2])))
        else:
            check = dict(bitwise_equal_shipped=bool(torch.equal(out.view(torch.int16), shipped_attn.view(torch.int16))),
                         equal_share_shipped=(out == shipped_attn).float().mean().item())
        results.append(dict(build=name, kernel=srcs[name][0], shape=key, ms=float(np.median(times[(name, key)])),
                            **check))
    results.append(dict(build="scaled_dot_product_attention", kernel="K7", shape="32x261x768",
                        ms=float(np.median(sdpa))))
    print(card)
    line = json.dumps({"card": card, "variants": results})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
