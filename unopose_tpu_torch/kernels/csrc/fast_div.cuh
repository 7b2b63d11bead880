// Correctly rounded float32 division without the IEEE division's slow path,
// shared by vit_attn.cu (K7: p = e / l of the softmax) and fine_assign.cu
// (K9: the row and column quotients of pred). The IEEE division compiles to
// a reciprocal refined by fmas plus a call to a slow path for operands out
// of its range; the call and its register saves alone took K7 1.6 times its
// time. Both kernels divide by a softmax sum l with 1 <= l < 2^12 (it holds
// exp(0) = 1 and at most 4095 terms of at most 1) and know y = 1 / l,
// rounded to nearest, once per row or column.
//
// The file that includes this header is built with -fmad=false: the plain
// products below are rounded on their own, the fmas are written out.

#pragma once

#include <cuda_runtime.h>

namespace {

// e / l rounded to nearest, as the IEEE division gives it, from y = 1 / l
// (itself so rounded). For e >= 2^-80: q = e * y is within an ulp of e / l,
// the residual e - l q is exact in one fma, and one more fma rounds
// q + (e - l q) y to the nearest float (Markstein's theorem); with
// 1 <= l < 2^12 the residual's granularity ulp(l) ulp(q) is at least
// 2^-137, clear of the subnormals.
__device__ __forceinline__ float div_fast(float e, float l, float y) {
  const float q = e * y;  // a plain rounded multiply
  return fmaf(fmaf(-l, q, e), y, q);
}

// The same for any e >= 0, without a branch: a smaller e is scaled by 2^64
// (exactly), divided so and scaled back, which rounds once more where the
// quotient is subnormal; only a quotient exactly halfway between two
// subnormals can come out wrong there, and the residual's sign settles it.
__device__ __forceinline__ float div_exact(float e, float l, float y) {
  const float es = e * 0x1p64f;
  const float q = div_fast(es, l, y);  // RN(es / l)
  const float r = fmaf(-l, q, es);     // es - l q, exact
  const float c = q * 0x1p-64f;        // RN(q 2^-64), ties to even
  const float down = __fmul_rz(q, 0x1p-64f);
  const float tiny = q - down * 0x1p64f != 0x1p-86f ? c : (r > 0.0f ? down + 0x1p-149f : (r < 0.0f ? down : c));
  return e >= 0x1p-80f ? div_fast(e, l, y) : tiny;
}

}  // namespace
