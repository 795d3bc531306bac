// exp2 on the fp32 pipe: a polynomial in place of MUFU.EX2.
//
// The mixture posterior (posterior.cu) is bound by its exponentials on the
// special-function units, while the fp32 pipe beside them idles; this
// version takes a fixed share of them onto the fp32 pipe.  For x <= 0:
//
//   x  = max(x, -126)               the result stays a normal number
//   j  = x + 1.5 * 2^23             rounds x to the integer n, held in the
//   n  = j - 1.5 * 2^23               low mantissa bits of j
//   f  = x - n                      in [-0.5, 0.5], exact
//   p  = P(f) ~ 2^f                 degree 5, Horner, five FFMAs
//   2^x = p * 2^n                   n added to p's exponent bits: j's bits
//                                   shifted left by 23 are n << 23 (mod 2^32)
//
// P's coefficients are float32 values chosen for float32 evaluation: a
// relative minimax fit with P(0) = 1 on [-0.5, 0.5], each coefficient then
// moved by a few ulp to minimise the float32 Horner evaluation's error.
// Their relative error against 2^x in float64 is at most 1.85e-7 over
// every float32 f with 2^-8 <= |f| <= 0.5 (tests/test_torch_posterior.py
// reads this table and holds an emulation of this function to 2e-7).
// MUFU.EX2's own error is about 2 ulp.
//
// Every source that includes this header is rebuilt when it changes (the
// build digest covers csrc/*.cuh).

#pragma once

namespace mmlf {

// P(f) = EXP2_P0 + EXP2_P1 f + ... + EXP2_P5 f^5 (scalars: device code may
// read a namespace-scope constexpr scalar, not an array element)
constexpr float EXP2_P0 = 0x1p+0f;
constexpr float EXP2_P1 = 0x1.62e41ap-1f;
constexpr float EXP2_P2 = 0x1.ebfa16p-3f;
constexpr float EXP2_P3 = 0x1.c6bfeap-5f;
constexpr float EXP2_P4 = 0x1.3ccf14p-7f;
constexpr float EXP2_P5 = 0x1.593208p-10f;
constexpr float EXP2_POLY_MIN = -126.0f;
constexpr float EXP2_ROUND = 12582912.0f;   // 1.5 * 2^23

__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, EXP2_POLY_MIN);
  const float j = x + EXP2_ROUND;
  const float f = x - (j - EXP2_ROUND);
  float p = fmaf(EXP2_P5, f, EXP2_P4);
  p = fmaf(p, f, EXP2_P3);
  p = fmaf(p, f, EXP2_P2);
  p = fmaf(p, f, EXP2_P1);
  p = fmaf(p, f, EXP2_P0);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(j) << 23));
}

}  // namespace mmlf
