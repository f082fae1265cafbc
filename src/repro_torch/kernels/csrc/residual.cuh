// The float side of one residual half-step (ReActNet): the epilogue of
// packed_conv's fused variant (packed_conv.cu), which runs these float32
// operations in this order, as residual_epilogue_plain in
// kernels/residual.py does.  Per output element:
//     d  = dot + corr[class(pixel), f]       (int32: the 0-padded dot)
//     v  = ((float(d) * alpha - mean) * inv) * gamma + beta
//     o  = v + shortcut
//     o  = o + move_a;  o = o > 0 ? o : o * slope;  o = o + move_b
//     bit f of the next RSign's word = (o + b_next) > 0
// every float operation rounded on its own (__fmul_rn / __fadd_rn are
// never contracted into an FMA), so the plain version in torch, which
// runs the same operations in the same order, matches bit for bit.
//
// The correction: a padded tap of a -1 padded conv adds -sum_c sign(w)
// where a 0 padded one adds 0, so dot_0 = dot_-1 + sum over the padded
// taps of sum_c sign(w[tap, c, f]).  With a pad of 1 a pixel's padded
// taps are the window's first and/or last row and column; the class
// (top + 2*bottom) * 4 + (left + 2*right) indexes the 16 rows of corr,
// and class 0 (no padded tap) adds 0.
//
// The shortcut: identity (x[p, f]), the 2x2 average of the twice larger
// map (((x00 + x01) + x10) + x11) * 0.25, or, for a half-step that
// doubles the channels, x[p, f mod C].
#pragma once

#include <cstdint>

namespace repro {

enum Shortcut { kIdentity = 0, kAvgPool = 1, kDuplicate = 2 };

// one output channel's column of the table [9, F]: alpha, BN mean,
// 1/sqrt(var+eps), gamma, beta, the RPReLU's bias before and its slope,
// its bias after, the next RSign's bias
struct ResidualChannel {
  float alpha, mean, inv, gamma, beta, move_a, slope, move_b, b_next;
};

__device__ __forceinline__ ResidualChannel residual_channel(
    const float* __restrict__ table, int f, int ld) {
  return ResidualChannel{table[f],          table[ld + f],
                         table[2 * ld + f], table[3 * ld + f],
                         table[4 * ld + f], table[5 * ld + f],
                         table[6 * ld + f], table[7 * ld + f],
                         table[8 * ld + f]};
}

// the border class of output pixel (oy, ox) of a k x k conv over an
// h_in x w_in map
__device__ __forceinline__ int border_class(int oy, int ox, int stride,
                                            int pad, int k, int h_in,
                                            int w_in) {
  const int y0 = oy * stride - pad, x0 = ox * stride - pad;
  return ((y0 < 0) + 2 * (y0 + k - 1 >= h_in)) * 4 + (x0 < 0) +
         2 * (x0 + k - 1 >= w_in);
}

// the shortcut of output pixel p (image img, row oy, column ox of an
// ho x wo map) at channel f, from a map of cs channels; every index is
// below 2^31 (the wrappers check)
template <int SC>
__device__ __forceinline__ float shortcut_at(const float* __restrict__ sc,
                                             int p, int f, int img, int oy,
                                             int ox, int ho, int wo,
                                             int cs) {
  if (SC == kIdentity) return sc[p * cs + f];
  if (SC == kDuplicate) return sc[p * cs + (f < cs ? f : f - cs)];
  const int wi = 2 * wo;
  const int b = ((img * 2 * ho + 2 * oy) * wi + 2 * ox) * cs + f;
  const int row = wi * cs;
  return __fmul_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(sc[b], sc[b + cs]), sc[b + row]),
                sc[b + row + cs]),
      0.25f);
}

// the float stream's element from the 0-padded dot d and the shortcut s
__device__ __forceinline__ float residual_out(int d, float s,
                                              const ResidualChannel& c) {
  float v = __fmul_rn((float)d, c.alpha);
  v = __fmul_rn(__fsub_rn(v, c.mean), c.inv);
  v = __fadd_rn(__fmul_rn(v, c.gamma), c.beta);
  float o = __fadd_rn(__fadd_rn(v, s), c.move_a);
  o = o > 0.f ? o : __fmul_rn(o, c.slope);
  return __fadd_rn(o, c.move_b);
}

// the next RSign's decision on the stream's element o
__device__ __forceinline__ bool next_sign(float o, const ResidualChannel& c) {
  return __fadd_rn(o, c.b_next) > 0.f;
}

}  // namespace repro
