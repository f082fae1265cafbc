// The real-valued stem of a residual binary network (ReActNet),
// stem_conv_bn_sign_kernel: a 3x3 conv of float NHWC x over 3 channels
// with float weights [3, 3, 3, F] and a zero pad, summed in the fixed
// order (kh, kw, c) from 0 with one rounding a product and one a sum,
// then the batch norm ((acc - mean) * inv) * gamma + beta; writes the
// float map and the packed signs (v + b_next) > 0 of the next
// learned-threshold sign (RSign).  Table [5, F]: mean, inv, gamma,
// beta, b_next.
//
// Bound: memory.  Each thread owns one channel for the whole call, so
// its weights and per-channel constants sit in registers, and walks
// kIter pixels; a warp covers 32 consecutive channels of one pixel, so
// the loads and the float store are coalesced and the next RSign's
// word is one ballot.
#include <cstdint>

#include "binary.cuh"

namespace {

constexpr int kThreads = 256;          // most threads a block
constexpr int kIter = 8;               // pixels a thread walks

// threads of a block along the channels (a multiple of 32 dividing F)
// and along the pixels
__host__ __device__ inline int block_channels(int f) {
  int cb = 256;
  while (f % cb) cb /= 2;
  return cb < 32 ? 32 : cb;
}

struct StemGeo {
  int n, h, w, c, f, kh, kw, stride, pad, ho, wo, write_bits;
};

// the stem's epilogue: batch norm, the float map, the next RSign's word
__device__ __forceinline__ void stem_store(float acc, const float* t, int f,
                                           int ldf, int p, int fw,
                                           int lane, float* out,
                                           uint32_t* bits, int write_bits) {
  float v = __fmul_rn(__fsub_rn(acc, t[0]), t[1]);
  v = __fadd_rn(__fmul_rn(v, t[2]), t[3]);
  out[p * ldf + f] = v;
  if (write_bits) {
    const uint32_t word =
        __ballot_sync(REPRO_FULL_MASK, __fadd_rn(v, t[4]) > 0.f);
    if (lane == 0) bits[p * fw + f / 32] = word;
  }
}

// the taps known at compile time: the thread's column of weights lives
// in registers and the taps unroll
template <int KH, int KW, int C>
__global__ void __launch_bounds__(kThreads)
stem_conv_bn_sign_kernel(const float* __restrict__ x,
                         const float* __restrict__ wt,
                         const float* __restrict__ table,
                         float* __restrict__ out,
                         uint32_t* __restrict__ bits, StemGeo g) {
  const int cb = block_channels(g.f);
  const int pb = blockDim.x / cb;
  const int f = blockIdx.y * cb + threadIdx.x % cb;
  float wr[KH * KW * C];
#pragma unroll
  for (int t = 0; t < KH * KW * C; ++t) wr[t] = wt[t * g.f + f];
  const float t5[5] = {table[f], table[g.f + f], table[2 * g.f + f],
                       table[3 * g.f + f], table[4 * g.f + f]};
  const int lane = threadIdx.x & 31;
  const int hw = g.ho * g.wo;
  const int m = g.n * hw;          // m * f < 2^31 (the wrapper checks)
  const int p0 = blockIdx.x * pb * kIter + threadIdx.x / cb;
  for (int it = 0; it < kIter; ++it) {
    const int p = p0 + it * pb;
    if (p >= m) break;
    const int img = p / hw, r = p - img * hw;
    const int oy = r / g.wo, ox = r - oy * g.wo;
    const int y0 = oy * g.stride - g.pad, x0 = ox * g.stride - g.pad;
    const float* xi = x + img * g.h * g.w * C;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KH; ++i) {
      const int iy = y0 + i;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const int ix = x0 + j;
        const bool in = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
        const float* px = xi + (in ? (iy * g.w + ix) * C : 0);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc = __fadd_rn(acc, __fmul_rn(in ? px[c] : 0.f,
                                         wr[(i * KW + j) * C + c]));
      }
    }
    stem_store(acc, t5, f, g.f, p, g.f / 32, lane, out, bits, g.write_bits);
  }
}

dim3 grid_of(long long m, int f) {
  const int cb = block_channels(f);
  const int pb = kThreads / cb;
  return dim3((unsigned)((m + (long long)pb * kIter - 1) / (pb * kIter)),
              f / cb);
}

}  // namespace

// x [n, h, w, 3] float NHWC, wt [3, 3, 3, f], table [5, f], out
// [n*ho*wo, f], bits [n*ho*wo, f/32] or NULL
extern "C" int stem_conv_launch(const float* x, const float* wt,
                                const float* table, float* out,
                                uint32_t* bits, int n, int h, int w, int c,
                                int f, int kh, int kw, int stride, int pad,
                                int ho, int wo, cudaStream_t stream) {
  if ((long long)n * ho * wo == 0) return 0;
  if (f % 32 || f == 0 || kh != 3 || kw != 3 || c != 3)
    return (int)cudaErrorInvalidValue;
  const StemGeo g{n, h, w, c, f, kh, kw, stride, pad, ho, wo,
                  bits != nullptr};
  stem_conv_bn_sign_kernel<3, 3, 3>
      <<<grid_of((long long)n * ho * wo, f),
         (kThreads / block_channels(f)) * block_channels(f), 0, stream>>>(
          x, wt, table, out, bits, g);
  return (int)cudaGetLastError();
}
