// Direct (im2col-free) binary conv2d on channel-packed NHWC words.
//
// x: uint32 [N, H_pad, W_pad, C32], spatial padding already applied as
// zero words (= -1 pixels); w: uint32 [KH*KW*C32, F], tap-major (word
// (kh*KW + kw)*C32 + t pairs with activation word t of window pixel
// (kh, kw)).  Output: the dot int32 [N, HO*WO, F] = 2*(pc - (K_p - K))
// - K with K = KH*KW*C, K_p = 32*KH*KW*C32; or +-1 after dot >= T; or,
// with pack_out, uint32 words [N, HO*WO, ceil(F/32)] with bits at
// filters >= valid_f zeroed.
//
// Replaces: src/repro/kernels/packed_conv.py::packed_conv2d
// (_conv_kernel, _window).  The TPU kernel holds one whole padded image
// resident in VMEM per grid step; a BinaryNet conv2 image is 3.18 MB
// there, far above the 227 KB of shared memory a Hopper block can use,
// so that design does not carry over.
//
// Bound on the H100: operations (an XOR, a popcount and an add per word
// pair, 9 taps x C32 words per output; the bytes are a few MB per
// layer).  Design: a warp owns 8 output pixels x 32 filters, lane =
// filter.  A weight word read along F is one coalesced 128-byte load
// per (tap, word), reused for the 8 pixels; an activation word is the
// same address for every lane (a broadcast), read 4 words at a time
// when C32 % 4 == 0.  The 4 warps of a block share the filter group, so
// its weights stay in L1.  Sums live in registers; the epilogue packs
// 32 filter decisions per pixel with one __ballot_sync, so with
// pack_out no int32 activation reaches device memory.
#include "binary.cuh"

namespace {

constexpr int kPix = 8;     // output pixels per warp
constexpr int kWarps = 4;   // warps per block (same filter group)

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
packed_conv_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ w,
                   const int32_t* __restrict__ tvec, void* out, int nb,
                   int h_pad, int w_pad, int c32, int kh, int kw,
                   int stride, int ho, int wo, int f, int k, int mode,
                   int thr, int pack_out, int valid_f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fcol = blockIdx.y * 32 + lane;
  const bool in = fcol < f;
  const long long n_pix = (long long)nb * ho * wo;
  const long long pix0 = ((long long)blockIdx.x * kWarps + warp) * kPix;

  long long base[kPix];
  int acc[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const long long q = pix0 + p < n_pix ? pix0 + p : 0;   // clamp: reads stay in bounds
    const long long img = q / ((long long)ho * wo);
    const int r = (int)(q - img * ho * wo);
    const int oh = r / wo, ow = r % wo;
    base[p] = ((img * h_pad + (long long)oh * stride) * w_pad +
               (long long)ow * stride) * c32;
    acc[p] = 0;
  }

  for (int i = 0; i < kh; ++i) {
    for (int j = 0; j < kw; ++j) {
      const long long toff = ((long long)i * w_pad + j) * c32;
      const uint32_t* wcol =
          w + (long long)((i * kw + j) * c32) * f + (in ? fcol : 0);
      if (kVec4) {
        for (int t = 0; t < c32; t += 4) {
          const uint32_t w0 = in ? __ldg(wcol + (long long)(t + 0) * f) : 0u;
          const uint32_t w1 = in ? __ldg(wcol + (long long)(t + 1) * f) : 0u;
          const uint32_t w2 = in ? __ldg(wcol + (long long)(t + 2) * f) : 0u;
          const uint32_t w3 = in ? __ldg(wcol + (long long)(t + 3) * f) : 0u;
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const uint4 xv =
                __ldg(reinterpret_cast<const uint4*>(x + base[p] + toff + t));
            acc[p] += repro::xnor_popc(xv.x, w0) + repro::xnor_popc(xv.y, w1) +
                      repro::xnor_popc(xv.z, w2) + repro::xnor_popc(xv.w, w3);
          }
        }
      } else {
        for (int t = 0; t < c32; ++t) {
          const uint32_t wv = in ? __ldg(wcol + (long long)t * f) : 0u;
#pragma unroll
          for (int p = 0; p < kPix; ++p)
            acc[p] += repro::xnor_popc(__ldg(x + base[p] + toff + t), wv);
        }
      }
    }
  }

  const int k_packed = 32 * kh * kw * c32;
  const int fw = (f + 31) / 32;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const long long q = pix0 + p;
    const int dot = repro::closed_form_dot(acc[p], k_packed, k);
    if (pack_out) {
      const bool bit = in && repro::decide(dot, mode, thr, tvec, fcol);
      const uint32_t word = repro::pack_warp(bit, fcol, valid_f);
      if (q < n_pix && lane == 0)
        static_cast<uint32_t*>(out)[q * fw + blockIdx.y] = word;
    } else if (q < n_pix && in) {
      const int v = mode == repro::kNoThreshold
                        ? dot
                        : (repro::decide(dot, mode, thr, tvec, fcol) ? 1 : -1);
      static_cast<int32_t*>(out)[q * f + fcol] = v;
    }
  }
}

}  // namespace

extern "C" int packed_conv2d_launch(const uint32_t* x, const uint32_t* w,
                                    const int32_t* tvec, void* out, int nb,
                                    int h_pad, int w_pad, int c32, int kh,
                                    int kw, int stride, int ho, int wo, int f,
                                    int k, int mode, int thr, int pack_out,
                                    int valid_f, cudaStream_t stream) {
  const long long n_pix = (long long)nb * ho * wo;
  if (n_pix == 0 || f == 0) return 0;
  const long long per_block = (long long)kWarps * kPix;
  const dim3 grid((unsigned)((n_pix + per_block - 1) / per_block),
                  (f + 31) / 32);
  const bool vec4 =
      c32 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec4)
    packed_conv_kernel<true><<<grid, kWarps * 32, 0, stream>>>(
        x, w, tvec, out, nb, h_pad, w_pad, c32, kh, kw, stride, ho, wo, f, k,
        mode, thr, pack_out, valid_f);
  else
    packed_conv_kernel<false><<<grid, kWarps * 32, 0, stream>>>(
        x, w, tvec, out, nb, h_pad, w_pad, c32, kh, kw, stride, ho, wo, f, k,
        mode, thr, pack_out, valid_f);
  return (int)cudaGetLastError();
}
