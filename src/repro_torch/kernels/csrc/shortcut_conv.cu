// The projection shortcut of a residual binary network (Bi-Real Net's
// downsample), shortcut_conv_kernel: the 2x2 average of the float NHWC
// stream x [N, H, W, C], a float 1x1 conv by w [C, F] and its batch norm
// ((acc - mean) * inv) * gamma + beta (table [4, F]: mean, inv, gamma,
// beta); writes the float map [N, H/2, W/2, F] that the half-step's
// fused kernel reads as its shortcut.
//
// Replaces no pallas_call: the residual family is port-only (the JAX
// package has none), so there is no TPU kernel behind it.
//
// Arithmetic: the average is ((x00 + x01) + x10) + x11, times 0.25 (rows
// then columns of the window, as the half-step's average shortcut), and
// each output sums its C products from 0 in channel order, each product
// and each sum rounded on its own (__fmul_rn / __fadd_rn, never an FMA),
// so the map equals shortcut_conv_plain's bit for bit.
//
// A GEMM of M = N * H/2 * W/2 pixels by F channels over K = C, on the
// SIMT units: a block a 64 x 64 tile of 256 threads, a thread 4 pixels x
// 4 channels (16 independent chains); a stage of 16 channels is staged
// in shared memory, the A side averaged on its way in (four 16-byte
// loads of 4 channels a pixel), transposed so that a thread reads its 4
// pixels' values as one 16-byte load and its 4 channels' weights as
// another.  Bounds at Bi-Real Net-18's three projections: layer 2 by
// bytes, layers 3 and 4 by operations, 0.743 us an image in all.
// Offsets into x and out are 64-bit; the wrapper checks that element
// counts stay below 2^31.
#include "binary.cuh"

namespace {

constexpr int kBM = 64;        // pixels a block
constexpr int kBN = 64;        // channels a block
constexpr int kBK = 16;        // input channels a stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
shortcut_conv_kernel(const float* __restrict__ x,
                     const float* __restrict__ wt,
                     const float* __restrict__ table,
                     float* __restrict__ out, int n, int h, int w, int c,
                     int f) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int ho = h / 2, wo = w / 2;
  const int m_total = n * ho * wo;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;      // 4 channels, 4 pixels
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  // the A copy: a thread one pixel's 4 channels of the stage
  const int a_row = tid / 4, a_q = tid % 4;
  const int am = m0 + a_row;
  const bool a_ok = am < m_total;
  size_t a_base = 0;
  if (a_ok) {
    const int img = am / (ho * wo), rem = am - img * ho * wo;
    const int oy = rem / wo, ox = rem - oy * wo;
    a_base = (((size_t)img * h + 2 * oy) * w + 2 * ox) * c + 4 * a_q;
  }
  const size_t row_step = (size_t)w * c;
  // the B copy: a thread 4 channels of one input channel's row
  const int b_k = tid / 16, b_q = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kBK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_ok) {
      const float* p = x + a_base + k0;
      const float4 x00 = __ldg(reinterpret_cast<const float4*>(p));
      const float4 x01 = __ldg(reinterpret_cast<const float4*>(p + c));
      const float4 x10 = __ldg(reinterpret_cast<const float4*>(p + row_step));
      const float4 x11 =
          __ldg(reinterpret_cast<const float4*>(p + row_step + c));
      av.x = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(x00.x, x01.x), x10.x),
                                 x11.x), 0.25f);
      av.y = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(x00.y, x01.y), x10.y),
                                 x11.y), 0.25f);
      av.z = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(x00.z, x01.z), x10.z),
                                 x11.z), 0.25f);
      av.w = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(x00.w, x01.w), x10.w),
                                 x11.w), 0.25f);
    }
    as[4 * a_q + 0][a_row] = av.x;
    as[4 * a_q + 1][a_row] = av.y;
    as[4 * a_q + 2][a_row] = av.z;
    as[4 * a_q + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&bs[b_k][4 * b_q]) = __ldg(
        reinterpret_cast<const float4*>(wt + (size_t)(k0 + b_k) * f + n0 +
                                        4 * b_q));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(ar[i], br[j]));
    }
    __syncthreads();
  }

  const int c4 = n0 + 4 * tx;
  const float4 mean = __ldg(reinterpret_cast<const float4*>(table + c4));
  const float4 inv = __ldg(reinterpret_cast<const float4*>(table + f + c4));
  const float4 gam =
      __ldg(reinterpret_cast<const float4*>(table + 2 * f + c4));
  const float4 bet =
      __ldg(reinterpret_cast<const float4*>(table + 3 * f + c4));
  const float mr[4] = {mean.x, mean.y, mean.z, mean.w};
  const float ir[4] = {inv.x, inv.y, inv.z, inv.w};
  const float gr[4] = {gam.x, gam.y, gam.z, gam.w};
  const float br[4] = {bet.x, bet.y, bet.z, bet.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= m_total) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(acc[i][j], mr[j]), ir[j]), gr[j]),
          br[j]);
    *reinterpret_cast<float4*>(out + (size_t)m * f + c4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// x [n, h, w, c] float NHWC (h, w even), wt [c, f], table [4, f], out
// [n, h/2, w/2, f].  A shape the kernel does not take is refused
// (cudaErrorInvalidValue): c % 16 and f % 64 must be 0.
extern "C" int shortcut_conv_launch(const float* x, const float* wt,
                                    const float* table, float* out, int n,
                                    int h, int w, int c, int f,
                                    cudaStream_t stream) {
  if (n < 0 || h < 0 || w < 0 || h % 2 || w % 2 || c <= 0 || c % kBK ||
      f <= 0 || f % kBN)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * (h / 2) * (w / 2);
  if (m == 0) return 0;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)(f / kBN));
  shortcut_conv_kernel<<<grid, kThreads, 0, stream>>>(x, wt, table, out, n,
                                                      h, w, c, f);
  return (int)cudaGetLastError();
}
