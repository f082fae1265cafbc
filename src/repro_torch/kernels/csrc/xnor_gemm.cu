// Binary-weight GEMM: float32 or bf16 activations x [M, K] times packed
// weights w [K32, N] (uint32 words packed over K: bit b of word j is row
// 32*j + b, a 0 bit is -1), float32 accumulation over all of K, then
// y = acc * alpha[N] once.  Outputs: y in x's dtype (bf16 rounded to
// nearest even); +-1 in x's dtype after y >= T (T a float scalar or a
// float32 [N] vector); or, with pack_out, those decisions packed into
// uint32 words [M, ceil(N/32)] with every bit at a column >= valid_n
// zeroed.
//
// Replaces: src/repro/kernels/xnor_gemm.py::xnor_gemm (_kernel).  The
// TPU kernel unpacks each [bk/32, bn] weight tile to +-1 bf16 in VMEM
// and feeds the MXU, carrying the float32 sum across sequential K grid
// steps in VMEM scratch.  Hopper blocks run in no order, so the whole K
// loop runs inside one block and the sum sits in registers.
//
// Bound on the H100: bytes at decode widths (M = 1 reads 8.4 MB of
// packed weights for 8192 x 8192), operations at M = 128 (2*M*K*N at the
// tensor-core rate for bf16, the CUDA-core rate for float32).  This
// first version runs on the CUDA cores: each +-1 product is one FFMA by
// +1.0 or -1.0 (exact), so it is bound by the FFMA rate, and far from the
// bf16 tensor-core bound; mma/wgmma on weights unpacked in shared memory
// is later work.
//
// Design: a block of 8 warps owns RM rows x 32 columns (lane = column,
// so the weight-word reads along N coalesce into 128 bytes per warp).
// K is split over the warps: per stage each warp takes 32/RM words, so a
// stage is 8192 activations (32 KB of float32 in shared memory, bf16
// widened on the way in) whatever RM is, and every thread loads 32 of
// them as 16-byte chunks.  The next stage's activations and words are
// loaded into registers while the current one is computed.  A thread
// reads its row's activations as float4 broadcasts (every lane the same
// address) and adds each with the sign of its bit.  After the K loop
// the 8 warps' partial sums meet in shared memory and are added in warp
// order, then alpha, the threshold and a __ballot_sync per row finish.
// RM is the smallest power of two >= M, at most 32, so M = 1 costs no
// idle rows and spreads K over 32 words per warp.
#include <cuda_bf16.h>

#include "binary.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageFloats = 8192;          // 32 KB of float32 per stage
enum XType { kF32 = 0, kBF16 = 1 };

template <int RM, int XT>
struct Geo {
  static constexpr int kWordsPerWarp = 32 / RM;
  static constexpr int kStageWords = kWarps * kWordsPerWarp;
  static constexpr int kRowLen = kStageWords * 32;      // = 8192 / RM
  static constexpr int kChunkElems = XT == kF32 ? 4 : 8;   // 16 bytes
  static constexpr int kChunks = kStageFloats / kChunkElems / kThreads;
  static constexpr int kElemBytes = XT == kF32 ? 4 : 2;
};

// this thread's 16-byte chunks of stage s of x (zero outside M and K)
template <int RM, int XT>
__device__ __forceinline__ void load_x(const char* __restrict__ x, int m,
                                       int k, long long row0, int s,
                                       uint4 (&reg)[Geo<RM, XT>::kChunks]) {
  using G = Geo<RM, XT>;
#pragma unroll
  for (int i = 0; i < G::kChunks; ++i) {
    const int e = (i * kThreads + threadIdx.x) * G::kChunkElems;
    const long long gr = row0 + e / G::kRowLen;
    const int gk = s * G::kRowLen + e % G::kRowLen;
    reg[i] = (gr < m && gk < k)
                 ? __ldg(reinterpret_cast<const uint4*>(
                       x + (gr * k + gk) * G::kElemBytes))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the same chunks, widened to float32, into the stage buffer
template <int RM, int XT>
__device__ __forceinline__ void store_x(float* xs,
                                        const uint4 (&reg)[Geo<RM, XT>::kChunks]) {
  using G = Geo<RM, XT>;
#pragma unroll
  for (int i = 0; i < G::kChunks; ++i) {
    const int e = (i * kThreads + threadIdx.x) * G::kChunkElems;
    const uint4 v = reg[i];
    if (XT == kF32) {
      *reinterpret_cast<float4*>(xs + e) =
          make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                      __uint_as_float(v.z), __uint_as_float(v.w));
    } else {       // two bf16 per word, the lower-addressed one low
      *reinterpret_cast<float4*>(xs + e) = make_float4(
          __uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
          __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
      *reinterpret_cast<float4*>(xs + e + 4) = make_float4(
          __uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
          __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
    }
  }
}

// this warp's weight words of stage s for column col (zero outside)
template <int RM, int XT>
__device__ __forceinline__ void load_w(const uint32_t* __restrict__ w,
                                       int n, int k32, int col, int s,
                                       uint32_t (&reg)[Geo<RM, XT>::kWordsPerWarp]) {
  using G = Geo<RM, XT>;
  const int j0 = s * G::kStageWords + (threadIdx.x >> 5) * G::kWordsPerWarp;
#pragma unroll
  for (int jj = 0; jj < G::kWordsPerWarp; ++jj) {
    const int j = j0 + jj;
    reg[jj] = (j < k32 && col < n) ? __ldg(w + (long long)j * n + col) : 0u;
  }
}

// +1.0f where bit b of word is set, else -1.0f
__device__ __forceinline__ float sign_of_bit(uint32_t word, int b) {
  return __uint_as_float(0xBF800000u ^ ((word << (31 - b)) & 0x80000000u));
}

template <int RM, int XT>
__global__ void __launch_bounds__(kThreads)
xnor_gemm_kernel(const char* __restrict__ x, const uint32_t* __restrict__ w,
                 const float* __restrict__ alpha,
                 const float* __restrict__ tvec, void* out, int m, int n,
                 int k32, int mode, float thr, int pack_out, int valid_n) {
  using G = Geo<RM, XT>;
  __shared__ __align__(16) float xs[kStageFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * RM;
  const int col = blockIdx.y * 32 + lane;
  const int k = 32 * k32;
  const int n_stages = (k32 + G::kStageWords - 1) / G::kStageWords;

  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.f;

  uint4 xr[G::kChunks];
  uint32_t wr[G::kWordsPerWarp];
  if (n_stages > 0) {
    load_x<RM, XT>(x, m, k, row0, 0, xr);
    load_w<RM, XT>(w, n, k32, col, 0, wr);
  }
  for (int s = 0; s < n_stages; ++s) {
    store_x<RM, XT>(xs, xr);
    uint32_t wc[G::kWordsPerWarp];
#pragma unroll
    for (int jj = 0; jj < G::kWordsPerWarp; ++jj) wc[jj] = wr[jj];
    __syncthreads();
    if (s + 1 < n_stages) {     // in flight while this stage computes
      load_x<RM, XT>(x, m, k, row0, s + 1, xr);
      load_w<RM, XT>(w, n, k32, col, s + 1, wr);
    }
    const int j0 = s * G::kStageWords + warp * G::kWordsPerWarp;
#pragma unroll
    for (int jj = 0; jj < G::kWordsPerWarp; ++jj) {
      if (j0 + jj >= k32) break;                    // warp-uniform
      const float* xj = xs + (warp * G::kWordsPerWarp + jj) * 32;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float s0 = sign_of_bit(wc[jj], 4 * q);
        const float s1 = sign_of_bit(wc[jj], 4 * q + 1);
        const float s2 = sign_of_bit(wc[jj], 4 * q + 2);
        const float s3 = sign_of_bit(wc[jj], 4 * q + 3);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float4 v =
              *reinterpret_cast<const float4*>(xj + r * G::kRowLen + 4 * q);
          acc[r] = fmaf(v.x, s0, acc[r]);
          acc[r] = fmaf(v.y, s1, acc[r]);
          acc[r] = fmaf(v.z, s2, acc[r]);
          acc[r] = fmaf(v.w, s3, acc[r]);
        }
      }
    }
    __syncthreads();
  }

  // the warps' partial sums over their words of K meet in shared memory
  float* red = xs;                                  // [kWarps][RM][32]
#pragma unroll
  for (int r = 0; r < RM; ++r) red[(warp * RM + r) * 32 + lane] = acc[r];
  __syncthreads();

  const bool in = col < n;
  const float a = in ? alpha[col] : 0.f;
  const float t = mode == repro::kPerChannel ? (in ? tvec[col] : 0.f) : thr;
  const int nw = (n + 31) / 32;
  for (int r = warp; r < RM; r += kWarps) {         // warp-uniform
    float y = red[r * 32 + lane];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) y += red[(q * RM + r) * 32 + lane];
    y *= a;
    const long long gr = row0 + r;
    if (pack_out) {
      const uint32_t word = repro::pack_warp(in && y >= t, col, valid_n);
      if (gr < m && lane == 0)
        static_cast<uint32_t*>(out)[gr * nw + blockIdx.y] = word;
    } else if (gr < m && in) {
      const float v = mode == repro::kNoThreshold ? y
                                                  : (y >= t ? 1.f : -1.f);
      if (XT == kF32)
        static_cast<float*>(out)[gr * n + col] = v;
      else
        static_cast<__nv_bfloat16*>(out)[gr * n + col] =
            __float2bfloat16_rn(v);
    }
  }
}

template <int RM, int XT>
void launch(const void* x, const uint32_t* w, const float* alpha,
            const float* tvec, void* out, int m, int n, int k32, int mode,
            float thr, int pack_out, int valid_n, cudaStream_t stream) {
  const dim3 grid((m + RM - 1) / RM, (n + 31) / 32);
  xnor_gemm_kernel<RM, XT><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(x), w, alpha, tvec, out, m, n, k32, mode, thr,
      pack_out, valid_n);
}

template <int XT>
void launch_rows(const void* x, const uint32_t* w, const float* alpha,
                 const float* tvec, void* out, int m, int n, int k32,
                 int mode, float thr, int pack_out, int valid_n,
                 cudaStream_t stream) {
#define REPRO_XNOR_LAUNCH(RM)                                             \
  launch<RM, XT>(x, w, alpha, tvec, out, m, n, k32, mode, thr, pack_out, \
                 valid_n, stream)
  if (m <= 1) REPRO_XNOR_LAUNCH(1);
  else if (m <= 2) REPRO_XNOR_LAUNCH(2);
  else if (m <= 4) REPRO_XNOR_LAUNCH(4);
  else if (m <= 8) REPRO_XNOR_LAUNCH(8);
  else if (m <= 16) REPRO_XNOR_LAUNCH(16);
  else REPRO_XNOR_LAUNCH(32);
#undef REPRO_XNOR_LAUNCH
}

}  // namespace

// x_dtype: 0 float32, 1 bfloat16.  x must be 16-byte aligned (the
// wrapper guarantees it); K = 32 * k32 and x is zero beyond the valid K.
extern "C" int xnor_gemm_launch(const void* x, int x_dtype,
                                const uint32_t* w, const float* alpha,
                                const float* tvec, void* out, int m, int n,
                                int k32, int mode, float thr, int pack_out,
                                int valid_n, cudaStream_t stream) {
  if (m == 0 || n == 0) return 0;
  if (x_dtype == kF32)
    launch_rows<kF32>(x, w, alpha, tvec, out, m, n, k32, mode, thr,
                      pack_out, valid_n, stream);
  else if (x_dtype == kBF16)
    launch_rows<kBF16>(x, w, alpha, tvec, out, m, n, k32, mode, thr,
                       pack_out, valid_n, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
