// Fully-binary GEMM: uint32 words x [M, K32] times w [N, K32] ->
// the signed dot int32 [M, N] = 2*(pc(XNOR) - (32*K32 - k)) - k, or
// +-1 after dot >= T (T scalar or per-channel [N]), or, with pack_out,
// those decisions packed into uint32 words [M, ceil(N/32)] with every
// bit at a column >= valid_n zeroed.
//
// Replaces: src/repro/kernels/popcount_gemm.py::popcount_gemm
// (_kernel, _xnor_planes).  The TPU kernel carries Harley-Seal residues
// across sequential K grid steps in VMEM scratch; Hopper blocks run in
// no order, so here the whole K loop runs inside one block and the
// popcount total sits in registers.
//
// Bound on the H100: operations for square-ish shapes (each word pair
// is an XOR, a popcount and an add on the CUDA cores, and __popc issues
// at a quarter of the int32 rate); bytes for the thin classifier head.
// Design: a block of 8 warps owns a 64-row x 32-column output tile and
// stages 32-word K slices of both operands in shared memory with
// coalesced 128-byte row reads.  Lane = output column, so a weight word
// read is conflict-free (the tile is stored transposed, padded to 33)
// and an activation word read is a broadcast; each thread keeps 8 row
// sums.  The epilogue packs a row's 32 decisions with one __ballot_sync,
// so the int32 [M, N] dot never reaches device memory with pack_out.
#include "binary.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBM = kWarps * kRowsPerWarp;   // 64 rows per block
constexpr int kBN = 32;                      // columns per block
constexpr int kBK = 32;                      // words per K slice
constexpr int kThreads = kWarps * 32;
constexpr int kXLoads = kBM * kBK / kThreads;   // per thread per slice
constexpr int kWLoads = kBN * kBK / kThreads;

__global__ void __launch_bounds__(kWarps * 32)
popcount_gemm_kernel(const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ w,
                     const int32_t* __restrict__ tvec, void* out, int m,
                     int n, int k32, int k, int mode, int thr, int pack_out,
                     int valid_n) {
  __shared__ uint32_t xs[kBM][kBK + 1];
  __shared__ uint32_t ws[kBK][kBN + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int col = col0 + lane;

  int acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0;

  for (int t0 = 0; t0 < k32; t0 += kBK) {
    const int tn = min(kBK, k32 - t0);
    // issue every load of the slice before storing any (one L2 round
    // trip per slice)
    uint32_t xv[kXLoads], wv[kWLoads];
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const long long gr = row0 + i / kBK;
      xv[j] = (gr < m && i % kBK < tn) ? __ldg(x + gr * k32 + t0 + i % kBK)
                                       : 0u;
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int gc = col0 + i / kBK;
      wv[j] = (gc < n && i % kBK < tn)
                  ? __ldg(w + (long long)gc * k32 + t0 + i % kBK) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      xs[i / kBK][i % kBK] = xv[j];
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = j * kThreads + threadIdx.x;
      ws[i % kBK][i / kBK] = wv[j];
    }
    __syncthreads();
    for (int t = 0; t < tn; ++t) {
      const uint32_t wt = ws[t][lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        acc[r] += repro::xnor_popc(xs[warp * kRowsPerWarp + r][t], wt);
    }
    __syncthreads();
  }

  const bool in = col < n;
  const int nw = (n + 31) / 32;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long gr = row0 + warp * kRowsPerWarp + r;
    const int dot = repro::closed_form_dot(acc[r], 32 * k32, k);
    if (pack_out) {
      const bool bit = in && repro::decide(dot, mode, thr, tvec, col);
      const uint32_t word = repro::pack_warp(bit, col, valid_n);
      if (gr < m && lane == 0)
        static_cast<uint32_t*>(out)[gr * nw + blockIdx.y] = word;
    } else if (gr < m && in) {
      const int v = mode == repro::kNoThreshold
                        ? dot
                        : (repro::decide(dot, mode, thr, tvec, col) ? 1 : -1);
      static_cast<int32_t*>(out)[gr * n + col] = v;
    }
  }
}

}  // namespace

extern "C" int popcount_gemm_launch(const uint32_t* x, const uint32_t* w,
                                    const int32_t* tvec, void* out, int m,
                                    int n, int k32, int k, int mode, int thr,
                                    int pack_out, int valid_n,
                                    cudaStream_t stream) {
  if (m == 0 || n == 0) return 0;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  popcount_gemm_kernel<<<grid, kWarps * 32, 0, stream>>>(
      x, w, tvec, out, m, n, k32, k, mode, thr, pack_out, valid_n);
  return (int)cudaGetLastError();
}
