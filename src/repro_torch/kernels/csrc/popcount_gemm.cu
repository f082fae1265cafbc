// Fully-binary GEMM: uint32 words x [M, K32] times w [N, K32] ->
// the signed dot int32 [M, N] = 2*(pc(XNOR) - (32*K32 - k)) - k, or
// +-1 after dot >= T (T scalar or per-channel [N]), or, with pack_out,
// those decisions packed into uint32 words [M, ceil(N/32)] with every
// bit at a column >= valid_n zeroed.
//
// Replaces: src/repro/kernels/popcount_gemm.py::popcount_gemm
// (_kernel, _xnor_planes).  The TPU kernel carries Harley-Seal residues
// across sequential K grid steps in VMEM scratch; Hopper blocks run in
// no order, so here the whole K loop runs inside one block, split over
// its warps, and the parts meet in shared memory.
//
// The sum runs on the b1 tensor cores: mma.sync.m16n8k256 with
// .and.popc gives and = popc(x & w) over each MMA depth of 8 words.
// With pc_x and pc_w the popcounts of a row's and a column's words,
//     dot = k - 2*(pc_x + pc_w) + 4*and,
// which equals the closed form above whenever the pad bits of both
// operands are 0 (the contract that form assumes too): K zero-filled to
// whole stages, rows >= M and columns >= N add nothing.  Integer sums
// are exact in any order, so the result is bit for bit the plain
// version's.
//
// Bound on the H100: on the main paths (BinaryNet's fc3, AlexNet's fc8)
// the bytes (at most 1.7 MB) and the operations (2*M*N*K at the b1 rate,
// 8 x 1,979 TOP/s) both take well under a microsecond: the kernel is
// bound by latency, the first loads' round trip and the launch.  So the
// design spreads even a batch-1 call over the card and keeps each
// block's chain short:
//  - A block owns a BM x BN output tile (the wrapper's tile_plan picks
//    it) and WK warps split K between them: each takes one MMA depth of
//    every stage of 8*WK words, and the parts are added in shared memory
//    at the end.  Warps own 16 x 8*NF tiles (NF = 1 for the 8-column
//    tile, else 4: one output word), so M = 1 pays for 16 MMA rows, not
//    the 64 of the first port's CUDA-core tile.  AlexNet's fc8 at batch
//    1 (N = 1000) runs 125 blocks of 16 x 8 with K in 4 parts.
//  - Stages come through a ring of 4 in shared memory filled by
//    cp.async (16 bytes a copy where K32 % 4 == 0 and both operands are
//    16-byte aligned, else 4), rows of 8*WK + 4 words so that ldmatrix
//    (A) and the two 32-bit loads of a B fragment hit 32 banks.  Past
//    M, N or K the copy zero-fills (src-size 0) and reads nothing.
//  - pc_x and pc_w come from the fragments: of the warps that share a
//    row fragment, the first column warp counts it, and of those that
//    share a column fragment, the first row warp; the quad's counts meet
//    in shared memory by integer atomics.
//  - Epilogue as in packed_conv.cu: per column 2*pc_w, K and the
//    threshold fold into one number (in 64 bits, so any int32 threshold
//    compares exactly); with pack_out a warp's 32 columns are one output
//    word, ORed over the quad by two shuffles.
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): fc8 0.0026, 0.0033
// and 0.0050 ms at batches 1, 32 and 256, fc3 0.0019 ms at each (the
// first port's CUDA-core kernel: 12.8-14.4 and 4.3-4.7 us in a forward).
// At fc8's batch 256 the four tiles take 0.0050 to 0.0085 ms; wider or
// narrower tiles, K in 4 parts and a ring of 8 stages were no faster.
#include <climits>

#include "b1_mma.cuh"
#include "binary.cuh"

namespace {

constexpr int kStages = 4;
constexpr int kMmaWords = 8;           // K of one m16n8k256 MMA, in words

template <int BM, int BN, int WK>
struct Cfg {
  static constexpr int NF = BN >= 32 ? 4 : BN / 8;   // n8 fragments a warp
  static constexpr int WN = 8 * NF;                   // columns a warp
  static constexpr int kWarpsM = BM / 16, kWarpsN = BN / WN;
  static constexpr int kPlane = kWarpsM * kWarpsN;    // warps of one K part
  static constexpr int kThreads = 32 * kPlane * WK;
  static constexpr int kKS = kMmaWords * WK;          // words of K a stage
  static constexpr int kPitch = kKS + 4;              // words a row in smem
  static constexpr int kStageWords = (BM + BN) * kPitch;
  static constexpr int kRingWords = kStages * kStageWords;
  // the K parts after the first, each warp's fragments lane-fastest
  static constexpr int kRedWords = (WK - 1) * kPlane * NF * 4 * 32;
  static constexpr int kCountsAt =
      kRingWords > kRedWords ? kRingWords : kRedWords;
  static constexpr int kSmemWords = kCountsAt + BM + BN;
  static_assert(BM % 16 == 0 && BN % WN == 0, "tile layout");
};

using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::mma_b1;
using repro::smem_addr;

struct Geo {
  int m, n, k32, k, mode, thr, pack_out, valid_n;
};

// copy rows [r0, r0 + ROWS) of a [rows, k32] word matrix, words
// [kw0, kw0 + kKS) of each, into smem rows from dst on; V words a copy
template <int ROWS, int KS, int PITCH, int THREADS, int V>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const uint32_t* __restrict__ src,
                                          long long r0, long long rows,
                                          int k32, int kw0) {
  constexpr int kRowChunks = KS / V;
  constexpr int kChunks = ROWS * kRowChunks;
#pragma unroll
  for (int q = 0; q < (kChunks + THREADS - 1) / THREADS; ++q) {
    const int c = threadIdx.x + q * THREADS;
    if (kChunks % THREADS == 0 || c < kChunks) {
      const int row = c / kRowChunks, col = (c % kRowChunks) * V;
      const long long gr = r0 + row;
      const bool ok = gr < rows && kw0 + col < k32;
      cp_async<4 * V>(dst + 4 * (row * PITCH + col),
                      ok ? src + gr * k32 + kw0 + col : src, ok);
    }
  }
}

template <int BM, int BN, int WK, int V>
__global__ void __launch_bounds__(Cfg<BM, BN, WK>::kThreads)
popcount_gemm_kernel(const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ w,
                     const int32_t* __restrict__ tvec, void* out, Geo geo) {
  using C = Cfg<BM, BN, WK>;
  __shared__ __align__(16) uint32_t smem[C::kSmemWords];
  int* sx = reinterpret_cast<int*>(smem + C::kCountsAt);
  int* sw = sx + BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kk = warp / C::kPlane;       // this warp's depth in each stage
  const int pw = warp % C::kPlane;
  const int wr = pw / C::kWarpsN, wc = pw % C::kWarpsN;
  const int wm0 = wr * 16, wn0 = wc * C::WN;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int n_stages = (geo.k32 + C::kKS - 1) / C::kKS;

  for (int i = tid; i < BM + BN; i += C::kThreads) sx[i] = 0;

  const uint32_t s0 = smem_addr(smem);
  auto load = [&](int st) {
    const uint32_t base = s0 + 4 * (st % kStages) * C::kStageWords;
    load_rows<BM, C::kKS, C::kPitch, C::kThreads, V>(
        base, x, m0, geo.m, geo.k32, st * C::kKS);
    load_rows<BN, C::kKS, C::kPitch, C::kThreads, V>(
        base + 4 * BM * C::kPitch, w, n0, geo.n, geo.k32, st * C::kKS);
  };

  int acc[C::NF][4];
#pragma unroll
  for (int j = 0; j < C::NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  int cx[2] = {0, 0};        // pc_x partials: rows g, g + 8
  int cw[C::NF] = {};        // pc_w partials: column g of fragment j

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  // this lane's ldmatrix row: lanes 0-15 rows 0-15 at word 0, 16-31 word 4
  const uint32_t a_lane = 4 * ((wm0 + (lane & 15)) * C::kPitch +
                               (lane >> 4) * 4 + kk * kMmaWords);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // stage st landed; st - 1 is free
    if (st + kStages - 1 < n_stages) load(st + kStages - 1);
    cp_async_commit();
    if (st * C::kKS + kk * kMmaWords < geo.k32) {         // warp-uniform
      const uint32_t* ss = smem + (st % kStages) * C::kStageWords;
      uint32_t a[4];
      ldmatrix_x4(a, s0 + 4 * (st % kStages) * C::kStageWords + a_lane);
#pragma unroll
      for (int j = 0; j < C::NF; ++j) {
        const uint32_t* bp = ss + (BM + wn0 + j * 8 + g) * C::kPitch +
                             kk * kMmaWords + t;
        const uint32_t b0 = bp[0], b1 = bp[4];
        mma_b1(acc[j], a, b0, b1);
        if (wr == 0) cw[j] += __popc(b0) + __popc(b1);
      }
      // a0, a2 are row g's words t and t+4; a1, a3 row g+8's
      if (wc == 0) {
        cx[0] += __popc(a[0]) + __popc(a[2]);
        cx[1] += __popc(a[1]) + __popc(a[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the K parts

  // the quad's partial counts into shared memory
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int v = cx[h];
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, 1);
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, 2);
    if (wc == 0 && t == 0) atomicAdd(&sx[wm0 + g + 8 * h], v);
  }
#pragma unroll
  for (int j = 0; j < C::NF; ++j) {
    int v = cw[j];
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, 1);
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, 2);
    if (wr == 0 && t == 0) atomicAdd(&sw[wn0 + j * 8 + g], v);
  }
  int* red = reinterpret_cast<int*>(smem);
  if (WK > 1 && kk > 0) {
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((((kk - 1) * C::kPlane + pw) * C::NF + j) * 4 + e) * 32 + lane] =
            acc[j][e];
  }
  __syncthreads();
  if (kk > 0) return;
#pragma unroll
  for (int p = 1; p < WK; ++p)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] +=
            red[((((p - 1) * C::kPlane + pw) * C::NF + j) * 4 + e) * 32 + lane];

  // per column of this thread: 2*pc_w, and the threshold that 4*and -
  // 2*pc_x is held against (dot >= T  <=>  4*and - 2*pc_x >= T - K +
  // 2*pc_w), which never passes at a column >= N or, packed, >= valid_n
  const int nw = (geo.n + 31) / 32;
  int sw2[C::NF][2];
  long long tc[C::NF][2];
#pragma unroll
  for (int j = 0; j < C::NF; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cn = wn0 + j * 8 + 2 * t + e, col = n0 + cn;
      const bool in = col < geo.n && (!geo.pack_out || col < geo.valid_n);
      sw2[j][e] = 2 * sw[cn];
      const int thr = geo.mode == repro::kPerChannel ? (in ? tvec[col] : 0)
                                                      : geo.thr;
      tc[j][e] = in ? (long long)thr - geo.k + sw2[j][e] : LLONG_MAX;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm0 + g + 8 * h;
    const long long row = m0 + r;
    const int sx2 = 2 * sx[r];
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + wn0 + j * 8 + 2 * t + e;
        const int y = 4 * acc[j][2 * h + e] - sx2;
        if (geo.pack_out) {
          bits |= (uint32_t)(y >= tc[j][e]) << (j * 8 + 2 * t + e);
        } else if (row < geo.m && col < geo.n) {
          static_cast<int32_t*>(out)[row * geo.n + col] =
              geo.mode == repro::kNoThreshold ? geo.k + y - sw2[j][e]
                                              : (y >= tc[j][e] ? 1 : -1);
        }
      }
    if (geo.pack_out) {
      bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 1);
      bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 2);
      const int word = (n0 + wn0) / 32;
      if (t == 0 && row < geo.m && word < nw)
        static_cast<uint32_t*>(out)[row * nw + word] = bits;
    }
  }
}

struct Args {
  const uint32_t* x;
  const uint32_t* w;
  const int32_t* tvec;
  void* out;
  Geo geo;
  cudaStream_t stream;
};

template <int BM, int BN, int WK, int V>
int launch(const Args& a) {
  using C = Cfg<BM, BN, WK>;
  const long long grid_n = (a.geo.n + BN - 1) / BN;
  if (grid_n > 65535 || (a.geo.pack_out && C::WN != 32))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.geo.m + BM - 1) / BM), (unsigned)grid_n);
  popcount_gemm_kernel<BM, BN, WK, V><<<grid, C::kThreads, 0, a.stream>>>(
      a.x, a.w, a.tvec, a.out, a.geo);
  return (int)cudaGetLastError();
}

// the tiles (BM, BN, WK) of the wrapper's popcount_gemm.TILES
#define REPRO_GEMM_TILES(X) X(64, 64, 1) X(64, 32, 2) X(16, 32, 4) X(16, 8, 4)

template <int V>
int launch_tile(int bm, int bn, int wk, const Args& a) {
#define REPRO_GEMM_TILE(BM, BN, WK) \
  if (bm == BM && bn == BN && wk == WK) return launch<BM, BN, WK, V>(a);
  REPRO_GEMM_TILES(REPRO_GEMM_TILE)
#undef REPRO_GEMM_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// (bm, bn, wk) is the tile, from the wrapper's tile plan; pack_out needs
// a tile whose warps own 32 columns (bn >= 32).  16-byte copies where
// K32 % 4 == 0 and both operands are 16-byte aligned, else 4-byte.
extern "C" int popcount_gemm_launch(const uint32_t* x, const uint32_t* w,
                                    const int32_t* tvec, void* out, int m,
                                    int n, int k32, int k, int mode, int thr,
                                    int pack_out, int valid_n, int bm, int bn,
                                    int wk, cudaStream_t stream) {
  if (m == 0 || n == 0) return 0;
  const Args a{x, w, tvec, out,
               Geo{m, n, k32, k, mode, thr, pack_out, valid_n}, stream};
  const bool v4 = k32 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return v4 ? launch_tile<4>(bm, bn, wk, a) : launch_tile<1>(bm, bn, wk, a);
}
