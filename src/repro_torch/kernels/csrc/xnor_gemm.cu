// Binary-weight GEMM on the tensor cores: float32 or bf16 activations
// x [M, K] times packed weights w [K32, N] (uint32 words packed over K:
// bit b of word j is row 32*j + b, a 0 bit is -1), float32 accumulation
// over all of K, then y = acc * alpha[N] once.  Outputs: y in x's dtype
// (bf16 rounded to nearest even); +-1 in x's dtype after y >= T (T a
// float scalar or a float32 [N] vector); or, with pack_out, those
// decisions packed into uint32 words [M, ceil(N/32)] with every bit at a
// column >= valid_n zeroed.
//
// Replaces: src/repro/kernels/xnor_gemm.py::xnor_gemm (_kernel).  The
// TPU kernel unpacks each [bk/32, bn] weight tile to +-1 bf16 in VMEM
// and feeds the MXU, carrying the float32 sum across sequential K grid
// steps in VMEM scratch.  Hopper blocks run in no order: a block runs
// its whole part of K in order and keeps the sum in registers.  Where
// the wrapper splits K into parts (gridDim.z > 1, to fill the 132 SMs),
// each part's float32 sums go to scratch and a second kernel adds them
// in part order; no atomics, so a result does not change from run to
// run.
//
// Bound on the H100: bytes at decode widths (M = 1 reads 8.4 MB of
// packed weights for 8192 x 8192), operations at M = 128 (2*M*K*N at the
// bf16 tensor-core rate; three times that for float32 x, see below).
// In practice mma.sync on this card tops out near two thirds of the
// dense bf16 rate, and building B costs about 2.75 instructions per MMA
// at a 32-row warp tile: the kernel is issue-bound.
//
// Design.  Every multiply-accumulate is a bf16 mma.sync.m16n8k16 with a
// float32 accumulator.  A block owns a BM x BN output tile (BM 16 or 64,
// BN 64 or 128; the wrapper's tile_plan picks the tile and the split of
// K) and walks its part of K in stages of BK.  Its 8 or 16 warps are KG
// groups over K (group g takes words g, g + KG, ... of each stage) times
// a grid of warp tiles over the output tile.
//  - x: cp.async copies 16 bytes a thread into a ring of kStages
//    shared-memory stages; each thread's pointers are worked out once
//    (Loader).  Rows >= M are never copied (M = 1 moves one row, not
//    16): whatever they hold reaches only output rows >= M, which are
//    never stored.  K past the part is zero-filled.  bf16 rows are
//    padded by 16 bytes so that ldmatrix reads them without bank
//    conflicts.  float32 x is split once per stage, by the thread that
//    copied it, into three bf16 planes, x = hi + mid + lo, by truncation:
//    hi = the top 16 bits of x, r = x - hi (exact), mid = the top 16 bits
//    of r, lo = r - mid (exact).  For |x| >= 2^-100 each piece is an
//    exact bf16 with the sign of x, so the three products with +-1 are
//    exact and the only difference from the float32 oracle is the order
//    of the float32 sum.  inf and NaN go whole into hi (mid = lo = 0) and
//    propagate as in the oracle.
//  - weights: the [BK/32, BN] words of a stage are copied into shared
//    memory as they are, 4 bytes a copy (columns >= N read as word 0 and
//    are never stored), and never unpacked there: each lane builds its m16n8k16 B
//    fragments in registers.  Lane (g = lane/4, t = lane%4) holds column
//    g at rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of a 16-deep chunk,
//    i.e. bits q, q+1 of the column's word with q = 2t, 2t+8, 2t+16,
//    2t+24 for the word's four 8-row quarters.  Shifting the word left
//    by 7-2t and by 6-2t puts those bits at the top of each byte; one
//    prmt per quarter moves the pair to bits 15 and 31, and one lop3,
//    (v & 0x80008000) ^ 0xBF80BF80, makes the bf16x2 (+1 = 0x3F80, -1 =
//    0xBF80): 11 instructions per word and warp column, reused by all
//    WM/16 row fragments of the warp (and the three planes of float32 x).
//  - the sum: a stage's MMAs accumulate into zeroed fragments d, one MMA
//    for every (row, column) fragment in turn, and d is added to the
//    running float32 sum once per stage with an ordinary (round-to-
//    nearest) add.  The tensor core's float32 accumulation truncates;
//    chained over all of K (768 MMAs per output for float32 x at K =
//    4096) its bias grew past 1e-5 * max|y|.
//  - epilogue, after the K loop: every K group writes its sums to shared
//    memory, and they are added in group order (a fixed order); then y =
//    sum * alpha[col], stored coalesced (float or +-1), or, for pack_out,
//    one warp per (row, 32 columns) forms each word with __ballot_sync
//    (repro::pack_warp).  With K split, the raw sums go to scratch and
//    xnor_gemm_kernel_reduce does the same after adding the parts.
#include <cuda_bf16.h>

#include "binary.cuh"

namespace {

enum XType { kF32 = 0, kBF16 = 1 };

// the output tiles and their warps: warp tile WM x WN and KG groups of
// warps over K (each takes every KG-th word of a stage)
template <int BM, int BN> struct Tile;
template <> struct Tile<16, 64> {
  static constexpr int WM = 16, WN = 16, KG = 4; };
template <> struct Tile<16, 128> {
  static constexpr int WM = 16, WN = 32, KG = 2; };
template <> struct Tile<64, 64> {
  static constexpr int WM = 32, WN = 32, KG = 2; };
template <> struct Tile<64, 128> {
  static constexpr int WM = 32, WN = 32, KG = 1; };

template <int BM, int BN, int XT>
struct Cfg {
  using T = Tile<BM, BN>;
  static constexpr int WM = T::WM, WN = T::WN, KG = T::KG;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kTileWarps = (BM / WM) * kWarpsN;
  static constexpr int kWarps = KG * kTileWarps;
  static constexpr int kThreads = 32 * kWarps;
  // fragments of a warp tile: m16 rows and n8 columns of the output
  static constexpr int MF = WM / 16;
  static constexpr int NF = WN / 8;
  static constexpr int kPlanes = XT == kF32 ? 3 : 1;
  // words of K per stage: deep for the decode tile (bytes in flight);
  // float32 stages hold 4-byte x and its three planes
  static constexpr int kWordsK = BM == 16 ? 16 : (XT == kF32 ? 2 : 4);
  static constexpr int BK = 32 * kWordsK;
  static constexpr int FG = kWordsK / KG;               // words per K group
  static constexpr int kStages = BM == 16 ? (XT == kF32 ? 4 : 6) : 4;
  static constexpr int kLd = BK + 8;                    // bf16 row pitch
  static constexpr int kElem = XT == kF32 ? 4 : 2;      // bytes of x
  static constexpr int kChunkElems = 16 / kElem;
  static constexpr int kAChunks = BM * BK / kChunkElems;
  static constexpr int kABytes = XT == kF32 ? BM * BK * 4 : BM * kLd * 2;
  static constexpr int kBWords = kWordsK * BN;
  static constexpr int kStageBytes = kABytes + kBWords * 4;
  static constexpr int kPlaneBytes = BM * kLd * 2;
  static constexpr int kMainBytes =
      kStages * kStageBytes + (XT == kF32 ? 3 * kPlaneBytes : 0);
  static constexpr int kRedLd = BN + 8;                 // float row pitch
  static constexpr int kRedBytes = KG * BM * kRedLd * 4;
  static constexpr int kSmem = kMainBytes > kRedBytes ? kMainBytes
                                                      : kRedBytes;
  static_assert(kAChunks % kThreads == 0, "x chunks per thread");
  static_assert(kWordsK % KG == 0, "words per K group");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// when guard: copy `bytes` (16, or 0 for zeros) and zero the rest of the
// 16; nothing at all when !guard.  Predicated, so no branch.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes, bool guard) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"((int)guard)
      : "memory");
}

// 4 bytes (or zeros when bytes is 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four bf16x2 B registers of one word for lane quarter t: reg q
// holds the +-1 of bits 8q + 2t (low half) and 8q + 2t + 1 (high half);
// q = 0, 1 are b0, b1 of the word's first 16-deep chunk, q = 2, 3 of its
// second
template <int Q>
__device__ __forceinline__ uint32_t pm1_quarter(uint32_t even,
                                                uint32_t odd) {
  uint32_t v, r;
  asm("prmt.b32 %0, %1, %2, %3;\n"
      : "=r"(v)
      : "r"(even), "r"(odd), "n"(((4 + Q) << 12) | (Q << 4)));
  // (v & 0x80008000) ^ 0xBF80BF80 in one lop3 (C++ gives two)
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(r)
      : "r"(v), "r"(0x80008000u), "r"(0xBF80BF80u));
  return r;
}

// x = hi + mid + lo, three bf16 bit patterns (see the header)
__device__ __forceinline__ void split3(float x, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  const uint32_t b = __float_as_uint(x);
  if ((b & 0x7f800000u) == 0x7f800000u) {         // inf or NaN: hi = x
    h = (b & 0x007fffffu) ? ((b >> 16) | 0x40u) : (b >> 16);
    m = l = 0u;
    return;
  }
  const float r = x - __uint_as_float(b & 0xffff0000u);
  const uint32_t rb = __float_as_uint(r) & 0xffff0000u;
  const float lo = r - __uint_as_float(rb);
  h = b >> 16;
  m = rb >> 16;
  l = __float_as_uint(lo) >> 16;
}

// One thread's share of the copies of a stage, with its pointers and
// shared-memory offsets worked out once: chunk q of x is row r0 + q *
// kRowStep at element ke of the stage's K; word q of the weights is word
// row jj0 + q * kWRowStep of the stage at column col.  Per stage only the
// K offset moves.  Words [j_begin, j_end) are the block's part of K; x
// is zero past it.
template <int BM, int BN, int XT>
struct Loader {
  using C = Cfg<BM, BN, XT>;
  static constexpr int kRowChunks = C::BK / C::kChunkElems;
  static constexpr int kRowStep = C::kThreads / kRowChunks;
  static constexpr int kAPer = C::kAChunks / C::kThreads;
  static constexpr int kRowBytes = XT == kF32 ? C::BK * 4 : C::kLd * 2;
  static constexpr int kWRowStep = C::kThreads / BN;
  static constexpr int kWPer = (C::kBWords + C::kThreads - 1) / C::kThreads;
  static_assert(C::kThreads % kRowChunks == 0 && C::kThreads % BN == 0,
                "copy layout");

  const char* x;
  const char* xa;           // chunk 0 at the part's first word
  long long x_step;         // bytes from chunk q to q + 1
  int a_valid;              // chunks q < a_valid are rows < M
  int ke;                   // element of the stage's K
  uint32_t a_off;           // chunk 0's offset in a stage
  const uint32_t* w;
  const uint32_t* wa;       // word 0 at the part's first word
  int jj0;                  // word row of word 0 within a stage
  bool col_ok;              // its column < N
  uint32_t w_off;           // word 0's offset in a stage
  int k_len, j_len;         // elements and words of the part

  __device__ Loader(const char* x_, const uint32_t* w_, int m, int n,
                    int k32, long long m0, int n0, int j_begin, int j_end)
      : x(x_), w(w_) {
    const int tid = threadIdx.x;
    const int k = 32 * k32;
    const int r0 = tid / kRowChunks;
    ke = (tid % kRowChunks) * C::kChunkElems;
    const long long rows_left = m - m0 - r0;     // rows r0, r0 + step, ...
    const long long chunks = (rows_left + kRowStep - 1) / kRowStep;
    a_valid = rows_left <= 0 ? 0 : (chunks < kAPer ? (int)chunks : kAPer);
    const long long r_in = r0 < m - 1 - m0 ? r0 : m - 1 - m0;   // in bounds
    xa = x + ((m0 + r_in) * k + 32LL * j_begin + ke) * C::kElem;
    x_step = (long long)kRowStep * k * C::kElem;
    a_off = r0 * kRowBytes + ke * (XT == kF32 ? 4 : 2);
    const int col = tid % BN;
    jj0 = tid / BN;
    col_ok = n0 + col < n;
    wa = w + (long long)(j_begin + jj0) * n + n0 + (col_ok ? col : 0);
    w_off = C::kABytes + (jj0 * BN + col) * 4;
    k_len = 32 * (j_end - j_begin);
    j_len = j_end - j_begin;
  }

  __device__ __forceinline__ void load(uint32_t stage, int kt, int n) const {
    const int k_left = k_len - kt * C::BK;        // elements of x left
    const char* xs = xa + (long long)kt * C::BK * C::kElem;
    const bool k_ok = ke < k_left;
#pragma unroll
    for (int q = 0; q < kAPer; ++q)
      cp_async16(stage + a_off + q * kRowStep * kRowBytes,
                 k_ok ? xs + q * x_step : x, k_ok ? 16 : 0, q < a_valid);
    const int j_left = j_len - kt * C::kWordsK;     // words left
    const uint32_t* ws = wa + (long long)kt * C::kWordsK * n;
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int jj = jj0 + q * kWRowStep;
      if (C::kBWords % C::kThreads != 0 && jj >= C::kWordsK) break;
      const bool ok = col_ok && jj < j_left;
      cp_async4(stage + w_off + q * kWRowStep * BN * 4,
                ok ? ws + (long long)q * kWRowStep * n : w, ok ? 4 : 0);
    }
  }
};

// float32 x: this thread's own chunks of a landed stage into the planes
template <int BM, int BN>
__device__ __forceinline__ void split_stage(const Loader<BM, BN, kF32>& ld,
                                            const char* stage,
                                            __nv_bfloat16* planes) {
  using C = Cfg<BM, BN, kF32>;
  using L = Loader<BM, BN, kF32>;
#pragma unroll
  for (int q = 0; q < L::kAPer; ++q) {
    if (q >= ld.a_valid) break;         // rows >= M: never read for y
    const float4 v = *reinterpret_cast<const float4*>(
        stage + ld.a_off + q * L::kRowStep * L::kRowBytes);
    uint32_t h[4], md[4], l[4];
    split3(v.x, h[0], md[0], l[0]);
    split3(v.y, h[1], md[1], l[1]);
    split3(v.z, h[2], md[2], l[2]);
    split3(v.w, h[3], md[3], l[3]);
    const int off = (ld.a_off / (C::BK * 4) + q * L::kRowStep) * C::kLd +
                    ld.ke;
    *reinterpret_cast<uint2*>(planes + off) =
        make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    *reinterpret_cast<uint2*>(planes + BM * C::kLd + off) =
        make_uint2(md[0] | (md[1] << 16), md[2] | (md[3] << 16));
    *reinterpret_cast<uint2*>(planes + 2 * BM * C::kLd + off) =
        make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
  }
}

template <int BM, int BN, int XT>
__global__ void __launch_bounds__(Cfg<BM, BN, XT>::kThreads)
xnor_gemm_kernel(const char* __restrict__ x, const uint32_t* __restrict__ w,
                 const float* __restrict__ alpha,
                 const float* __restrict__ tvec, void* out,
                 float* __restrict__ partial, int m, int n, int k32,
                 int mode, float thr, int pack_out, int valid_n) {
  // gridDim.z > 1: block z sums its share of K into partial[z] [M, N]
  // (no alpha), and xnor_gemm_kernel_reduce finishes
  using C = Cfg<BM, BN, XT>;
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / C::kTileWarps;            // this warp's K group
  const int tw = warp % C::kTileWarps;
  const int wm0 = (tw / C::kWarpsN) * C::WM;
  const int wn0 = (tw % C::kWarpsN) * C::WN;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split_words = (k32 + gridDim.z - 1) / gridDim.z;
  const int j_begin = min(k32, (int)blockIdx.z * split_words);
  const int j_end = min(k32, j_begin + split_words);
  const int n_tiles = (j_end - j_begin + C::kWordsK - 1) / C::kWordsK;
  __nv_bfloat16* planes =
      reinterpret_cast<__nv_bfloat16*>(smem + C::kStages * C::kStageBytes);

  float acc[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const Loader<BM, BN, XT> ld(x, w, m, n, k32, m0, n0, j_begin, j_end);
  const uint32_t smem0 = smem_addr(smem);
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_tiles) ld.load(smem0 + s * C::kStageBytes, s, n);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<C::kStages - 2>();    // this thread's copies of kt landed
    __syncthreads();                    // everyone's; stage kt-1 is free
    const int nxt = kt + C::kStages - 1;
    if (nxt < n_tiles)
      ld.load(smem0 + (nxt % C::kStages) * C::kStageBytes, nxt, n);
    cp_async_commit();
    const char* stage = smem + (kt % C::kStages) * C::kStageBytes;
    const __nv_bfloat16* a_base;
    if constexpr (XT == kF32) {
      split_stage<BM, BN>(ld, stage, planes);
      __syncthreads();
      a_base = planes;
    } else {
      a_base = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    const uint32_t* ws =
        reinterpret_cast<const uint32_t*>(stage + C::kABytes);
    // this K group's words of the stage: words kg, kg + KG, ...  Their
    // products sum in fresh fragments d, one MMA for every (row, column)
    // fragment in turn (independent, so they issue back to back), and d
    // is added to the running sum once per stage
    float d[C::MF][C::NF][4];
#pragma unroll
    for (int i = 0; i < C::MF; ++i)
#pragma unroll
      for (int j = 0; j < C::NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
    // this lane's ldmatrix row: lanes 0-15 rows 0-15 at k 0, 16-31 k 8
    const __nv_bfloat16* a_lane =
        a_base + (wm0 + (lane & 15)) * C::kLd + (lane >> 4) * 8;
#pragma unroll
    for (int f = 0; f < C::FG; ++f) {
      const int kw = f * C::KG + kg;
      // B fragments of the word, built from the bits
      uint32_t b[4][C::NF];
#pragma unroll
      for (int j = 0; j < C::NF; ++j) {
        const uint32_t word = ws[kw * BN + wn0 + j * 8 + g];
        const uint32_t even = word << (7 - 2 * t);
        const uint32_t odd = word << (6 - 2 * t);
        b[0][j] = pm1_quarter<0>(even, odd);
        b[1][j] = pm1_quarter<1>(even, odd);
        b[2][j] = pm1_quarter<2>(even, odd);
        b[3][j] = pm1_quarter<3>(even, odd);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int p = 0; p < C::kPlanes; ++p) {
          uint32_t a[C::MF][4];
#pragma unroll
          for (int i = 0; i < C::MF; ++i)
            ldmatrix_x4(a[i], a_lane + p * BM * C::kLd + i * 16 * C::kLd +
                                  kw * 32 + c * 16);
#pragma unroll
          for (int i = 0; i < C::MF; ++i)
#pragma unroll
            for (int j = 0; j < C::NF; ++j)
              mma_bf16(d[i][j], a[i], b[2 * c][j], b[2 * c + 1][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < C::MF; ++i)
#pragma unroll
      for (int j = 0; j < C::NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();                      // the stages may now be reused

  // each K group's sums into shared memory, [KG][BM][BN + 8] floats
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // rows g, g + 8; columns 2t, +1
        const int r = wm0 + i * 16 + g + 8 * h;
        const int cn = wn0 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(red + (kg * BM + r) * C::kRedLd + cn) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();

  // the sum over the K groups, in group order
  auto sum_at = [&](int r, int cn) {
    float y = red[r * C::kRedLd + cn];
#pragma unroll
    for (int q = 1; q < C::KG; ++q) y += red[(q * BM + r) * C::kRedLd + cn];
    return y;
  };
  if (gridDim.z > 1) {
    float* part = partial + (long long)blockIdx.z * m * n;
    for (int p = threadIdx.x; p < BM * BN; p += C::kThreads) {
      const int r = p / BN, cn = p % BN;
      const long long gr = m0 + r;
      if (gr < m && n0 + cn < n) part[gr * n + n0 + cn] = sum_at(r, cn);
    }
    return;
  }
  auto y_at = [&](int r, int cn, int col) {
    return sum_at(r, cn) * alpha[col];
  };
  auto t_at = [&](int col) {
    return mode == repro::kPerChannel ? tvec[col] : thr;
  };
  if (pack_out) {
    const int nw = (n + 31) / 32;
    for (int p = warp; p < BM * (BN / 32); p += C::kWarps) {   // uniform
      const int r = p / (BN / 32), cn = (p % (BN / 32)) * 32 + lane;
      const int col = n0 + cn;
      const long long gr = m0 + r;
      const bool bit = gr < m && col < n && y_at(r, cn, col) >= t_at(col);
      const uint32_t word = repro::pack_warp(bit, col, valid_n);
      const int gw = (n0 + cn - lane) / 32;
      if (lane == 0 && gr < m && gw < nw)
        static_cast<uint32_t*>(out)[gr * nw + gw] = word;
    }
    return;
  }
  for (int p = threadIdx.x; p < BM * BN; p += C::kThreads) {
    const int r = p / BN, cn = p % BN;
    const int col = n0 + cn;
    const long long gr = m0 + r;
    if (gr >= m || col >= n) continue;
    const float y = y_at(r, cn, col);
    const float v =
        mode == repro::kNoThreshold ? y : (y >= t_at(col) ? 1.f : -1.f);
    if (XT == kF32)
      static_cast<float*>(out)[gr * n + col] = v;
    else
      static_cast<__nv_bfloat16*>(out)[gr * n + col] = __float2bfloat16_rn(v);
  }
}

// the second pass of a split K: y = (partial[0] + ... + partial[S-1],
// in that order) * alpha, then the output mode; one warp per row and 32
// columns
template <int XT>
__global__ void __launch_bounds__(256)
xnor_gemm_kernel_reduce(const float* __restrict__ partial,
                        const float* __restrict__ alpha,
                        const float* __restrict__ tvec, void* out, int m,
                        int n, int splits, int mode, float thr, int pack_out,
                        int valid_n) {
  const int lane = threadIdx.x & 31;
  const int nw = (n + 31) / 32;
  const long long item = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (item >= (long long)m * nw) return;              // warp-uniform
  const long long gr = item / nw;
  const int col = (int)(item % nw) * 32 + lane;
  const bool in = col < n;
  float y = 0.f;
  if (in) {
    y = partial[gr * n + col];
    for (int z = 1; z < splits; ++z)
      y += partial[((long long)z * m + gr) * n + col];
    y *= alpha[col];
  }
  const float t = mode == repro::kPerChannel ? (in ? tvec[col] : 0.f) : thr;
  if (pack_out) {
    const uint32_t word = repro::pack_warp(in && y >= t, col, valid_n);
    if (lane == 0) static_cast<uint32_t*>(out)[gr * nw + col / 32] = word;
  } else if (in) {
    const float v = mode == repro::kNoThreshold ? y : (y >= t ? 1.f : -1.f);
    if (XT == kF32)
      static_cast<float*>(out)[gr * n + col] = v;
    else
      static_cast<__nv_bfloat16*>(out)[gr * n + col] = __float2bfloat16_rn(v);
  }
}

struct Args {
  const void* x;
  const uint32_t* w;
  const float* alpha;
  const float* tvec;
  void* out;
  float* partial;
  int m, n, k32, mode;
  float thr;
  int pack_out, valid_n, splits;
  cudaStream_t stream;
};

template <int BM, int BN, int XT>
int launch(const Args& a) {
  using C = Cfg<BM, BN, XT>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // variant and device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(xnor_gemm_kernel<BM, BN, XT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  const dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN, a.splits);
  xnor_gemm_kernel<BM, BN, XT><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      static_cast<const char*>(a.x), a.w, a.alpha, a.tvec, a.out, a.partial,
      a.m, a.n, a.k32, a.mode, a.thr, a.pack_out, a.valid_n);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const long long items = (long long)a.m * ((a.n + 31) / 32);
  xnor_gemm_kernel_reduce<XT><<<(unsigned)((items + 7) / 8), 256, 0,
                                 a.stream>>>(
      a.partial, a.alpha, a.tvec, a.out, a.m, a.n, a.splits, a.mode, a.thr,
      a.pack_out, a.valid_n);
  return (int)cudaGetLastError();
}

#define REPRO_XNOR_TILES(X) X(16, 64) X(16, 128) X(64, 64) X(64, 128)

template <int XT>
int launch_tile(int bm, int bn, const Args& a) {
#define REPRO_XNOR_TILE(BM, BN) \
  if (bm == BM && bn == BN) return launch<BM, BN, XT>(a);
  REPRO_XNOR_TILES(REPRO_XNOR_TILE)
#undef REPRO_XNOR_TILE
  return (int)cudaErrorInvalidValue;
}

template <int XT>
int smem_of(int bm, int bn) {
#define REPRO_XNOR_SMEM(BM, BN) \
  if (bm == BM && bn == BN) return Cfg<BM, BN, XT>::kSmem;
  REPRO_XNOR_TILES(REPRO_XNOR_SMEM)
#undef REPRO_XNOR_SMEM
  return -1;
}

}  // namespace

// x_dtype: 0 float32, 1 bfloat16.  x must be 16-byte aligned (the
// wrapper guarantees it); K = 32 * k32 and x is zero beyond the valid K.
// (bm, bn) is the output tile and splits the number of parts of K, from
// the wrapper's tile plan: bm in {16, 64}, bn in {64, 128};
// splits > 1 needs partial, splits * M * N float32 of scratch.
extern "C" int xnor_gemm_launch(const void* x, int x_dtype,
                                const uint32_t* w, const float* alpha,
                                const float* tvec, void* out, int m, int n,
                                int k32, int mode, float thr, int pack_out,
                                int valid_n, int bm, int bn, int splits,
                                float* partial, cudaStream_t stream) {
  if (m == 0 || n == 0) return 0;
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, alpha, tvec, out, partial, m, n, k32, mode, thr,
               pack_out, valid_n, splits, stream};
  if (x_dtype == kF32) return launch_tile<kF32>(bm, bn, a);
  if (x_dtype == kBF16) return launch_tile<kBF16>(bm, bn, a);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block of the (bm, bn, x_dtype) variant,
// bytes; -1 for a variant that does not exist
extern "C" int xnor_gemm_smem_bytes(int bm, int bn, int x_dtype) {
  return x_dtype == kF32 ? smem_of<kF32>(bm, bn) : smem_of<kBF16>(bm, bn);
}
