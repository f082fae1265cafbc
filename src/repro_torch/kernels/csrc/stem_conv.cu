// The real-valued stems of the residual binary networks, two kernels:
//  - stem_conv_bn_sign_kernel (ReActNet): a 3x3 conv of float NHWC x
//    over 3 channels with float weights [3, 3, 3, F] and a zero pad,
//    then the batch norm ((acc - mean) * inv) * gamma + beta; writes the
//    float map and the packed signs (v + b_next) > 0 of the next
//    learned-threshold sign (RSign);
//  - stem_conv_pool_kernel (Bi-Real Net, below the first): a 7x7
//    stride-2 conv over 3 channels, the same batch norm, then a 3x3
//    stride-2 max pool whose pad is -inf; writes the pooled map and its
//    signs.
// Table [5, F]: mean, inv, gamma, beta, b_next.
//
// Replaces no pallas_call: the residual family is port-only (the JAX
// package has none), so there is no TPU kernel behind either.
//
// Arithmetic (ROADMAP hazard 2b): every output sums its 27 taps in the
// order (kh, kw, c) from 0, each product and each sum rounded on its own
// (__fmul_rn / __fadd_rn, never an FMA), and the batch norm and the
// next sign are stem_bn below, so the map and the words equal
// stem_conv_plain's bit for bit.  The order is part of the model's
// stated precision: a float32 stem in another order, or with FMAs,
// fails the benchmark's check.
//
// Bounds on the H100, at ReActNet-A's stem (224x224x3 -> 112x112x32,
// stride 2): bytes, 2.26 MB an image (the 0.60 MB image in, the 1.61 MB
// float map and 0.05 MB of words out), 0.1726 ms a forward of 256 rows
// at 3.35 TB/s; operations, 27 products and 27 sums unfused an output,
// 5.55 G a forward of 256 rows, 0.166 ms at 33.5 T non-FMA float32
// operations/s (132 SMs x 128 lanes x 1.98 GHz).  The two are about
// equal, so the design spends its instructions on the products and sums
// and keeps the loads few:
//  - A block owns a tile of output pixels (`rows` x `cols`, from the
//    wrapper's plan, stem_plan) and a slab of 32, 64 or 128 channels.
//    It stages the tile's input rows in shared memory once, as three
//    copies shifted by the tap column kw ([row][kw][pos][c], pos the
//    output column): the taps of kPix neighbouring outputs at one
//    (kh, kw) are then 3 * kPix consecutive floats at an aligned address
//    whatever the stride, three 16-byte loads.  The copies are 4-byte
//    cp.async, zero-filled outside the image (the zero pad comes from the
//    staging, no tap is tested): a 16-byte copy cannot both read a row
//    at its 12-byte pixel offset and land it aligned for the 16-byte tap
//    loads (and an odd width puts a row off 16 bytes in device memory).
//    Blocks are persistent and double-buffered: the next tile's copy is
//    in flight while this one is summed.  Two blocks of 4 warps an SM
//    (the weights take the registers, 228 a thread), not one of 8, so
//    that one block's copies and stores overlap the other's sums.
//  - A thread owns kPix = 4 neighbouring pixels of a row and kCh = 4
//    channels: its 27 x 4 weights sit in registers, each tap it loads
//    serves 4 outputs' sums, each weight 4 pixels', and its 16 outputs
//    keep 16 independent accumulator chains that overlap (27 16-byte
//    loads for 16 outputs, against 27 scalar loads an output before).
//  - Epilogue: each thread stores a pixel's 4 channels as one 16-byte
//    store (8 threads cover one 32-channel word of a pixel, so a warp's
//    stores fill whole 128-byte lines); the next sign's nibbles are
//    ORed into the word by three shuffles across those 8 threads.
// Measured (H100 80GB HBM3 at 700 W, ReActNet-A's stem at 256 rows,
// tiles of 4 x 112 outputs): 0.36 ms, against 1.37 ms for the kernel it
// replaced (a warp a pixel, 27 bounds-tested scalar loads a lane, one
// serial chain).  Tried on the way, all slower (0.40-0.54 ms): one block
// of 8 or 12 warps, four of 2; tiles of 2, 5, 6 or 8 rows; 2 channels a
// thread; the weights in shared memory (3 blocks an SM); staging by
// consecutive floats, or by (r, kw, pos) triples in turn; streaming
// stores.
// Offsets into x, out and bits are 64-bit; the wrapper checks that
// element counts stay below 2^31.
#include <cmath>

#include "b1_mma.cuh"
#include "binary.cuh"

namespace {

using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_addr;

constexpr int kThreads = 128;    // a block
constexpr int kBlocks = 2;       // blocks an SM
constexpr int kPix = 4;          // neighbouring pixels of a row a thread
constexpr int kCh = 4;           // channels a thread
constexpr int kTaps = 27;        // 3 x 3 x 3, summed in this order

struct StemGeo {
  int h, w, f, stride, pad, ho, wo;
  int slab;      // channels a block owns: 128, 64 or 32 (dividing F)
  int lanes;     // threads of a pixel group: slab / kCh
  int groups;    // pixel groups of one pass of the block's threads
  int rows, cols;       // the tile of output pixels (cols % kPix == 0)
  int gcols;            // pixel groups along a tile row: cols / kPix
  int prow;             // staged input rows: (rows - 1) * stride + 3
  int passes;           // of the block's threads over a tile
  int patch;            // floats of one staged tile: prow * 9 * cols
  int tiles_y, tiles_x, tiles;
  int smem;             // two staged tiles, bytes
};

struct Tile {
  int img, oy0, ox0;
};

__device__ __forceinline__ Tile tile_at(const StemGeo& g, int tl) {
  const int per_img = g.tiles_y * g.tiles_x;
  const int img = tl / per_img, rem = tl - img * per_img;
  const int ty = rem / g.tiles_x;
  return Tile{img, ty * g.rows, (rem - ty * g.tiles_x) * g.cols};
}

// the stem's batch norm: ((acc - mean) * inv) * gamma + beta
__device__ __forceinline__ float stem_bn(float acc, float mean, float inv,
                                         float gamma, float beta) {
  const float v = __fmul_rn(__fsub_rn(acc, mean), inv);
  return __fadd_rn(__fmul_rn(v, gamma), beta);
}

__global__ void __launch_bounds__(kThreads, kBlocks)
stem_conv_bn_sign_kernel(const float* __restrict__ x,
                         const float* __restrict__ wt,
                         const float* __restrict__ table,
                         float* __restrict__ out,
                         uint32_t* __restrict__ bits, StemGeo g) {
  extern __shared__ __align__(16) float xs[];   // 2 x [prow][3][cols][3]
  const int tid = threadIdx.x;
  const int q = tid % g.lanes, grp = tid / g.lanes;
  const int ch = blockIdx.y * g.slab + kCh * q;   // first of 4 channels
  int tile = blockIdx.x;
  if (tile >= g.tiles) return;

  // tile `tl`'s input rows into buffer `buf`, once for each kw: element
  // (r, kw, pos, c) is x[iy0 + r][(ox0 + pos) * stride + kw - pad][c],
  // zero outside the image
  auto stage = [&](int tl, int buf) {
    const Tile t = tile_at(g, tl);
    const int iy0 = t.oy0 * g.stride - g.pad;
    const float* xi = x + (size_t)t.img * g.h * g.w * 3;
    const uint32_t dst0 = smem_addr(xs + buf * g.patch);
    const int step = 4 * 9 * g.cols;              // bytes of a staged row
    for (int e = tid; e < 3 * g.cols; e += kThreads) {
      const int kw = e / g.cols, pos = e - kw * g.cols;
      const int ix = (t.ox0 + pos) * g.stride + kw - g.pad;
      const bool col_ok = ix >= 0 && ix < g.w;
      const float* src_col = xi + (size_t)(col_ok ? ix : 0) * 3;
      uint32_t dst = dst0 + 4 * 3 * e;
      for (int r = 0; r < g.prow; ++r, dst += step) {
        const int iy = iy0 + r;
        const bool ok = col_ok && iy >= 0 && iy < g.h;
        const float* src = ok ? src_col + (size_t)iy * g.w * 3 : x;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          cp_async<4>(dst + 4 * c, src + (ok ? c : 0), ok);
      }
    }
  };

  // the thread's weights: tap t, channel ch + k
  float wr[kTaps][kCh];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(wt + (size_t)t * g.f + ch));
    wr[t][0] = v.x; wr[t][1] = v.y; wr[t][2] = v.z; wr[t][3] = v.w;
  }
  const float4* tb = reinterpret_cast<const float4*>(table + ch);
  const int t4 = g.f / 4;                         // a table row in float4s
  const int fw = g.f / 32;
  const int shift = kCh * (q & 7);                // the nibble's place

  stage(tile, 0);
  cp_async_commit();
  for (int i = 0; tile < g.tiles; ++i) {
    const int next = tile + gridDim.x;
    if (next < g.tiles) stage(next, (i + 1) & 1);
    cp_async_commit();           // an empty group where there is no next
    cp_async_wait<1>();          // this tile's rows have landed
    __syncthreads();

    const Tile t = tile_at(g, tile);
    const float* patch = xs + (i & 1) * g.patch;
#pragma unroll 1
    for (int pass = 0; pass < g.passes; ++pass) {
      const int pg = pass * g.groups + grp;
      const bool live = pg < g.rows * g.gcols;
      const int pgc = live ? pg : 0;   // a spare thread sums a real group
      const int ry = pgc / g.gcols, gx = pgc - ry * g.gcols;
      const float* xt = patch + ry * g.stride * 9 * g.cols + 3 * kPix * gx;
      float acc[kPix][kCh];
#pragma unroll
      for (int j = 0; j < kPix; ++j)
#pragma unroll
        for (int k = 0; k < kCh; ++k) acc[j][k] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 9; ++kk) {            // (kh, kw)
        const int kh = kk / 3, kw = kk % 3;
        const float4* p4 = reinterpret_cast<const float4*>(
            xt + (kh * 3 + kw) * 3 * g.cols);
        const float4 a = p4[0], b = p4[1], c4 = p4[2];
        // pixel j's channel c: xv[3 * j + c]
        const float xv[3 * kPix] = {a.x,  a.y,  a.z,  a.w,  b.x,  b.y,
                                    b.z,  b.w,  c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int j = 0; j < kPix; ++j)
#pragma unroll
            for (int k = 0; k < kCh; ++k)
              acc[j][k] = __fadd_rn(
                  acc[j][k], __fmul_rn(xv[3 * j + c], wr[3 * kk + c][k]));
      }

      const float4 mean = __ldg(tb), inv = __ldg(tb + t4),
                   gamma = __ldg(tb + 2 * t4), beta = __ldg(tb + 3 * t4),
                   bn = __ldg(tb + 4 * t4);
      const int oy = t.oy0 + ry;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const int ox = t.ox0 + kPix * gx + j;
        const bool keep = live && oy < g.ho && ox < g.wo;
        const size_t p = ((size_t)t.img * g.ho + oy) * g.wo + ox;
        const float4 v = make_float4(
            stem_bn(acc[j][0], mean.x, inv.x, gamma.x, beta.x),
            stem_bn(acc[j][1], mean.y, inv.y, gamma.y, beta.y),
            stem_bn(acc[j][2], mean.z, inv.z, gamma.z, beta.z),
            stem_bn(acc[j][3], mean.w, inv.w, gamma.w, beta.w));
        if (keep) *reinterpret_cast<float4*>(out + p * g.f + ch) = v;
        if (bits != nullptr) {          // the same for the whole block
          uint32_t word =
              ((uint32_t)(__fadd_rn(v.x, bn.x) > 0.f) |
               (uint32_t)(__fadd_rn(v.y, bn.y) > 0.f) << 1 |
               (uint32_t)(__fadd_rn(v.z, bn.z) > 0.f) << 2 |
               (uint32_t)(__fadd_rn(v.w, bn.w) > 0.f) << 3)
              << shift;
          // the 8 threads of one word are 8 consecutive lanes
          word |= __shfl_xor_sync(REPRO_FULL_MASK, word, 1);
          word |= __shfl_xor_sync(REPRO_FULL_MASK, word, 2);
          word |= __shfl_xor_sync(REPRO_FULL_MASK, word, 4);
          if (keep && (q & 7) == 0) bits[p * fw + ch / 32] = word;
        }
      }
    }
    __syncthreads();             // before this buffer is staged again
    tile = next;
  }
  cp_async_wait<0>();
}

}  // namespace

// x [n, h, w, 3] float NHWC, wt [3, 3, 3, f], table [5, f], out
// [n*ho*wo, f], bits [n*ho*wo, f/32] or NULL; (rows, cols, slab) is the
// wrapper's plan (residual.stem_plan).  A shape or plan the kernel does
// not take is refused (cudaErrorInvalidValue), as is a plan whose shared
// memory exceeds what a block may have.
extern "C" int stem_conv_launch(const float* x, const float* wt,
                                const float* table, float* out,
                                uint32_t* bits, int n, int h, int w, int c,
                                int f, int kh, int kw, int stride, int pad,
                                int ho, int wo, int rows, int cols,
                                int slab, int sms, cudaStream_t stream) {
  if ((long long)n * ho * wo == 0) return 0;
  if (f % 32 || f <= 0 || kh != 3 || kw != 3 || c != 3 || n < 0 ||
      stride < 1 || ho < 1 || wo < 1 || rows < 1 || cols < kPix ||
      cols % kPix || (slab != 32 && slab != 64 && slab != 128) ||
      f % slab || sms < 1)
    return (int)cudaErrorInvalidValue;
  StemGeo g{};
  g.h = h; g.w = w; g.f = f; g.stride = stride; g.pad = pad;
  g.ho = ho; g.wo = wo; g.rows = rows; g.cols = cols; g.slab = slab;
  g.lanes = g.slab / kCh;
  g.groups = kThreads / g.lanes;
  g.gcols = cols / kPix;
  g.prow = (rows - 1) * stride + 3;
  g.passes = (rows * g.gcols + g.groups - 1) / g.groups;
  g.patch = g.prow * 9 * cols;
  g.tiles_y = (ho + rows - 1) / rows;
  g.tiles_x = (wo + cols - 1) / cols;
  const long long tiles = (long long)n * g.tiles_y * g.tiles_x;
  const long long smem = 2LL * 4 * g.prow * 9 * cols;
  if (tiles >= (1LL << 31) || smem >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  g.smem = (int)smem;
  auto kernel = stem_conv_bn_sign_kernel;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (g.smem > most) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in: once per
  // device, to the most a block may have
  static bool attr_set[64] = {};
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, g.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int slabs = f / g.slab;
  const long long fill = (long long)per_sm * sms / slabs;  // a wave
  const long long blocks = fill < 1 ? 1 : fill < tiles ? fill : tiles;
  const dim3 grid((unsigned)blocks, (unsigned)slabs);
  kernel<<<grid, kThreads, g.smem, stream>>>(x, wt, table, out, bits, g);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------ //
// stem_conv_pool_kernel: Bi-Real Net's stem, conv 7x7 / 2 + BN + max  //
// pool 3x3 / 2 (pad -inf) + the next sign's words                      //
// ------------------------------------------------------------------ //
// Arithmetic: every conv output sums its 147 taps in the order (kh, kw,
// c) from 0, each product and each sum rounded on its own, then stem_bn,
// then the max of the window's batch-normed values (exact, in any
// order), so the pooled map and the words equal stem_conv_plain's bit
// for bit.
//
// Bounds on the H100, at Bi-Real Net-18's stem (224x224x3 -> 112x112x64
// -> 56x56x64): 118.0 M multiply-adds an image, 3.52 us at the 67
// TFLOP/s float32 FMA peak, and the kernel may not fuse them (the stated
// precision), so 7.04 us at the 33.5 T non-FMA operations/s the FP32
// lanes issue; bytes (pixels in, pooled map and words out) 0.43 us.  The
// design keeps the lanes on products and sums:
//  - A block owns a band of `band` pooled rows of one image (from the
//    wrapper's plan, stem_pool_plan) and a slab of 32 or 64 channels, a
//    warp 8 of them.  It walks down the band a pair of conv rows (2 py,
//    2 py + 1) at a time: the lanes 0-15 of a warp sum row 2 py, lanes
//    16-31 row 2 py + 1, a lane the columns g, g + 16, ..., g + 96 (g =
//    lane % 16) for its warp's 8 channels, 56 independent accumulator
//    chains.  The weights of a tap are the same for the whole warp (two
//    broadcast 16-byte loads); a tap's input is one 4-byte shared load a
//    pixel.
//  - Input rows are staged by 4-byte cp.async into a ring of 16 rows,
//    each split by the parity of its column ([row][parity][col / 2][c],
//    zero outside the image: the zero pad), so that at any tap the 16
//    lanes of a row read 16 consecutive pixels of one parity, 3 floats
//    apart: no two lanes share a bank, and a parity array's pitch of 4
//    mod 8 floats keeps the two half-warps' rows (two input rows apart)
//    on the other 16 banks.  A step needs 9 input rows, 5 of them the
//    last step's; the 4 new ones of the next step are copied while this
//    one sums.
//  - The pool: a half-warp's rows meet by one shuffle (lane ^ 16), the
//    max of rows 2 py and 2 py + 1 then takes the max with row 2 py - 1
//    (the last pair's second row, kept in shared memory `prev`) into the
//    row `vmax`; after a barrier the block takes each pooled pixel's max
//    over three columns of `vmax`, stores 16 bytes a pixel (4 channels)
//    and ORs the next sign's nibbles into words by three shuffles.  A
//    band that does not start at the top first sums the pair (2 py0 - 2,
//    2 py0 - 1) for its row 2 py0 - 1.
namespace pooled {

constexpr int kK = 7;          // taps of a row and of a column
constexpr int kLanesRow = 16;  // lanes of a warp on one conv row
constexpr int kPix = 7;        // conv columns a lane: g + 16 j
constexpr int kChW = 8;        // channels a warp
constexpr int kRing = 16;      // staged input rows (a power of 2)
constexpr int kThreadsMax = 256;

struct PoolGeo {
  int h, w, f, ho, wo, ph, pw;   // the input, the conv's output, the pool's
  int slab;      // channels a block: 32 or 64
  int threads;   // 4 * slab (a warp 8 channels)
  int band;      // pooled rows a block
  int bands;     // bands of an image
  int ap;        // floats of one parity array of a staged row (4 mod 8)
  int stage_n;   // elements a staged row copies: 2 * (wo + 3) * 3
};

__device__ __forceinline__ float stem_bn(float acc, float mean, float inv,
                                         float gamma, float beta) {
  const float v = __fmul_rn(__fsub_rn(acc, mean), inv);
  return __fadd_rn(__fmul_rn(v, gamma), beta);
}

__global__ void __launch_bounds__(kThreadsMax, 2)
stem_conv_pool_kernel(const float* __restrict__ x,
                      const float* __restrict__ wt,
                      const float* __restrict__ table,
                      float* __restrict__ out, uint32_t* __restrict__ bits,
                      PoolGeo g) {
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;                                  // [16][2][ap]
  float* prev = ring + kRing * 2 * g.ap;             // [slab / 8][wo][8]
  float* vmax = prev + g.slab * g.wo;                // [slab / 8][wo][8]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int half = lane / kLanesRow, col = lane % kLanesRow;
  const int img = blockIdx.x / g.bands;
  const int py0 = (blockIdx.x - img * g.bands) * g.band;
  const int py1 = min(py0 + g.band, g.ph);
  const int slab0 = blockIdx.y * g.slab;
  const int ch = slab0 + kChW * warp;                // the warp's channels
  const float* xi = x + (size_t)img * g.h * g.w * 3;

  // input row iy into its ring slot, split by column parity: entry q of
  // parity p is column 2 (q - 2) + p, zero outside the image
  auto stage = [&](int iy) {
    const uint32_t dst0 = repro::smem_addr(ring + (iy & (kRing - 1)) * 2 *
                                           g.ap);
    const bool row_ok = iy >= 0 && iy < g.h;
    for (int e = tid; e < g.stage_n; e += g.threads) {
      const int ix = e / 3 - 4, c = e - (e / 3) * 3;
      const int par = ix & 1, q = (ix >> 1) + 2;
      const bool ok = row_ok && ix >= 0 && ix < g.w;
      const float* src = ok ? xi + ((size_t)iy * g.w + ix) * 3 + c : x;
      repro::cp_async<4>(dst0 + 4 * (par * g.ap + 3 * q + c), src, ok);
    }
  };

  // a lane's conv columns, clamped to the map (a spare lane sums a real
  // column and stores nothing)
  int xoff[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
    xoff[j] = 3 * min(col + kLanesRow * j, g.wo - 1);
  const float* tb = table + ch;     // the warp's 8 channels of each row
  float* prev_w = prev + warp * g.wo * kChW;
  float* vmax_w = vmax + warp * g.wo * kChW;

  // the first pair: (2 py0 - 2, 2 py0 - 1) where the band starts below
  // the top, else rows 2 py0 and 2 py0 + 1, with row -1 as -inf
  const bool pre = py0 > 0;
  int y0 = pre ? 2 * py0 - 2 : 2 * py0;
  if (!pre && half == 1) {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int ox = col + kLanesRow * j;
      if (ox < g.wo) {
        const float4 ninf = make_float4(-INFINITY, -INFINITY, -INFINITY,
                                        -INFINITY);
        float4* d = reinterpret_cast<float4*>(prev_w + ox * kChW);
        d[0] = ninf;
        d[1] = ninf;
      }
    }
  }
  for (int iy = 2 * y0 - 3; iy <= 2 * y0 + 5; ++iy) stage(iy);
  repro::cp_async_commit();
  const int steps = py1 - py0 + (pre ? 1 : 0);
  for (int s = 0; s < steps; ++s, y0 += 2) {
    repro::cp_async_wait<0>();
    __syncthreads();             // this pair's rows, and vmax free again
    if (s + 1 < steps)
      for (int iy = 2 * y0 + 6; iy <= 2 * y0 + 9; ++iy) stage(iy);
    repro::cp_async_commit();

    const int y = y0 + half;     // this lane's conv row
    float acc[kPix][kChW];
#pragma unroll
    for (int j = 0; j < kPix; ++j)
#pragma unroll
      for (int k = 0; k < kChW; ++k) acc[j][k] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < kK; ++kh) {
      const float* row = ring + ((2 * y + kh - 3) & (kRing - 1)) * 2 * g.ap;
      const float* wk = wt + (size_t)kh * kK * 3 * g.f + ch;
#pragma unroll
      for (int kw = 0; kw < kK; ++kw) {
        // column 2 ox + kw - 3: parity 0 at entry ox + (kw + 1) / 2 for
        // an odd kw, parity 1 at entry ox + kw / 2 for an even one
        const float* base =
            row + ((kw & 1) ? 3 * ((kw + 1) / 2) : g.ap + 3 * (kw / 2));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4* wp =
              reinterpret_cast<const float4*>(wk + (kw * 3 + c) * g.f);
          const float4 wa = __ldg(wp), wb = __ldg(wp + 1);
          const float wv[kChW] = {wa.x, wa.y, wa.z, wa.w,
                                  wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            const float xv = base[xoff[j] + c];
#pragma unroll
            for (int k = 0; k < kChW; ++k)
              acc[j][k] = __fadd_rn(acc[j][k], __fmul_rn(xv, wv[k]));
          }
        }
      }
    }

    // the batch norm (its table read again each step: held across the
    // sums it would take registers the accumulators need), then the two
    // rows of the pair meet (lane ^ 16); a row below the map is -inf
    const bool row_ok = y < g.ho;
    float mean[kChW], inv[kChW], gam[kChW], bet[kChW];
#pragma unroll
    for (int k = 0; k < kChW; ++k) {
      mean[k] = __ldg(tb + k);
      inv[k] = __ldg(tb + g.f + k);
      gam[k] = __ldg(tb + 2 * g.f + k);
      bet[k] = __ldg(tb + 3 * g.f + k);
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      float r[kChW], m[kChW];
#pragma unroll
      for (int k = 0; k < kChW; ++k) {
        r[k] = row_ok ? stem_bn(acc[j][k], mean[k], inv[k], gam[k], bet[k])
                      : -INFINITY;
        m[k] = fmaxf(r[k], __shfl_xor_sync(REPRO_FULL_MASK, r[k], 16));
      }
      const int ox = col + kLanesRow * j;
      float4* pv = reinterpret_cast<float4*>(prev_w + ox * kChW);
      if (half == 0 && ox < g.wo && !(pre && s == 0)) {
        const float4 p0 = pv[0], p1 = pv[1];
        float4* vv = reinterpret_cast<float4*>(vmax_w + ox * kChW);
        vv[0] = make_float4(fmaxf(m[0], p0.x), fmaxf(m[1], p0.y),
                            fmaxf(m[2], p0.z), fmaxf(m[3], p0.w));
        vv[1] = make_float4(fmaxf(m[4], p1.x), fmaxf(m[5], p1.y),
                            fmaxf(m[6], p1.z), fmaxf(m[7], p1.w));
      }
      __syncwarp();              // row 2 py - 1 read before it is replaced
      if (half == 1 && ox < g.wo) {
        pv[0] = make_float4(r[0], r[1], r[2], r[3]);
        pv[1] = make_float4(r[4], r[5], r[6], r[7]);
      }
    }
    __syncthreads();             // vmax holds the pooled row's columns
    if (pre && s == 0) continue;

    // pooled row py: a thread 4 channels of one pixel, 8 consecutive
    // threads a 32-channel word
    const int py = y0 / 2;
    const int quads = g.slab / 4;
    const int total = g.pw * quads;
    for (int t0 = 0; t0 < total; t0 += g.threads) {
      const int t = t0 + tid;
      const bool live = t < total;
      const int tc = live ? t : 0;
      const int px = tc / quads, q4 = tc - px * quads;
      const float* vq = vmax + (q4 / 2) * g.wo * kChW + (q4 & 1) * 4;
      float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int cx = 2 * px + dx;
        if (cx >= 0 && cx < g.wo) {
          const float4 a = *reinterpret_cast<const float4*>(vq + cx * kChW);
          v = make_float4(fmaxf(v.x, a.x), fmaxf(v.y, a.y), fmaxf(v.z, a.z),
                          fmaxf(v.w, a.w));
        }
      }
      const int c4 = slab0 + 4 * q4;
      const size_t p = ((size_t)img * g.ph + py) * g.pw + px;
      if (live) *reinterpret_cast<float4*>(out + p * g.f + c4) = v;
      if (bits != nullptr) {     // the same for the whole block
        const float4 bn = __ldg(reinterpret_cast<const float4*>(
            table + 4 * g.f + c4));
        uint32_t word =
            ((uint32_t)(__fadd_rn(v.x, bn.x) > 0.f) |
             (uint32_t)(__fadd_rn(v.y, bn.y) > 0.f) << 1 |
             (uint32_t)(__fadd_rn(v.z, bn.z) > 0.f) << 2 |
             (uint32_t)(__fadd_rn(v.w, bn.w) > 0.f) << 3)
            << (4 * (q4 & 7));
        word |= __shfl_xor_sync(REPRO_FULL_MASK, word, 1);
        word |= __shfl_xor_sync(REPRO_FULL_MASK, word, 2);
        word |= __shfl_xor_sync(REPRO_FULL_MASK, word, 4);
        if (live && (q4 & 7) == 0) bits[p * (g.f / 32) + c4 / 32] = word;
      }
    }
  }
  repro::cp_async_wait<0>();
}

}  // namespace pooled

// x [n, h, w, 3] float NHWC, wt [7, 7, 3, f], table [5, f], out [n, ph,
// pw, f], bits [n, ph, pw, f/32] or NULL: the 7x7 stride-2 pad-3 conv,
// its batch norm and the 3x3 stride-2 pad-1 max pool; (slab, band) is the
// wrapper's plan (residual.stem_pool_plan).  A shape or plan the kernel
// does not take is refused (cudaErrorInvalidValue): the conv's rows are
// at most 16 x 7 = 112 columns wide.
extern "C" int stem_conv_pool_launch(const float* x, const float* wt,
                                     const float* table, float* out,
                                     uint32_t* bits, int n, int h, int w,
                                     int f, int slab, int band,
                                     cudaStream_t stream) {
  if (n < 0 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  pooled::PoolGeo g{};
  g.h = h; g.w = w; g.f = f;
  g.ho = (h + 6 - pooled::kK) / 2 + 1;
  g.wo = (w + 6 - pooled::kK) / 2 + 1;
  g.ph = (g.ho + 2 - 3) / 2 + 1;
  g.pw = (g.wo + 2 - 3) / 2 + 1;
  if ((long long)n * g.ph * g.pw == 0) return 0;
  if (f % 32 || f <= 0 || (slab != 32 && slab != 64) || f % slab ||
      g.ho < 1 || g.wo < 1 || g.ph < 1 || g.pw < 1 ||
      g.wo > pooled::kLanesRow * pooled::kPix || band < 1)
    return (int)cudaErrorInvalidValue;
  g.slab = slab;
  g.threads = 4 * slab;
  g.band = band;
  g.bands = (g.ph + band - 1) / band;
  g.ap = 3 * (g.wo + 3);
  g.ap += (4 - g.ap % 8 + 8) % 8;              // 4 mod 8 floats
  g.stage_n = 2 * (g.wo + 3) * 3;
  const long long blocks = (long long)n * g.bands;
  const long long smem = 4LL * (pooled::kRing * 2 * g.ap + 2LL * slab * g.wo);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = pooled::stem_conv_pool_kernel;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > most) return (int)cudaErrorInvalidValue;
  static bool attr_set[64] = {};
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  const dim3 grid((unsigned)blocks, (unsigned)(f / slab));
  kernel<<<grid, g.threads, (size_t)smem, stream>>>(x, wt, table, out, bits,
                                                    g);
  return (int)cudaGetLastError();
}
