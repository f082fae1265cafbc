// The float entry conv of a BNN with its sign bits packed in the
// epilogue: float32 NHWC x [N, H, W, C] against sign(w), w the latent
// float weights [KH, KW, C, F] (sign = w > 0 ? +1 : -1, as
// torch.where(w > 0, 1, -1)), real zero padding, stride 1 or 2; bit b
// of output word j of pixel (n, oy, ox) is fl32(acc * alpha[32j + b]) > 0
// with acc the float32 sum of the window's x * sign(w) (NaN and a zero
// product give 0; built without --use_fast_math, so a denormal product
// is not flushed).  Output: uint32 words [N, HO, WO, F/32], the
// channel-packed activation the first binary conv takes.
//
// Replaces no pallas_call: the JAX package leaves this conv to XLA
// (repro.core.bnn_layers.binary_weight_conv) and packs its output in a
// separate pass.  On the card that was cuDNN's float32 conv, which
// writes a float32 [N, HO, WO, F] map (512 KB a BinaryNet image), then
// pack.cu reading it back; this kernel takes the place of both, and no
// float map reaches device memory.
//
// Bound on the H100: operations.  BinaryNet's conv1 is 32*32*128
// outputs x 27 taps = 3.54 M float32 multiply-adds an image, against
// 3,072 input and 16,384 output bytes; the sums must be float32 FMAs
// on the SIMT units (no TF32, bf16 or int8 tensor-core path is exact for
// inputs that are not known to be small integers), 132 SMs x 128 lanes,
// so about 106 ns an image at 1.98 GHz against 6 ns of memory.  An FMA
// needs its x and its weight in registers, and only shared-memory loads
// share the issue slots with the FMAs, so the design keeps loads few per
// FMA and enough of them in flight:
//  - A thread owns one output word (32 channels) of kPix = 4
//    neighbouring pixels of a row: 128 sums in registers.  Per tap it
//    loads 4 x values and the tap's 32 signed weights as 8 16-byte
//    loads, then issues 128 FMAs.  All 32 lanes of a warp own the same
//    word, so the weight loads are broadcasts.  The next tap's x values
//    are loaded while this tap's FMAs run, and the tap loop is unrolled
//    by 3, so that loads of later taps overlap them too (254 registers,
//    two blocks an SM).
//  - A block of 4 warps owns a tile of output pixels (TH rows x TW =
//    4*GX columns, swept in up to kPasses passes of its threads) and WB
//    of the F/32 words.  It holds the signed weights and alpha of its
//    words in shared memory, staged once per block (persistent blocks,
//    one wave, walking the tiles word group by word group), and each
//    tile's input patch with its halo, channel-planar ([C][rows][pitch],
//    pitch = 1 mod 4 so that the rows a warp spans fall in different
//    banks), double-buffered: the next tile's patch is copied by 4-byte
//    cp.async (zero-filled outside the image: the real zero padding)
//    while this one is computed.  A table of tap offsets in shared
//    memory turns each tap into one add.
//  - Epilogue: the products with alpha and compares make the word; the
//    words go through shared memory so that a tile's words leave as
//    contiguous stores (a whole BinaryNet tile is one contiguous run).
// Measured (H100 80GB HBM3 at 700 W, BinaryNet's conv1, batch 2048):
// 0.455 ms, 222 ns an image, 48% of the FMA bound; cuDNN's conv and the
// pack it replaces took 1.65 ms.  17 other variants timed on the way
// read 214-349 ns: 8 warps a block (the slowest), 8 pixels x 16
// channels a thread, no unroll or one of 9, no look-ahead, 1 or 2
// passes a tile, 3 blocks an SM (214 ns at batch 2048 but 279 at 256).
// The sum over the window runs in the weights' order (kh, kw, c), the
// same for every pixel, batch and tile: with integer pixels every
// partial sum is an integer below 2^24, exact in any order, so the words
// equal cuDNN's conv followed by the pack bit for bit.
// Offsets into x and out are 64-bit; the wrapper checks that element and
// tile counts stay below 2^31.
#include "b1_mma.cuh"
#include "binary.cuh"

namespace {

using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_addr;

constexpr int kWarps = 4;        // a warp a word of the block's
constexpr int kThreads = 32 * kWarps;
constexpr int kPix = 4;          // pixels of a row a thread
constexpr int kPasses = 4;       // most passes of the block's threads a tile

struct Geo {
  int n, h, w, c, f, kh, kw, pad_h, pad_w, ho, wo;
  int fw;        // F / 32 words a pixel
  int wb, lwb;   // words a block owns (a power of two), its log2
  int gx;        // thread groups along a tile row (a power of two)
  int thb;       // tile rows one pass of the block's threads covers
  int passes;    // passes a tile (up to kPasses)
  int th, tw;    // tile rows and columns of output pixels
  int ltw;       // log2(tw)
  int ph, pwr;   // patch rows, columns used
  int pitch;     // patch row pitch in floats (= 1 mod 4)
  int taps;      // KH * KW * C
  int tiles_y, tiles_x, tiles;   // tiles of one image, all tiles
  int smem;      // dynamic shared memory, bytes
};

// a tile: its word group, image and top-left output pixel
struct Tile {
  int wg, img, oy0, ox0;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int tl) {
  const int per_img = g.tiles_y * g.tiles_x;
  const int per_wg = g.n * per_img;
  const int wg = tl / per_wg, rem = tl - wg * per_wg;
  const int img = rem / per_img, t2 = rem - img * per_img;
  const int ty = t2 / g.tiles_x;
  return Tile{wg, img, ty * g.th, (t2 - ty * g.tiles_x) * g.tw};
}

__device__ __forceinline__ float sign_of(float w) {
  return w > 0.f ? 1.f : -1.f;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
entry_convolve_bits_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ alpha,
                           uint32_t* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                   // [taps][wb][32]
  float* al = ws + g.taps * g.wb * 32;                // [wb][32]
  uint32_t* os = reinterpret_cast<uint32_t*>(al + g.wb * 32);  // [th*tw][wb]
  const int plane = g.ph * g.pitch;
  const int patch = g.c * plane;
  float* xs = reinterpret_cast<float*>(os + g.th * g.tw * g.wb);  // 2 patches
  int* off = reinterpret_cast<int*>(xs + 2 * patch);  // [taps + 1]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int jj = warp % g.wb;                // this warp's word
  const int grp = (warp / g.wb) * 32 + lane; // this thread's pixels
  const int r = grp / g.gx, cg = grp % g.gx;
  const int row_elems = g.pwr * g.c;

  int tile = blockIdx.x;
  if (tile >= g.tiles) return;

  for (int t = tid; t <= g.taps; t += kThreads) {
    const int ch = t % g.c, tap = t / g.c;
    const int dx = tap % g.kw, dy = tap / g.kw;
    off[t] = t < g.taps ? ch * plane + dy * g.pitch + dx : 0;
  }

  // the patch of tile `tl` into buffer `buf`: zeros outside the image
  auto load_patch = [&](const Tile& tl, int buf) {
    const int iy0 = tl.oy0 * S - g.pad_h, ix0 = tl.ox0 * S - g.pad_w;
    const uint32_t dst0 = smem_addr(xs + buf * patch);
    for (int q = tid; q < row_elems; q += kThreads) {
      const int px = q / g.c, ch = q - px * g.c;
      const int ix = ix0 + px;
      const bool col_ok = ix >= 0 && ix < g.w;
      const float* src_col = x + (size_t)tl.img * g.h * g.w * g.c +
                             (size_t)(col_ok ? ix : 0) * g.c + ch;
      const uint32_t dst = dst0 + 4 * (ch * plane + px);
      for (int py = 0; py < g.ph; ++py) {
        const int iy = iy0 + py;
        const bool ok = col_ok && iy >= 0 && iy < g.h;
        cp_async<4>(dst + 4 * py * g.pitch,
                    ok ? src_col + (size_t)iy * g.w * g.c : x, ok);
      }
    }
  };

  Tile cur = tile_at(g, tile);
  load_patch(cur, 0);
  cp_async_commit();
  int staged_wg = -1;
  for (int i = 0; tile < g.tiles; ++i) {
    const int next = tile + gridDim.x;
    Tile nxt{};
    if (next < g.tiles) {
      nxt = tile_at(g, next);
      load_patch(nxt, (i + 1) & 1);
    }
    cp_async_commit();         // an empty group where there is no next
    if (cur.wg != staged_wg) { // the signed weights and alpha of the words
      const int lanes = g.wb * 32;
      for (int e = tid; e < g.taps * lanes; e += kThreads) {
        const int t = e >> (g.lwb + 5), col = e & (lanes - 1);
        ws[e] = sign_of(__ldg(w + (size_t)t * g.f + cur.wg * lanes + col));
      }
      for (int e = tid; e < lanes; e += kThreads)
        al[e] = __ldg(alpha + cur.wg * lanes + e);
      staged_wg = cur.wg;
    }
    cp_async_wait<1>();        // this tile's patch has landed
    __syncthreads();

    const float4* wt = reinterpret_cast<const float4*>(ws) + jj * 8;
    const float4* a4 = reinterpret_cast<const float4*>(al) + jj * 8;
    const int wstep = g.wb * 8;
#pragma unroll 1
    for (int pass = 0; pass < g.passes; ++pass) {
      const int row = r + pass * g.thb;
      const float* xt =
          xs + (i & 1) * patch + row * S * g.pitch + kPix * cg * S;
      float acc[kPix][32];
#pragma unroll
      for (int p = 0; p < kPix; ++p)
#pragma unroll
        for (int b = 0; b < 32; ++b) acc[p][b] = 0.f;
      float xv[kPix];
      {
        const int o = off[0];
#pragma unroll
        for (int p = 0; p < kPix; ++p) xv[p] = xt[o + p * S];
      }
#pragma unroll 3
      for (int t = 0; t < g.taps; ++t) {
        float xn[kPix];        // the next tap's x, loaded ahead
        const int on = off[t + 1];
#pragma unroll
        for (int p = 0; p < kPix; ++p) xn[p] = xt[on + p * S];
        const float4* wq = wt + t * wstep;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 w4 = wq[q];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            acc[p][4 * q + 0] = fmaf(xv[p], w4.x, acc[p][4 * q + 0]);
            acc[p][4 * q + 1] = fmaf(xv[p], w4.y, acc[p][4 * q + 1]);
            acc[p][4 * q + 2] = fmaf(xv[p], w4.z, acc[p][4 * q + 2]);
            acc[p][4 * q + 3] = fmaf(xv[p], w4.w, acc[p][4 * q + 3]);
          }
        }
#pragma unroll
        for (int p = 0; p < kPix; ++p) xv[p] = xn[p];
      }

      // the words: bit b = fl32(acc * alpha) > 0
      uint32_t word[kPix] = {};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 a = a4[q];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          word[p] |= (uint32_t)(acc[p][4 * q + 0] * a.x > 0.f) << (4 * q + 0);
          word[p] |= (uint32_t)(acc[p][4 * q + 1] * a.y > 0.f) << (4 * q + 1);
          word[p] |= (uint32_t)(acc[p][4 * q + 2] * a.z > 0.f) << (4 * q + 2);
          word[p] |= (uint32_t)(acc[p][4 * q + 3] * a.w > 0.f) << (4 * q + 3);
        }
      }
#pragma unroll
      for (int p = 0; p < kPix; ++p)
        os[((row << g.ltw) + kPix * cg + p) * g.wb + jj] = word[p];
    }
    __syncthreads();

    // the tile's words out: runs of wb words a pixel, pixels in row order
    for (int e = tid; e < g.th * g.tw * g.wb; e += kThreads) {
      const int pix = e >> g.lwb, k = e & (g.wb - 1);
      const int oy = cur.oy0 + (pix >> g.ltw);
      const int ox = cur.ox0 + (pix & (g.tw - 1));
      if (oy < g.ho && ox < g.wo)
        out[(((size_t)cur.img * g.ho + oy) * g.wo + ox) * g.fw +
            cur.wg * g.wb + k] = os[e];
    }
    tile = next;
    cur = nxt;
  }
  cp_async_wait<0>();
}

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <int S>
int launch(const float* x, const float* w, const float* alpha, uint32_t* out,
           Geo g, int sms, cudaStream_t stream) {
  auto kernel = entry_convolve_bits_kernel<S>;
  const int groups = kThreads / g.wb;        // pixel groups of a pass
  if (kWarps % g.wb || g.gx > groups) return (int)cudaErrorInvalidValue;
  g.lwb = log2_of(g.wb);
  g.thb = groups / g.gx;
  g.th = g.passes * g.thb;
  g.tw = kPix * g.gx;
  g.ltw = log2_of(g.tw);
  g.ph = (g.th - 1) * S + g.kh;
  g.pwr = (g.tw - 1) * S + g.kw;
  g.pitch = g.pwr + ((1 - g.pwr) % 4 + 4) % 4;
  g.taps = g.kh * g.kw * g.c;
  g.tiles_y = (g.ho + g.th - 1) / g.th;
  g.tiles_x = (g.wo + g.tw - 1) / g.tw;
  const long long tiles =
      (long long)g.n * g.tiles_y * g.tiles_x * (g.fw / g.wb);
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  g.smem = 4 * (g.taps * g.wb * 32 + g.wb * 32 + g.th * g.tw * g.wb +
                2 * g.c * g.ph * g.pitch + g.taps + 1);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (g.smem > most) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in: once per
  // stride and device, to the most a block may have
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
  const long long grid = min((long long)per_sm * sms, (long long)g.tiles);
  kernel<<<(unsigned)grid, kThreads, g.smem, stream>>>(x, w, alpha, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// (wb, gx, passes) is the wrapper's plan (entry_conv.plan); a shape or
// plan the kernel does not take is refused (cudaErrorInvalidValue), as
// is a plan whose shared memory exceeds what a block may have.
extern "C" int entry_conv_launch(const float* x, const float* w,
                                 const float* alpha, uint32_t* out, int n,
                                 int h, int w_in, int c, int f, int kh, int kw,
                                 int stride, int pad_h, int pad_w, int ho,
                                 int wo, int wb, int gx, int passes, int sms,
                                 cudaStream_t stream) {
  if (n == 0) return 0;
  Geo g{};
  g.n = n; g.h = h; g.w = w_in; g.c = c; g.f = f; g.kh = kh; g.kw = kw;
  g.pad_h = pad_h; g.pad_w = pad_w; g.ho = ho; g.wo = wo; g.wb = wb;
  g.gx = gx; g.passes = passes;
  if (n < 0 || sms <= 0 || c < 1 || c > 16 || kh < 1 || kh > 7 || kw < 1 ||
      kw > 7 || f < 32 || f % 32 || pad_h < 0 || pad_h >= kh || pad_w < 0 ||
      pad_w >= kw || ho < 1 || wo < 1 || wb < 1 || (wb & (wb - 1)) ||
      (f / 32) % wb || gx < 1 || (gx & (gx - 1)) || passes < 1 ||
      passes > kPasses)
    return (int)cudaErrorInvalidValue;
  g.fw = f / 32;
  if (stride == 1) return launch<1>(x, w, alpha, out, g, sms, stream);
  if (stride == 2) return launch<2>(x, w, alpha, out, g, sms, stream);
  return (int)cudaErrorInvalidValue;
}
