// Direct (im2col-free) binary conv2d on channel-packed NHWC words, with
// every multiply-accumulate on the tensor cores: an implicit GEMM over
// the packed words, b1 mma.sync with AND-popcount.
//
// x: uint32 [N, H_pad, W_pad, C32], spatial padding already applied as
// zero words (= -1 pixels); w: uint32 [KH*KW*C32, F], tap-major (word
// (kh*KW + kw)*C32 + t pairs with activation word t of window pixel
// (kh, kw)).  Output: the dot int32 [N, HO*WO, F]; or +-1 after
// dot >= T; or, with pack_out, uint32 words [N, HO*WO, ceil(F/32)] with
// bits at filters >= valid_f zeroed.
//
// Replaces: src/repro/kernels/packed_conv.py::packed_conv2d
// (_conv_kernel, _window).  The TPU kernel holds one whole padded image
// resident in VMEM per grid step and sums one XNOR plane per (tap,
// word); a BinaryNet conv2 image is 3.18 MB there, far above the 227 KB
// of shared memory a Hopper block can use, so that design does not
// carry over.
//
// The product.  M = N*HO*WO output pixels (rows) times F filters
// (columns) over K = KH*KW*C32 words in the weights' tap-major order:
// word (i*KW + j)*C32 + t of pixel (oh, ow) is x[img, oh*s + i,
// ow*s + j, t].  mma.sync.m16n8k256.b1 with .and.popc gives, for each
// (pixel, filter), and = popc(x & w) summed over K.  With pc_x and pc_w
// the popcounts of the pixel's and the filter's K words, the XNOR count
// is K_p - pc_x - pc_w + 2*and per word run, and the closed form
// dot = 2*(xnor - (K_p - K)) - K becomes
//     dot = K - 2*(pc_x + pc_w) + 4*and,    K = KH*KW*C bits,
// in which the padded length K_p cancels: zero words appended to K (to
// the MMA depth of 8 words) and the zero channel-pad bits of each tap
// add nothing to pc_x, pc_w or and.  The identity holds for any bits,
// and integer sums are exact in any order, so the result is bit for bit
// the plain version's.
//
// Bound on the H100: operations (2*M*F*K +-1 multiply-accumulates; the
// bytes are a few MB per layer), at 8x the int8 rate: the b1 mma.sync
// runs 8x the +-1 products per instruction of the s8 one and, measured
// from registers on this card, reaches 5.2x the dense int8 rate
// (chip_smoke.py's ceiling probes).  K is short (40 to 144 words on the
// main paths, 5 to 18 MMA depths), so a block's fixed costs weigh as
// much as its MMAs: the first loads' latency, the gather's address
// work, counting pc_x and pc_w, and the epilogue.  The design keeps
// those few per MMA:
//  - A block owns a BM x BN output tile (the wrapper's tile_plan picks
//    it) and walks the whole of K in stages of kKS = 16 words (two MMA
//    depths) through a ring of kStages shared-memory stages filled by
//    cp.async.  Warps own 64 x 32 or 32 x 32 tiles.  (Persistent blocks
//    that load the next tile during this one's epilogue measured slower,
//    and so did K split over blocks with a second pass.)
//  - The gather: each stage copies, per pixel row, the words of K that
//    the stage covers; 16 bytes a copy where C32 % 4 == 0 (a 4-word
//    chunk never straddles two taps), else 4 bytes.  A table in shared
//    memory, built once per block, gives each chunk of K its offset from
//    the pixel's window origin ((i*W_pad + j)*C32 + t, or -1 past K), and
//    each thread works out its rows' window origins once: per copy only
//    a table read and an add.  Rows >= M and K past its end are
//    zero-filled (src-size 0), never read.
//  - Weights: the [kKS, BN] words of a stage are copied as they are
//    (16 bytes a copy where F % 4 == 0), into rows padded by 8 words so
//    that a B fragment's lanes hit 32 different banks.  A fragments come
//    from the pixel rows with ldmatrix (a b16 8x8 matrix is 8 rows of 4
//    words, exactly the b1 fragment layout); B fragments are two 32-bit
//    shared loads.
//  - pc_x and pc_w come from the fragments the warps already hold: of
//    the warps that share a row fragment, one counts it (__popc of its
//    four registers), and of those that share a column fragment, one
//    counts it, so the count adds about 0.5 popc per MMA.  Partial counts
//    are summed over the quad by shuffles and meet in shared memory.
//  - Epilogue: each thread first folds, per column it holds, 2*pc_w, K
//    and the threshold into one number, so that each output is a
//    multiply-add and a compare (on an H100 this cut the conv's device
//    time by a quarter).
//    Lane (g, t) holds rows g and g+8, columns 2t and 2t+1 of each
//    8-column fragment; a warp's 32 columns are one output word, so with
//    pack_out each thread sets its 8 bits of a row's word and two
//    shuffles OR the quad's bits together: no int32 activation reaches
//    device memory.
//  - packed_conv_kernel_residual_epilogue (ReActNet's residual
//    half-step) runs the same block body (conv_block) and, in place of
//    the threshold, the float epilogue of residual.cuh on its own tile:
//    the dot goes through the free stage ring in shared memory, never
//    to device memory, and the block writes the float stream and the
//    next RSign's words (see the kernel).
#include <climits>

#include "b1_mma.cuh"
#include "binary.cuh"
#include "residual.cuh"

namespace {

constexpr int kKS = 16;                // words of K per stage
constexpr int kStages = 4;             // shared-memory ring
constexpr int kAPitch = kKS + 4;       // words per pixel row: ldmatrix without bank conflicts
constexpr int kMmaWords = 8;           // K of one m16n8k256 MMA, in words

// output tile BM x BN, warp tile WM x 32
template <int BM, int BN> struct Tile;
template <> struct Tile<128, 128> { static constexpr int WM = 64; };
template <> struct Tile<64, 128> { static constexpr int WM = 32; };
template <> struct Tile<64, 64> { static constexpr int WM = 32; };

template <int BM, int BN, int AV, int BV>
struct Cfg {
  static constexpr int WM = Tile<BM, BN>::WM, WN = 32;
  static constexpr int kWarpsM = BM / WM, kWarpsN = BN / WN;
  static constexpr int kWarps = kWarpsM * kWarpsN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int MF = WM / 16, NF = WN / 8;
  static constexpr int kBPitch = BN + 8;                  // words per K row
  static constexpr int kAWords = BM * kAPitch;
  static constexpr int kStageWords = kAWords + kKS * kBPitch;
  // copies of a stage: A chunks of AV words (a row holds kKS / AV), B
  // chunks of BV words (a K row holds BN / BV)
  static constexpr int kARowChunks = kKS / AV;
  static constexpr int kARowStep = kThreads / kARowChunks;
  static constexpr int kAPer = BM * kARowChunks / kThreads;
  static constexpr int kBRowChunks = BN / BV;
  static constexpr int kBRowStep = kThreads / kBRowChunks;
  static constexpr int kBPer = kKS * kBRowChunks / kThreads;
  // dynamic shared memory before the gather table: the stages, then the
  // counts pc_x [BM] and pc_w [BN]
  static constexpr int kFixedBytes = 4 * (kStages * kStageWords + BM + BN);
  static_assert(kThreads % kARowChunks == 0 && BM % kARowStep == 0,
                "A copy layout");
  static_assert(kThreads % kBRowChunks == 0 && kKS % kBRowStep == 0,
                "B copy layout");
};

using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::mma_b1;
using repro::smem_addr;

struct Geo {
  int nb, h_pad, w_pad, c32, kh, kw, stride, ho, wo, f, k, mode, thr,
      pack_out, valid_f;
};

// The fused residual half-step (ReActNet): packed_conv_kernel's block
// (conv_block below: the same mainloop), then the epilogue of
// residual.cuh on the block's own tile, so that the int32 dot never
// reaches device memory.  Its outputs are those of packed_conv_kernel's
// dot (kNoThreshold) followed by that epilogue, bit for bit (the plain
// version: residual_conv_plain in kernels/residual.py).
//  - The shortcut, which the conv does not feed, starts on its way
//    before the mainloop: for an identity or doubling shortcut every
//    thread asks the L2 for its share of the block's lines of it
//    (prefetch.global.L2), so that the epilogue's loads hit the L2.
//    (Its tile copied into shared memory by the TMA engine measured
//    slower on the H100: one bulk copy a pixel row, and a block that
//    no longer left room for a third on an SM.  A 2x2 average reads
//    four lines an output line; prefetching them measured slower too.)
//  - The -1 padded dot of each (pixel, column) goes from the MMA
//    fragments into the free stage ring (rows of BN + 8 words: the
//    quad's 8-byte stores hit 32 banks); then a warp takes 32 columns of
//    a pixel row at a time, so that the shortcut's loads and the
//    stream's stores are coalesced and the next RSign's 32 bits are one
//    ballot.  Each thread keeps one channel
//    for the whole tile (its table column in registers) and loads
//    kUnroll rows' shortcuts before it computes any of them.
struct ResGeo {
  int h_in, w_in, pad, cs, has_corr, write_bits;
};

// the fused epilogue's operands
struct Res {
  const int32_t* corr;
  const float* table;
  const float* sc;
  float* out;
  uint32_t* bits;
  ResGeo g;
};

// the block's valid pixel rows and filter columns (F % 32 == 0); M * F <
// 2^31 and the shortcut's size too (the wrapper checks)
template <int BM, int BN>
__device__ __forceinline__ int2 tile_extent(const Geo& geo) {
  return make_int2(min(BM, geo.nb * geo.ho * geo.wo - (int)blockIdx.x * BM),
                   min(BN, geo.f - (int)blockIdx.y * BN));
}

// L2 prefetches of the 128-byte lines of an identity or doubling
// shortcut that the block's epilogue reads (cs % 32 == 0: a line is 32
// channels of one pixel)
template <int BM, int BN, int SC>
__device__ __forceinline__ void prefetch_shortcut(const Geo& geo,
                                                  const Res& res) {
  if (SC == repro::kAvgPool) return;
  const int2 ext = tile_extent<BM, BN>(geo);
  const int segs = ext.y / 32, cs = res.g.cs;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < ext.x * segs; i += blockDim.x) {
    const int r = i / segs;
    int col = n0 + 32 * (i - r * segs);
    if (SC == repro::kDuplicate && col >= cs) col -= cs;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        res.sc + (long long)(m0 + r) * cs + col));
  }
}

// the fused epilogue of a block whose mainloop left acc, pc_x (sx) and
// pc_w (sw), all threads past its barrier
template <int BM, int BN, int AV, int BV, int SC>
__device__ __forceinline__ void residual_tile(
    const int (&acc)[Cfg<BM, BN, AV, BV>::MF][Cfg<BM, BN, AV, BV>::NF][4],
    const int* sx, const int* sw, uint32_t* smem, const Geo& geo,
    const Res& res) {
  using C = Cfg<BM, BN, AV, BV>;
  constexpr int kPitch = BN + 8;
  constexpr int kUnroll = 8;
  static_assert(BM * kPitch <= kStages * C::kStageWords,
                "the dot tile fits the stage ring");
  const ResGeo& rg = res.g;
  int* tile = reinterpret_cast<int*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / C::kWarpsN) * C::WM;
  const int wn0 = (warp % C::kWarpsN) * C::WN;

  // dot = K - 2*(pc_x + pc_w) + 4*and, per column K - 2*pc_w first
  int kw2[C::NF][2];
#pragma unroll
  for (int j = 0; j < C::NF; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      kw2[j][e] = geo.k - 2 * sw[wn0 + j * 8 + 2 * t + e];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm0 + i * 16 + g + 8 * h;
      const int sx2 = 2 * sx[r];
#pragma unroll
      for (int j = 0; j < C::NF; ++j)
        *reinterpret_cast<int2*>(tile + r * kPitch + wn0 + j * 8 + 2 * t) =
            make_int2(kw2[j][0] + 4 * acc[i][j][2 * h] - sx2,
                      kw2[j][1] + 4 * acc[i][j][2 * h + 1] - sx2);
    }
  __syncthreads();

  // warp -> 32 columns of the tile's valid ones and every rstep-th row
  // from its first
  const int2 ext = tile_extent<BM, BN>(geo);
  const int rows = ext.x, chunks = ext.y / 32;
  const int m0 = blockIdx.x * BM;
  const int cn = (warp % chunks) * 32 + lane, f = blockIdx.y * BN + cn;
  const int rstep = C::kWarps / chunks;
  const repro::ResidualChannel ch =
      repro::residual_channel(res.table, f, geo.f);
  const int hw = geo.ho * geo.wo, fw = geo.f / 32;
  for (int r0 = warp / chunks; r0 < rows; r0 += kUnroll * rstep) {
    int d[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * rstep, p = m0 + r;
      if (r >= rows) break;                         // uniform over the warp
      int img = 0, oy = 0, ox = 0;
      if (rg.has_corr || SC == repro::kAvgPool) {
        img = p / hw;
        const int q = p - img * hw;
        oy = q / geo.wo;
        ox = q - oy * geo.wo;
      }
      d[u] = tile[r * kPitch + cn];
      if (rg.has_corr)
        d[u] += res.corr[repro::border_class(oy, ox, geo.stride, rg.pad,
                                             geo.kh, rg.h_in, rg.w_in) *
                             geo.f + f];
      s[u] = repro::shortcut_at<SC>(res.sc, p, f, img, oy, ox, geo.ho,
                                    geo.wo, rg.cs);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * rstep, p = m0 + r;
      if (r >= rows) break;
      const float o = repro::residual_out(d[u], s[u], ch);
      res.out[p * geo.f + f] = o;
      if (rg.write_bits) {
        const uint32_t word =
            __ballot_sync(REPRO_FULL_MASK, repro::next_sign(o, ch));
        if (lane == 0) res.bits[p * fw + f / 32] = word;
      }
    }
  }
}

// One block's work, shared by both kernels: packed_conv_kernel's body,
// whose epilogue (after the mainloop and the counts) is the threshold's
// where SC < 0 and the residual half-step's (shortcut SC) otherwise.
template <int BM, int BN, int AV, int BV, int SC>
__device__ __forceinline__ void conv_block(const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ w,
                                           const int32_t* __restrict__ tvec,
                                           void* out, const Geo& geo,
                                           const Res& res) {
  using C = Cfg<BM, BN, AV, BV>;
  extern __shared__ __align__(16) uint32_t smem[];
  if constexpr (SC >= 0) prefetch_shortcut<BM, BN, SC>(geo, res);
  int* sx = reinterpret_cast<int*>(smem + kStages * C::kStageWords);
  int* sw = sx + BM;
  int* table = sw + BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / C::kWarpsN, wc = warp % C::kWarpsN;
  const int wm0 = wr * C::WM, wn0 = wc * C::WN;
  const long long m_total = (long long)geo.nb * geo.ho * geo.wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_words = geo.kh * geo.kw * geo.c32;
  const int k_steps = (k_words + kMmaWords - 1) / kMmaWords;
  const int n_stages = (k_steps * kMmaWords + kKS - 1) / kKS;

  // the gather table: chunk q of K -> offset of its first word from the
  // window origin, -1 past K
  for (int q = tid; q < n_stages * (kKS / AV); q += C::kThreads) {
    const int kk = q * AV;
    int off = -1;
    if (kk < k_words) {
      const int tap = kk / geo.c32, ch = kk - tap * geo.c32;
      const int i = tap / geo.kw, j = tap - i * geo.kw;
      off = (i * geo.w_pad + j) * geo.c32 + ch;
    }
    table[q] = off;
  }

  // this thread's copies: A rows ar0 + q * kARowStep at chunk ac of a
  // stage's row; B K rows br0 + q * kBRowStep at chunk bc
  const int ac = tid % C::kARowChunks, ar0 = tid / C::kARowChunks;
  const int bc = tid % C::kBRowChunks, br0 = tid / C::kBRowChunks;
  long long a_org[C::kAPer];                    // window origins, -1 past M
#pragma unroll
  for (int q = 0; q < C::kAPer; ++q) {
    const long long p = m0 + ar0 + q * C::kARowStep;
    a_org[q] = -1;
    if (p < m_total) {             // M < 2^31 (the wrapper checks)
      const int hw = geo.ho * geo.wo;
      const int img = (int)p / hw, r = (int)p - img * hw;
      const int oh = r / geo.wo, ow = r - oh * geo.wo;
      a_org[q] = (((long long)img * geo.h_pad + oh * geo.stride) * geo.w_pad +
                  ow * geo.stride) * geo.c32;
    }
  }
  const bool b_col_ok = n0 + bc * BV < geo.f;
  const uint32_t* b_src =
      w + (long long)br0 * geo.f + n0 + (b_col_ok ? bc * BV : 0);
  const uint32_t s0 = smem_addr(smem);
  const uint32_t a_dst = 4 * (ar0 * kAPitch + ac * AV);
  const uint32_t b_dst = 4 * (C::kAWords + br0 * C::kBPitch + bc * BV);
  __syncthreads();                                // the table is built

  auto load = [&](int st) {
    const uint32_t base = s0 + 4 * (st % kStages) * C::kStageWords;
    const int off = table[st * (kKS / AV) + ac];
#pragma unroll
    for (int q = 0; q < C::kAPer; ++q) {
      const bool ok = off >= 0 && a_org[q] >= 0;
      cp_async<4 * AV>(base + a_dst + 4 * q * C::kARowStep * kAPitch,
                       ok ? x + a_org[q] + off : x, ok);
    }
    const int k_left = k_words - st * kKS;
#pragma unroll
    for (int q = 0; q < C::kBPer; ++q) {
      const int kr = br0 + q * C::kBRowStep;
      const bool ok = b_col_ok && kr < k_left;
      cp_async<4 * BV>(base + b_dst + 4 * q * C::kBRowStep * C::kBPitch,
                       ok ? b_src + (long long)(st * kKS + q * C::kBRowStep) *
                                        geo.f
                          : w,
                       ok);
    }
  };

  int acc[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int cx[C::MF][2] = {};     // pc_x partials: rows g, g + 8 of fragment i
  int cw[C::NF] = {};        // pc_w partials: column g of fragment j

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  // this lane's ldmatrix row: lanes 0-15 rows 0-15 at word 0, 16-31 word 4
  const uint32_t a_lane =
      4 * ((wm0 + (lane & 15)) * kAPitch + (lane >> 4) * 4);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // stage st landed; st - 1 is free
    if (st + kStages - 1 < n_stages) load(st + kStages - 1);
    cp_async_commit();
    const uint32_t a_base = s0 + 4 * (st % kStages) * C::kStageWords;
    const uint32_t* bs = smem + (st % kStages) * C::kStageWords + C::kAWords;
#pragma unroll
    for (int ss = 0; ss < kKS / kMmaWords; ++ss) {
      if (st * (kKS / kMmaWords) + ss >= k_steps) break;    // uniform
      uint32_t a[C::MF][4], b[C::NF][2];
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
        ldmatrix_x4(a[i], a_base + a_lane + 4 * (i * 16 * kAPitch +
                                                 ss * kMmaWords));
#pragma unroll
      for (int j = 0; j < C::NF; ++j) {
        const uint32_t* bp = bs + (ss * kMmaWords + t) * C::kBPitch + wn0 +
                             j * 8 + g;
        b[j][0] = bp[0];
        b[j][1] = bp[4 * C::kBPitch];
      }
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
#pragma unroll
        for (int j = 0; j < C::NF; ++j)
          mma_b1(acc[i][j], a[i], b[j][0], b[j][1]);
      // a0, a2 are row g's words t and t+4; a1, a3 row g+8's
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
        if (i % C::kWarpsN == wc) {
          cx[i][0] += __popc(a[i][0]) + __popc(a[i][2]);
          cx[i][1] += __popc(a[i][1]) + __popc(a[i][3]);
        }
#pragma unroll
      for (int j = 0; j < C::NF; ++j)
        if (j % C::kWarpsM == wr) cw[j] += __popc(b[j][0]) + __popc(b[j][1]);
    }
  }
  cp_async_wait<0>();

  // the quad's partial counts, then one warp's share of each row and
  // column into shared memory (each fragment is counted by one warp)
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = cx[i][h];
      v += __shfl_xor_sync(REPRO_FULL_MASK, v, 1);
      v += __shfl_xor_sync(REPRO_FULL_MASK, v, 2);
      if (i % C::kWarpsN == wc && t == 0) sx[wm0 + i * 16 + g + 8 * h] = v;
    }
#pragma unroll
  for (int j = 0; j < C::NF; ++j) {
    int v = cw[j];
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, 1);
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, 2);
    if (j % C::kWarpsM == wr && t == 0) sw[wn0 + j * 8 + g] = v;
  }
  __syncthreads();
  if constexpr (SC >= 0) {
    residual_tile<BM, BN, AV, BV, SC>(acc, sx, sw, smem, geo, res);
    return;
  }

  // per column of this thread: 2*pc_w, and the threshold that 4*and -
  // 2*pc_x is held against (dot >= T  <=>  4*and - 2*pc_x >= T - K +
  // 2*pc_w), which never passes at a column >= F or, packed, >= valid_f
  const int fw = (geo.f + 31) / 32;
  int sw2[C::NF][2], tc[C::NF][2];
#pragma unroll
  for (int j = 0; j < C::NF; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cn = wn0 + j * 8 + 2 * t + e, col = n0 + cn;
      const bool in = col < geo.f && (!geo.pack_out || col < geo.valid_f);
      sw2[j][e] = 2 * sw[cn];
      const int thr = geo.mode == repro::kPerChannel ? (in ? tvec[col] : 0)
                                                      : geo.thr;
      tc[j][e] = in ? thr - geo.k + sw2[j][e] : INT_MAX;
    }
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm0 + i * 16 + g + 8 * h;
      const long long p = m0 + r;
      const int sx2 = 2 * sx[r];
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < C::NF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn0 + j * 8 + 2 * t + e;
          const int y = 4 * acc[i][j][2 * h + e] - sx2;
          if (geo.pack_out) {
            bits |= (uint32_t)(y >= tc[j][e]) << (j * 8 + 2 * t + e);
          } else if (p < m_total && col < geo.f) {
            static_cast<int32_t*>(out)[p * geo.f + col] =
                geo.mode == repro::kNoThreshold ? geo.k + y - sw2[j][e]
                                                : (y >= tc[j][e] ? 1 : -1);
          }
        }
      if (geo.pack_out) {
        bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 1);
        bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 2);
        const int word = (n0 + wn0) / 32;
        if (t == 0 && p < m_total && word < fw)
          static_cast<uint32_t*>(out)[p * fw + word] = bits;
      }
    }
}

template <int BM, int BN, int AV, int BV>
__global__ void __launch_bounds__(Cfg<BM, BN, AV, BV>::kThreads)
packed_conv_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ w,
                   const int32_t* __restrict__ tvec, void* out, Geo geo) {
  conv_block<BM, BN, AV, BV, -1>(x, w, tvec, out, geo, Res{});
}

template <int BM, int BN, int AV, int BV, int SC>
__global__ void __launch_bounds__(Cfg<BM, BN, AV, BV>::kThreads)
packed_conv_kernel_residual_epilogue(const uint32_t* __restrict__ x,
                                     const uint32_t* __restrict__ w,
                                     Geo geo, Res res) {
  conv_block<BM, BN, AV, BV, SC>(x, w, nullptr, nullptr, geo, res);
}

// above 48 KB of dynamic shared memory a kernel must opt in: once per
// kernel and device, to the most a block may have
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&attr_set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && attr_set[dev])) return err;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess && dev < 64) attr_set[dev] = true;
  return err;
}

// dynamic shared memory of a launch: the fixed part and the gather table
template <int BM, int BN, int AV, int BV>
int smem_of_launch(const Geo& geo) {
  const int k_steps = (geo.kh * geo.kw * geo.c32 + kMmaWords - 1) / kMmaWords;
  const int stages = (k_steps * kMmaWords + kKS - 1) / kKS;
  return Cfg<BM, BN, AV, BV>::kFixedBytes + 4 * stages * (kKS / AV);
}

dim3 grid_of(const Geo& geo, int bm, int bn) {
  const long long m_total = (long long)geo.nb * geo.ho * geo.wo;
  return dim3((unsigned)((m_total + bm - 1) / bm), (geo.f + bn - 1) / bn);
}

struct Args {
  const uint32_t* x;
  const uint32_t* w;
  const int32_t* tvec;
  void* out;
  Geo geo;
  cudaStream_t stream;
};

template <int BM, int BN, int AV, int BV>
int launch(const Args& a) {
  using C = Cfg<BM, BN, AV, BV>;
  auto kernel = packed_conv_kernel<BM, BN, AV, BV>;
  static bool attr_set[64] = {};
  const cudaError_t err = allow_smem(kernel, attr_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a.geo, BM, BN), C::kThreads,
           smem_of_launch<BM, BN, AV, BV>(a.geo), a.stream>>>(
      a.x, a.w, a.tvec, a.out, a.geo);
  return (int)cudaGetLastError();
}

struct ResArgs {
  const uint32_t* x;
  const uint32_t* w;
  Geo geo;
  Res res;
  cudaStream_t stream;
};

template <int BM, int BN, int AV, int SC>
int launch_residual(const ResArgs& a) {
  using C = Cfg<BM, BN, AV, 4>;
  auto kernel = packed_conv_kernel_residual_epilogue<BM, BN, AV, 4, SC>;
  static bool attr_set[64] = {};
  const cudaError_t err = allow_smem(kernel, attr_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a.geo, BM, BN), C::kThreads,
           smem_of_launch<BM, BN, AV, 4>(a.geo), a.stream>>>(a.x, a.w, a.geo,
                                                             a.res);
  return (int)cudaGetLastError();
}

#define REPRO_CONV_TILES(X) X(128, 128) X(64, 128) X(64, 64)

template <int AV, int BV>
int launch_tile(int bm, int bn, const Args& a) {
#define REPRO_CONV_TILE(BM, BN) \
  if (bm == BM && bn == BN) return launch<BM, BN, AV, BV>(a);
  REPRO_CONV_TILES(REPRO_CONV_TILE)
#undef REPRO_CONV_TILE
  return (int)cudaErrorInvalidValue;
}

template <int AV, int SC>
int launch_residual_tile(int bm, int bn, const ResArgs& a) {
#define REPRO_CONV_TILE(BM, BN) \
  if (bm == BM && bn == BN) return launch_residual<BM, BN, AV, SC>(a);
  REPRO_CONV_TILES(REPRO_CONV_TILE)
#undef REPRO_CONV_TILE
  return (int)cudaErrorInvalidValue;
}

template <int AV>
int launch_residual_shortcut(int bm, int bn, int shortcut,
                             const ResArgs& a) {
  if (shortcut == repro::kIdentity)
    return launch_residual_tile<AV, repro::kIdentity>(bm, bn, a);
  if (shortcut == repro::kAvgPool)
    return launch_residual_tile<AV, repro::kAvgPool>(bm, bn, a);
  if (shortcut == repro::kDuplicate)
    return launch_residual_tile<AV, repro::kDuplicate>(bm, bn, a);
  return (int)cudaErrorInvalidValue;
}

int smem_of(int bm, int bn) {
#define REPRO_CONV_SMEM(BM, BN) \
  if (bm == BM && bn == BN) return Cfg<BM, BN, 4, 4>::kFixedBytes;
  REPRO_CONV_TILES(REPRO_CONV_SMEM)
#undef REPRO_CONV_SMEM
  return -1;
}

int occupancy_of(int bm, int bn, int table_bytes) {
  int blocks = -1;
#define REPRO_CONV_OCC(BM, BN)                                            \
  if (bm == BM && bn == BN) {                                             \
    using C = Cfg<BM, BN, 4, 4>;                                          \
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        &blocks, packed_conv_kernel<BM, BN, 4, 4>, C::kThreads,           \
        C::kFixedBytes + table_bytes);                                    \
    return err == cudaSuccess ? blocks : -(int)err;                       \
  }
  REPRO_CONV_TILES(REPRO_CONV_OCC)
#undef REPRO_CONV_OCC
  return blocks;
}

}  // namespace

// (bm, bn) is the output tile, from the wrapper's tile plan.  16-byte
// copies where C32 % 4 == 0 (x) and F % 4 == 0 (w) and the operand is
// 16-byte aligned, else 4-byte copies.
extern "C" int packed_conv2d_launch(const uint32_t* x, const uint32_t* w,
                                    const int32_t* tvec, void* out, int nb,
                                    int h_pad, int w_pad, int c32, int kh,
                                    int kw, int stride, int ho, int wo, int f,
                                    int k, int mode, int thr, int pack_out,
                                    int valid_f, int bm, int bn,
                                    cudaStream_t stream) {
  if ((long long)nb * ho * wo == 0 || f == 0) return 0;
  const Args a{x, w, tvec, out,
               Geo{nb, h_pad, w_pad, c32, kh, kw, stride, ho, wo, f, k, mode,
                   thr, pack_out, valid_f},
               stream};
  const bool av4 = c32 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bv4 = f % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (av4 && bv4) return launch_tile<4, 4>(bm, bn, a);
  if (av4) return launch_tile<4, 1>(bm, bn, a);
  if (bv4) return launch_tile<1, 4>(bm, bn, a);
  return launch_tile<1, 1>(bm, bn, a);
}

// The fused residual half-step: x the RSign's words with the -1 spatial
// pad applied ([N, H_pad, W_pad, C32]), w [KH*KW*C32, F] tap-major and
// 16-byte aligned, corr [16, F] or NULL (a conv without a pad), table
// [9, F], sc the shortcut map ([M, cs], or [N, 2*ho, 2*wo, cs] for the
// average), out [M, F] float32, bits [M, F/32] or NULL; k = KH*KW*C
// bits, pad the spatial pad applied, F % 32 == 0; shortcut 0 identity,
// 1 2x2 average, 2 f mod cs.  (bm, bn) from the wrapper's tile plan.
extern "C" int packed_conv2d_residual_launch(
    const uint32_t* x, const uint32_t* w, const int32_t* corr,
    const float* table, const float* sc, float* out, uint32_t* bits, int nb,
    int h_pad, int w_pad, int c32, int kh, int kw, int stride, int ho, int wo,
    int f, int k, int pad, int cs, int shortcut, int bm, int bn,
    cudaStream_t stream) {
  if ((long long)nb * ho * wo == 0) return 0;
  if (f % 32 || f == 0 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const ResArgs a{x, w,
                  Geo{nb, h_pad, w_pad, c32, kh, kw, stride, ho, wo, f, k,
                      repro::kNoThreshold, 0, 0, f},
                  Res{corr, table, sc, out, bits,
                      ResGeo{h_pad - 2 * pad, w_pad - 2 * pad, pad, cs,
                             corr != nullptr, bits != nullptr}},
                  stream};
  if (c32 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_residual_shortcut<4>(bm, bn, shortcut, a);
  return launch_residual_shortcut<1>(bm, bn, shortcut, a);
}

// dynamic shared memory of one block of tile (bm, bn) before its gather
// table (4 bytes per chunk of K), bytes; -1 for no such tile
extern "C" int packed_conv2d_smem_bytes(int bm, int bn) {
  return smem_of(bm, bn);
}

// blocks of tile (bm, bn) with 16-byte copies on both operands that one
// SM holds at once, with a gather table of table_bytes; -1 for no such
// tile, or the CUDA error negated
extern "C" int packed_conv2d_blocks_per_sm(int bm, int bn, int table_bytes) {
  return occupancy_of(bm, bn, table_bytes);
}
