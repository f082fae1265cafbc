// A stack of thresholded fully-binary dense layers in one launch, on
// the b1 tensor cores, with the layers' outputs split over a cluster of
// blocks that hand the activations to each other in shared memory.
//
// x: uint32 [M, W0] packed activations; layer l: weights uint32
// [N_l, KW_l] (row = output channel, packed over K), a threshold (a
// scalar, or int32 [N_l] per channel) and K_l valid bits, with
// KW_{l+1} = ceil(N_l / 32).  Output: the last layer's decisions as
// uint32 words [M, ceil(N_L / 32)]; the words equal chaining
// popcount_gemm with pack_out layer by layer.
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_binary_mlp
// (_build_call, _kernel, _layer_dot).  On the TPU every layer's weights
// sit VMEM-resident and the grid runs over M only.  XNOR-AlexNet's
// fc6 + fc7 weights are 6.8 MB, far above the 227 KB of shared memory a
// Hopper block can use, so here the weights stream and the kernel is
// bound by that stream: at serving batches the operations at the b1
// rate take less time than the weight bytes at the memory rate.
//
// Design:
//  - The grid is ceil(M / BM) row tiles x CS blocks; the CS blocks of a
//    row tile form one thread-block cluster (CS = 16, non-portable, or
//    8; the wrapper's plan picks BM and CS from the clusters the card
//    runs at once).  Block r of a cluster owns the output words
//    [r*nw/CS, (r+1)*nw/CS) of each layer (nw = ceil(N_l / 32)), so it
//    streams only those rows of the layer's [N_l, KW_l] weights: the
//    cluster splits the weight stream CS ways.  A block may own no word;
//    it still joins every cluster barrier.
//  - Activations never leave the chip.  Each block holds its row
//    tile's whole activation in two shared-memory buffers (ping-pong
//    over the layers, BM rows of buf_words + 4 words).  After a layer,
//    each block writes its output words into the next buffer of every
//    block of the cluster through distributed shared memory
//    (st.shared::cluster, spread over all threads: one thread storing to
//    each block in turn took microseconds), and one cluster barrier
//    (arrive.release / wait.acquire) per layer makes them visible.  Only
//    the first layer's input is read from device memory and only the
//    last layer's output written there.
//  - The dot: mma.sync m16n8k256 b1 with AND-popcount, A = the
//    activation buffer (rows = batch rows), B = the weight slice, whose
//    [N, KW] row-major words are the .col layout the MMA takes.  With
//    pc_x, pc_w the popcounts of a row's and a column's K words,
//    dot = K - 2*(pc_x + pc_w) + 4*popc(x & w); zero words appended to
//    K (to whole MMA depths of 8 words) add nothing to any term.  pc_x
//    is counted once a layer from the buffer; pc_w by one more MMA per
//    16 columns: the B fragments of 16 columns, reordered, are an A
//    fragment with those columns as rows, times an all-ones B (a
//    popcount of every fragment cost more than the MMAs).  A warp owns
//    one output word (32 columns) of all BM rows; where a chunk has
//    fewer words than warps, the spare warps split K and the partial
//    sums meet in shared memory.  The epilogue tests
//    4*and - 2*pc_w - 2*pc_x >= T - K per column (T loaded before the
//    chunk's K streams, used only here), sets the row's bits from the
//    MMA layout and ORs the quad's bits with two shuffles.  Columns
//    >= N_l never pass, so pad bits are 0.
//  - Weights in flight: every stage of the block's weight stream (all
//    layers and chunks in one sequence) goes through a ring of kStages
//    shared-memory slots filled by cp.async (16 bytes a copy where
//    every KW_l % 4 == 0), kStages - 1 stages ahead, across chunk and
//    layer boundaries: the next layer's first weights are in flight
//    during a layer's epilogue and exchange.  A thread works out its
//    copies once a chunk, so a stage costs a few instructions a copy.
//    One __syncthreads() per stage; the next stage's copies are issued
//    after the stage's MMAs.  A chunk of up to 8 output words (one per
//    warp) takes stages of kd words of K per column, kd = 32 at 8 words
//    and deeper for fewer (up to 256 at one word), so a stage is about
//    32 KB whatever the slice.  Measured per stage on the H100 (AlexNet
//    fc6, batch 1), the copies alone and the MMAs alone each take about
//    half of a stage's time: they do not yet overlap, and a TMA ring of
//    swizzled 4 KB boxes did no better.
#include <climits>
#include <cooperative_groups.h>

#include "b1_mma.cuh"
#include "binary.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkWords = kWarps;   // output words of a chunk: a warp each
constexpr int kStages = 4;            // the weight ring
constexpr int kStageWords = 9216;     // 256 columns x (32 + kPad) words
constexpr int kPad = 4;               // words after each row: no bank conflicts
constexpr int kMmaWords = 8;          // K of one m16n8k256 MMA, in words

struct Layer {
  const uint32_t* w;
  const int32_t* tvec;   // nullptr: scalar threshold thr
  int n, kw, k, thr;
};

struct Stack {
  Layer layer[kMaxLayers];
  int n_layers;
};

__host__ __device__ constexpr int round8(int words) {
  return (words + kMmaWords - 1) / kMmaWords * kMmaWords;
}

// words of K per column in one stage of a chunk of nwc output words
__device__ __forceinline__ int stage_depth(int nwc) {
  return nwc == 1 ? 256 : nwc == 2 ? 128 : nwc <= 4 ? 64 : 32;
}

// this block's output words [lo, hi) of a layer with nw words
struct Slice {
  int lo, hi, nw;
};

__device__ __forceinline__ Slice slice_of(const Stack& st, int l, int rank,
                                          int cs) {
  const int nw = (st.layer[l].n + 31) / 32;
  return {nw * rank / cs, nw * (rank + 1) / cs, nw};
}

// The block's weight stream: every stage of every chunk of every layer,
// in order.  A Stream walks it kStages - 1 stages ahead of the compute.
// Entering a chunk it works out this thread's copies, the columns
// cf + i * cstep of the chunk at word kk of each stage (coalesced along
// K), so a stage costs a few instructions a copy.  Columns past N_l are
// not copied (their bits never pass); words from KW_l to whole MMA
// depths are zero-filled.
template <int V>   // words a copy: 4 (16 bytes) or 1
struct Stream {
  static constexpr int kMaxCopies = 8 * 4 / V;   // a thread's copies a stage
  int l, c0, s, nst;     // stage s of nst of the chunk at word c0 of layer l
  int kd, kw, kw8, n_cp, kk;
  const uint32_t* src;   // this thread's first copy at stage 0
  long long sstep;       // words between its copies' sources
  uint32_t dst, dstep;   // byte offset of its first copy in a slot, and step

  __device__ __forceinline__ void enter(const Stack& st, int rank, int cs) {
    while (l < st.n_layers && c0 >= slice_of(st, l, rank, cs).hi)
      if (++l < st.n_layers) c0 = slice_of(st, l, rank, cs).lo;
    if (l >= st.n_layers) return;
    const Layer& L = st.layer[l];
    const int nwc = min(kChunkWords, slice_of(st, l, rank, cs).hi - c0);
    kd = stage_depth(nwc);
    kw = L.kw;
    kw8 = round8(L.kw);
    nst = (kw8 + kd - 1) / kd;
    s = 0;
    const int per_col = kd / V, cstep = kThreads / per_col;
    const int cf = threadIdx.x / per_col;
    const int cols = min(32 * nwc, L.n - 32 * c0);
    kk = (threadIdx.x % per_col) * V;
    n_cp = cf < cols ? (cols - cf + cstep - 1) / cstep : 0;
    src = L.w + (long long)(32 * c0 + cf) * L.kw + kk;
    sstep = (long long)cstep * L.kw;
    dst = 4 * (cf * (kd + kPad) + kk);
    dstep = 4 * cstep * (kd + kPad);
  }

  __device__ __forceinline__ void next(const Stack& st, int rank, int cs) {
    if (++s < nst) return;
    c0 += kChunkWords;
    enter(st, rank, cs);
  }

  // this thread's copies of the current stage into the slot at base
  __device__ __forceinline__ void load(uint32_t base) const {
    const int w = s * kd + kk;
    if (w >= kw8) return;
    const bool ok = w < kw;
    const uint32_t* p = src + s * kd;
#pragma unroll
    for (int i = 0; i < kMaxCopies; ++i)
      if (i < n_cp)
        repro::cp_async<4 * V>(base + dst + i * dstep, ok ? p + i * sstep : src,
                               ok);
  }
};

// the address of shared address addr in block rank of the cluster, and
// a store there (distributed shared memory)
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int BM, int V>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int m, int w0, Stack st, int pitch) {
  constexpr int MF = BM / 16;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const bufs = smem + kStages * kStageWords;
  int* const sx = reinterpret_cast<int*>(bufs + 2 * BM * pitch);   // pc_x
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)(blockIdx.x / cs) * BM;
  const int rows = m - row0 < BM ? (int)(m - row0) : BM;
  const uint32_t ring = repro::smem_addr(smem);

  // the row tile's input into buffer 0, zero past row m and from W0 to
  // whole MMA depths
  {
    const int w8 = round8(w0);
    const uint32_t b0 = repro::smem_addr(bufs);
    for (int i = V * tid; i < BM * w8; i += V * kThreads) {
      const int r = i / w8, c = i - r * w8;
      const bool ok = r < rows && c < w0;
      repro::cp_async<4 * V>(b0 + 4 * (r * pitch + c),
                             ok ? x + (row0 + r) * w0 + c : x, ok);
    }
    repro::cp_async_commit();
  }
  Stream<V> ld;
  ld.l = 0;
  ld.c0 = slice_of(st, 0, rank, cs).lo;
  ld.enter(st, rank, cs);
  int s_ld = 0;   // stages issued (one commit group each)
  auto issue = [&]() {
    if (ld.l < st.n_layers) {
      ld.load(ring + 4 * (s_ld % kStages) * kStageWords);
      ld.next(st, rank, cs);
    }
    repro::cp_async_commit();
    ++s_ld;
  };
  for (int i = 0; i < kStages - 1; ++i) issue();
  repro::cp_async_wait<kStages - 1>();    // this thread's input copies
  __syncthreads();                        // the input has landed
  // this block has started (paired with the wait before the first
  // exchange: no block writes into another that has not)
  if (st.n_layers > 1) cluster_arrive_relaxed();

  int s = 0;      // stages consumed
  for (int l = 0; l < st.n_layers; ++l) {
    const Layer L = st.layer[l];
    uint32_t* const src = bufs + (l & 1) * BM * pitch;
    uint32_t* const dst = bufs + ((l + 1) & 1) * BM * pitch;
    const bool last = l == st.n_layers - 1;
    const Slice sl = slice_of(st, l, rank, cs);
    const int ksteps = round8(L.kw) / kMmaWords;
    // pc_x of each row of the layer's input, once for all its chunks
    if (sl.lo < sl.hi)
      for (int r = warp; r < BM; r += kWarps) {
        int c = 0;
        for (int w = lane; w < L.kw; w += 32) c += __popc(src[r * pitch + w]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          c += __shfl_xor_sync(REPRO_FULL_MASK, c, o);
        if (lane == 0) sx[r] = c;
      }
    for (int c0 = sl.lo; c0 < sl.hi; c0 += kChunkWords) {
      const int nwc = min(kChunkWords, sl.hi - c0);
      const int kd = stage_depth(nwc);
      const int nst = (kMmaWords * ksteps + kd - 1) / kd;
      // warps past the chunk's words split K: group grp of ksplit takes
      // every ksplit-th MMA depth of each stage, and the partial sums
      // meet in the last stage's ring slot (which must hold them)
      const int ksplit = min(kWarps / nwc, 1 + kStageWords / (nwc * BM * 32));
      const int wq = warp % nwc, grp = warp / nwc;   // warp-uniform
      const bool active = grp < ksplit;
      const int word = c0 + wq;
      // the thresholds of this warp's columns, loaded here and first used
      // in the epilogue, so the loads complete while K streams
      int thr[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 32 * word + j * 8 + 2 * t + e;
          thr[j][e] = L.tvec && active && grp == 0 && col < L.n ? L.tvec[col]
                                                                : L.thr;
        }
      int acc[MF][4][4];
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
      // pc_w of columns 16 jj + g (in [jj][0]) and 16 jj + 8 + g (in
      // [jj][2]): the weights' B fragments of 16 columns are, reordered,
      // an A fragment of those columns as rows, and its MMA with an
      // all-ones B counts each row
      int pw[2][4] = {};
      // this lane's ldmatrix rows: A rows 0-15 at word 0 (lanes 0-15) or
      // 4; B columns (lane & 7) + 8 * (lane >> 4) of the warp's word, at
      // word 0 or 4 (lane bit 3): matrices (b[j][0], b[j][1], b[j+1][0],
      // b[j+1][1])
      const uint32_t a_lane = repro::smem_addr(src) +
                              4 * ((lane & 15) * pitch + (lane >> 4) * 4);
      const uint32_t b_lane =
          4 * ((wq * 32 + (lane & 7) + ((lane >> 4) << 3)) * (kd + kPad) +
               ((lane >> 3) & 1) * 4);
      for (int si = 0; si < nst; ++si, ++s) {
        repro::cp_async_wait<kStages - 2>();
        __syncthreads();          // stage s landed; slot s - 1 is free
        if (active) {
          const uint32_t b_base = ring + 4 * (s % kStages) * kStageWords +
                                  b_lane;
          const int k8 = si * (kd / kMmaWords);    // first MMA depth
          const int nss = min(kd / kMmaWords, ksteps - k8);
#pragma unroll 2
          for (int ss = grp; ss < nss; ss += ksplit) {
            uint32_t a[MF][4], b[4][2];
#pragma unroll
            for (int i = 0; i < MF; ++i)
              repro::ldmatrix_x4(
                  a[i], a_lane + 4 * (i * 16 * pitch + (k8 + ss) * kMmaWords));
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              uint32_t q[4];
              repro::ldmatrix_x4(q, b_base + 4 * (jj * 16 * (kd + kPad) +
                                                  ss * kMmaWords));
              b[2 * jj][0] = q[0];
              b[2 * jj][1] = q[1];
              b[2 * jj + 1][0] = q[2];
              b[2 * jj + 1][1] = q[3];
              const uint32_t wa[4] = {q[0], q[2], q[1], q[3]};
              repro::mma_b1(pw[jj], wa, ~0u, ~0u);
            }
#pragma unroll
            for (int i = 0; i < MF; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) repro::mma_b1(acc[i][j], a[i],
                                                        b[j][0], b[j][1]);
          }
        }
        issue();        // after the MMAs: the copies wait for room in flight
      }

      // the epilogue of output word c0 + wq: each warp's part of
      // 4*and - 2*pc_w, summed over the K groups; column j*8 + 2t + e's
      // pc_w lives in the lanes of row g = 2t + e
      if (active)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pw2 = 2 * __shfl_sync(REPRO_FULL_MASK,
                                            pw[j >> 1][(j & 1) * 2],
                                            (2 * t + e) * 4);
#pragma unroll
            for (int i = 0; i < MF; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                acc[i][j][2 * h + e] = 4 * acc[i][j][2 * h + e] - pw2;
          }
      if (ksplit > 1) {     // block-uniform
        int* const part = reinterpret_cast<int*>(
            smem + ((s - 1) % kStages) * kStageWords);
        __syncthreads();    // every warp is done with the last stage
        if (active && grp > 0) {
          int* const p = part + ((grp - 1) * nwc + wq) * BM * 32;
#pragma unroll
          for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                p[(i * 16 + g + 8 * (e >> 1)) * 32 + j * 8 + 2 * t + (e & 1)] =
                    acc[i][j][e];
        }
        __syncthreads();
        if (active && grp == 0)
          for (int q = 1; q < ksplit; ++q) {
            const int* const p = part + ((q - 1) * nwc + wq) * BM * 32;
#pragma unroll
            for (int i = 0; i < MF; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[i][j][e] += p[(i * 16 + g + 8 * (e >> 1)) * 32 + j * 8 +
                                    2 * t + (e & 1)];
          }
      }
      if (!active || grp != 0) continue;
      // T - K per column, clamped to int32 (a saturated fold passes
      // always or never); columns past N_l never pass
      int tk[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long v = 32 * word + j * 8 + 2 * t + e < L.n
                                  ? (long long)thr[j][e] - L.k : LLONG_MAX;
          tk[j][e] = (int)max((long long)INT_MIN, min((long long)INT_MAX, v));
        }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = i * 16 + g + 8 * h;
          const int sx2 = 2 * sx[r];
          uint32_t bits = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              bits |= (uint32_t)(acc[i][j][2 * h + e] - sx2 >= tk[j][e])
                      << (j * 8 + 2 * t + e);
          bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 1);
          bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 2);
          if (t == 0 && r < rows) {
            if (last)
              out[(row0 + r) * sl.nw + word] = bits;
            else
              dst[r * pitch + word] = bits;
          }
        }
    }
    if (last) break;

    // hand this block's words to every block of the cluster: zero the
    // next layer's K tail in this block's own buffer, then write the
    // words into each other block's buffer, then one cluster barrier
    const int tail = round8(sl.nw) - sl.nw;
    for (int i = tid; i < BM * tail; i += kThreads)
      dst[(i / tail) * pitch + sl.nw + i % tail] = 0u;
    __syncthreads();              // this block's words of dst are written
    if (l == 0) cluster_wait();   // every block of the cluster runs
    const int sw = sl.hi - sl.lo, per = rows * sw;
    const uint32_t dst_addr = repro::smem_addr(dst);
    for (int i = tid; i < (cs - 1) * per; i += kThreads) {
      const int d = i / per, j = i - d * per;
      const int r = j / sw, off = r * pitch + sl.lo + j - r * sw;
      st_cluster(map_rank(dst_addr + 4 * off, (rank + 1 + d) % cs), dst[off]);
    }
    cluster_arrive_release();
    cluster_wait();
  }
}

int smem_bytes(int bm, int buf_words) {
  return 4 * (kStages * kStageWords + 2 * bm * (buf_words + kPad) + bm);
}

// the function attributes, once per variant and device: the most dynamic
// shared memory a block may have, and clusters of more than 8 blocks
template <int BM, int V>
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_mlp_kernel<BM, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_mlp_kernel<BM, V>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(long long blocks, int cs, int smem, cudaStream_t stream) {
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int BM, int V>
int launch(const uint32_t* x, uint32_t* out, int m, int w0, const Stack& st,
           int cs, int buf_words, cudaStream_t stream) {
  cudaError_t err = prepare<BM, V>();
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)m + BM - 1) / BM;
  Launch lc(tiles * cs, cs, smem_bytes(BM, buf_words), stream);
  err = cudaLaunchKernelEx(&lc.cfg, fused_mlp_kernel<BM, V>, x, out, m, w0,
                           st, buf_words + kPad);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BM>
int active_clusters(int cs, int buf_words) {
  cudaError_t err = prepare<BM, 4>();
  if (err != cudaSuccess) return -(int)err;
  Launch lc(cs, cs, smem_bytes(BM, buf_words), nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fused_mlp_kernel<BM, 4>, &lc.cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// (bm, cs) from the wrapper's stack plan (or forced): BM rows per row
// tile, CS blocks per cluster; buf_words (a multiple of 8, at least each
// layer input's words rounded to 8) sets the activation buffers.  16-byte
// weight copies where every KW_l % 4 == 0 and every weight pointer is
// 16-byte aligned, else 4-byte copies.
extern "C" int fused_mlp_launch(const uint32_t* x, uint32_t* out, int m,
                                int w0, int n_layers,
                                const void* const* w_ptrs,
                                const void* const* t_ptrs, const int* ns,
                                const int* kws, const int* ks,
                                const int* thrs, int bm, int cs,
                                int buf_words, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || cs < 1 || cs > 16 ||
      buf_words % kMmaWords != 0 || round8(w0) > buf_words ||
      kws[0] != w0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Stack st;
  st.n_layers = n_layers;
  bool v4 = w0 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int l = 0; l < n_layers; ++l) {
    if (round8(kws[l]) > buf_words) return (int)cudaErrorInvalidValue;
    st.layer[l].w = static_cast<const uint32_t*>(w_ptrs[l]);
    st.layer[l].tvec = static_cast<const int32_t*>(t_ptrs[l]);
    st.layer[l].n = ns[l];
    st.layer[l].kw = kws[l];
    st.layer[l].k = ks[l];
    st.layer[l].thr = thrs[l];
    v4 = v4 && kws[l] % 4 == 0 &&
         reinterpret_cast<uintptr_t>(w_ptrs[l]) % 16 == 0;
  }
#define REPRO_MLP_LAUNCH(BM)                                              \
  if (bm == BM)                                                           \
    return v4 ? launch<BM, 4>(x, out, m, w0, st, cs, buf_words, stream)   \
              : launch<BM, 1>(x, out, m, w0, st, cs, buf_words, stream);
  REPRO_MLP_LAUNCH(16)
  REPRO_MLP_LAUNCH(32)
  REPRO_MLP_LAUNCH(64)
#undef REPRO_MLP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block: the weight ring and two activation
// buffers of bm rows
extern "C" int fused_mlp_smem_bytes(int bm, int buf_words) {
  return smem_bytes(bm, buf_words);
}

// clusters of cs blocks of row tile bm that the card can run at once
// (cudaOccupancyMaxActiveClusters); 0 if none can be scheduled, the CUDA
// error negated, or -1 for no such row tile
extern "C" int fused_mlp_active_clusters(int bm, int cs, int buf_words) {
  if (bm == 16) return active_clusters<16>(cs, buf_words);
  if (bm == 32) return active_clusters<32>(cs, buf_words);
  if (bm == 64) return active_clusters<64>(cs, buf_words);
  return -1;
}
