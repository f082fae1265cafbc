// A stack of thresholded fully-binary dense layers in one launch.
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
// sit VMEM-resident and the grid runs over M only.  BinaryNet's fc1
// weights alone are 1024 x 256 words = 1 MiB, far above the 227 KB of
// shared memory a Hopper block can use, so the weights are not resident
// here.
//
// Bound on the H100: operations at large M (an XOR, a popcount and an
// add per word pair); at serving batches the weight stream from L2,
// which every block reads once per layer.  Design: one block per tile of
// bm rows keeps its rows' packed activations in two shared-memory
// buffers (ping-pong across layers, a __syncthreads() between layers),
// so no intermediate activation reaches device memory — the property
// that defines the kernel.  Each layer's weights stream through a
// shared-memory tile of 256 columns x 32 words, read along K in
// coalesced 128-byte rows (each thread issues its 32 loads of a tile at
// once, so a tile costs one L2 round trip) and stored transposed (padded
// to 257) so lane = output column reads without bank conflicts; an
// activation word is a broadcast.  The row tile bm is a template
// parameter (1, 2, 4, ..., 32), so each thread keeps exactly bm row sums
// in registers and the inner loop tests no row (a runtime row count over
// 32 unrolled rows made the loop cost the same at bm = 1 as at 32); a
// row's 32 decisions become one word through __ballot_sync.
#include "binary.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileCols = kThreads;      // output columns per pass
constexpr int kBK = 32;                  // words per weight tile
constexpr int kTileStride = kTileCols + 1;
constexpr int kLoads = kTileCols * kBK / kThreads;   // per thread per tile

struct Layer {
  const uint32_t* w;
  const int32_t* tvec;   // nullptr: scalar threshold thr
  int n, kw, k, thr;
};

struct Stack {
  Layer layer[kMaxLayers];
  int n_layers;
};

template <int BM>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int m, int w0, Stack st, int buf_words) {
  extern __shared__ uint32_t smem[];
  uint32_t* wt = smem + 2 * BM * buf_words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * BM;
  const int rows = m - row0 < BM ? (int)(m - row0) : BM;

  // rows past the end of a ragged last tile compute on zero words and
  // are never stored
  for (int i = threadIdx.x; i < BM * w0; i += blockDim.x) {
    const int r = i / w0, t = i % w0;
    smem[r * buf_words + t] = r < rows ? x[(row0 + r) * w0 + t] : 0u;
  }
  __syncthreads();

  for (int l = 0; l < st.n_layers; ++l) {
    const Layer L = st.layer[l];
    const uint32_t* src = smem + (l & 1) * BM * buf_words;
    uint32_t* dst = smem + ((l + 1) & 1) * BM * buf_words;
    const bool last = l == st.n_layers - 1;
    const int nw_out = (L.n + 31) / 32;
    const int mode = L.tvec ? repro::kPerChannel : repro::kScalar;

    for (int n0 = 0; n0 < L.n; n0 += kTileCols) {
      const int col = n0 + warp * 32 + lane;
      const bool in = col < L.n;
      int acc[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = 0;

      for (int t0 = 0; t0 < L.kw; t0 += kBK) {
        const int tn = min(kBK, L.kw - t0);
        // all of a thread's tile loads are issued before any is stored,
        // so a tile costs one L2 round trip, not kLoads of them
        uint32_t v[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = j * kThreads + threadIdx.x;
          const int c = i / kBK, t = i % kBK;
          const int gc = n0 + c;
          v[j] = (gc < L.n && t < tn)
                     ? __ldg(L.w + (long long)gc * L.kw + t0 + t) : 0u;
        }
        __syncthreads();   // the previous tile has been read
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = j * kThreads + threadIdx.x;
          wt[(i % kBK) * kTileStride + i / kBK] = v[j];
        }
        __syncthreads();
        for (int t = 0; t < tn; ++t) {
          const uint32_t wv = wt[t * kTileStride + warp * 32 + lane];
#pragma unroll
          for (int r = 0; r < BM; ++r)
            acc[r] += repro::xnor_popc(src[r * buf_words + t0 + t], wv);
        }
      }

      const int g = n0 / 32 + warp;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const int dot = repro::closed_form_dot(acc[r], 32 * L.kw, L.k);
        const bool bit = in && repro::decide(dot, mode, L.thr, L.tvec, col);
        const uint32_t word = repro::pack_warp(bit, col, L.n);
        if (lane == 0 && g < nw_out && r < rows) {
          if (last)
            out[(row0 + r) * nw_out + g] = word;
          else
            dst[r * buf_words + g] = word;
        }
      }
    }
    __syncthreads();   // dst is complete before the next layer reads it
  }
}

template <int BM>
cudaError_t launch(const uint32_t* x, uint32_t* out, int m, int w0,
                   const Stack& st, int buf_words, cudaStream_t stream) {
  const size_t smem =
      sizeof(uint32_t) * ((size_t)2 * BM * buf_words + kBK * kTileStride);
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((m + BM - 1) / BM);
  fused_mlp_kernel<BM><<<grid, kThreads, smem, stream>>>(x, out, m, w0, st,
                                                         buf_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_mlp_launch(const uint32_t* x, uint32_t* out, int m,
                                int w0, int n_layers,
                                const void* const* w_ptrs,
                                const void* const* t_ptrs, const int* ns,
                                const int* kws, const int* ks,
                                const int* thrs, int bm, int buf_words,
                                cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Stack st;
  st.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    st.layer[l].w = static_cast<const uint32_t*>(w_ptrs[l]);
    st.layer[l].tvec = static_cast<const int32_t*>(t_ptrs[l]);
    st.layer[l].n = ns[l];
    st.layer[l].kw = kws[l];
    st.layer[l].k = ks[l];
    st.layer[l].thr = thrs[l];
  }
  switch (bm) {   // the row tile is a power of two (stack_plan)
    case 1: return (int)launch<1>(x, out, m, w0, st, buf_words, stream);
    case 2: return (int)launch<2>(x, out, m, w0, st, buf_words, stream);
    case 4: return (int)launch<4>(x, out, m, w0, st, buf_words, stream);
    case 8: return (int)launch<8>(x, out, m, w0, st, buf_words, stream);
    case 16: return (int)launch<16>(x, out, m, w0, st, buf_words, stream);
    case 32: return (int)launch<32>(x, out, m, w0, st, buf_words, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
