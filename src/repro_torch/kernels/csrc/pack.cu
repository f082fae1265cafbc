// Binarize + bit-pack: float32 [M, K] -> uint32 words [M, ceil(K/32)],
// bit b of word j = x[32*j + b] > 0 (NaN and -0.0 give 0).
//
// Replaces: src/repro/kernels/pack.py::pack (_kernel), the TPU kernel
// that shift-ors 32 lanes into a word inside (bm, bk) VMEM blocks.
//
// Bound on the H100: bytes.  It reads 4 bytes per element and writes
// 1/8 byte, one compare each, so device memory (3.35 TB/s) is the limit
// by far.  Design: one warp per output word, lane b reads element
// 32*j + b, so each warp reads 128 contiguous bytes (one coalesced
// transaction) and __ballot_sync forms the word in one instruction with
// no shifts.  The ragged last word of a row masks lanes past K (those
// bits are 0, the pad contract).  Lane 0 writes the word.
#include "binary.cuh"

namespace {

__global__ void pack_kernel(const float* __restrict__ x,
                            uint32_t* __restrict__ out, int m, int k,
                            int kw) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long word = gid >> 5;
  const int lane = threadIdx.x & 31;
  if (word >= (long long)m * kw) return;   // whole warps exit together
  const long long row = word / kw;
  const int col = (int)(word - row * kw) * 32 + lane;
  const bool bit = col < k && x[row * k + col] > 0.f;
  const uint32_t w = __ballot_sync(REPRO_FULL_MASK, bit);
  if (lane == 0) out[word] = w;
}

}  // namespace

extern "C" int pack_launch(const float* x, uint32_t* out, int m, int k,
                           int kw, cudaStream_t stream) {
  const long long threads = (long long)m * kw * 32;
  if (threads == 0) return 0;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  pack_kernel<<<(unsigned)grid, block, 0, stream>>>(x, out, m, k, kw);
  return (int)cudaGetLastError();
}
