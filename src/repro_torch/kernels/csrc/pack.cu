// Binarize + bit-pack: float32 [M, K] -> uint32 words [M, ceil(K/32)],
// bit b of word j = x[32*j + b] > 0 (NaN and -0.0 give 0; pad bits 0),
// or, with a scale [K], x[r, 32*j + b] * scale[32*j + b] > 0: one
// float32 multiply, rounded as torch's, then the compare (built without
// --use_fast_math, so a denormal product is not flushed to zero).  The
// scale is the alpha of a float entry conv, taken here in the load in
// place of a separate elementwise pass over its output.
//
// Replaces: src/repro/kernels/pack.py::pack (_kernel), the TPU kernel
// that shift-ors 32 lanes into a word inside (bm, bk) VMEM blocks.
//
// Bound on the H100: bytes.  It reads 4 bytes per element and writes
// 1/8 byte, one compare each, so device memory (3.35 TB/s) is the limit
// by far, and only if enough bytes are in flight: at DRAM latency the
// card needs several MB outstanding, far more than one 4-byte load a
// thread gives (the first port's design, one warp a word and one 4-byte
// load a lane, reached 34% of the bound at BinaryNet's batch 256).
// Design, one of two paths by the operands (the wrapper's pack_path):
//  - flat (K % 32 == 0, x and scale 16-byte aligned: every main-path
//    call).  Word W then covers the 32 floats at 32*W of the flat
//    array, whatever the row.  A warp owns 32 consecutive words (4 KB)
//    at a time in a grid-stride loop over one wave of resident blocks,
//    and issues all eight of its 16-byte loads before using any: each
//    instruction reads 512 contiguous bytes, four words, lane l the
//    four floats 4*(l % 8) of word l / 8.  Each lane forms its nibble,
//    three xor-shuffles OR a word's eight nibbles together, and one more
//    shuffle hands word L to lane L, so the warp writes its 32 words as
//    128 contiguous bytes.  (Two tiles a warp at once measured slower.)
//  - rows (any K, any alignment: a ragged K, a view at a storage
//    offset): one thread a word (row, j) in a grid-stride loop, 32
//    predicated 4-byte loads over the word's floats before any compare;
//    the ragged last word masks bits >= K to 0.
// x is read once, so its loads are evict-first (ld.global.cs): in the
// forward the producer has just left dirty lines in the L2, and the
// pack's stream should not displace the lines still to be read.  The
// scale is read by every row and goes through the read-only cache.
// Word indices are 32-bit (the wrapper checks M * ceil(K/32) < 2^31);
// element offsets are 64-bit.
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.0454 ms for
// BinaryNet's [262144, 128] with its scale, 91% of the 0.0413 ms bytes
// bound, and 0.0164 ms for AlexNet's [43264, 256], 83% of 0.0136.
#include "binary.cuh"

namespace {

enum Path { kFlat = 0, kRows = 1 };

__device__ __forceinline__ uint32_t nibble(float4 v, float4 s) {
  return (uint32_t)(v.x * s.x > 0.f) | (uint32_t)(v.y * s.y > 0.f) << 1 |
         (uint32_t)(v.z * s.z > 0.f) << 2 | (uint32_t)(v.w * s.w > 0.f) << 3;
}

__device__ __forceinline__ uint32_t nibble(float4 v) {
  return (uint32_t)(v.x > 0.f) | (uint32_t)(v.y > 0.f) << 1 |
         (uint32_t)(v.z > 0.f) << 2 | (uint32_t)(v.w > 0.f) << 3;
}

template <bool SCALE>
__global__ void __launch_bounds__(256)
pack_kernel_flat(const float* __restrict__ x, const float* __restrict__ scale,
                 uint32_t* __restrict__ out, unsigned words, unsigned kw) {
  const int lane = threadIdx.x & 31;
  const unsigned warps = gridDim.x * (blockDim.x >> 5);
  const unsigned tiles = (words + 31) / 32;
  const int sub = lane & 7;            // this lane's 4 floats of a word
  for (unsigned tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       tile < tiles; tile += warps) {
    const unsigned base = tile * 32;
    float4 v[8], s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned w = base + 4 * j + (lane >> 3);
      const float4* src =
          reinterpret_cast<const float4*>(x + (size_t)w * 32 + 4 * sub);
      v[j] = w < words ? __ldcs(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (SCALE)
        s[j] = __ldg(reinterpret_cast<const float4*>(
            scale + (w % kw) * 32 + 4 * sub));
    }
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bits;
      if constexpr (SCALE) bits = nibble(v[j], s[j]) << (4 * sub);
      else bits = nibble(v[j]) << (4 * sub);
      bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 1);
      bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 2);
      bits |= __shfl_xor_sync(REPRO_FULL_MASK, bits, 4);
      // the lanes of group g now hold word 4j + g; lane L keeps word L
      const uint32_t got = __shfl_sync(REPRO_FULL_MASK, bits, 8 * (lane & 3));
      if ((lane >> 2) == j) mine = got;
    }
    if (base + lane < words) out[base + lane] = mine;
  }
}

template <bool SCALE>
__global__ void __launch_bounds__(256)
pack_kernel_rows(const float* __restrict__ x, const float* __restrict__ scale,
                 uint32_t* __restrict__ out, unsigned words, int k,
                 unsigned kw) {
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned w = blockIdx.x * blockDim.x + threadIdx.x; w < words;
       w += step) {
    const unsigned row = w / kw;
    const int c0 = (int)(w - row * kw) * 32;
    const float* xr = x + (size_t)row * k + c0;
    float v[32], s[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const bool ok = c0 + b < k;
      v[b] = ok ? __ldcs(xr + b) : 0.f;
      if constexpr (SCALE) s[b] = ok ? __ldg(scale + c0 + b) : 0.f;
    }
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if constexpr (SCALE) word |= (uint32_t)(v[b] * s[b] > 0.f) << b;
      else word |= (uint32_t)(v[b] > 0.f) << b;
    }
    out[w] = word;
  }
}

// blocks of 256 threads that one SM holds at once (the occupancy API,
// asked once per kernel variant)
template <typename Kernel>
int resident(Kernel kernel, int& cached) {
  if (cached == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, kernel, 256, 0) !=
          cudaSuccess)
    cached = 1;
  return cached > 0 ? cached : 1;
}

// one wave of resident blocks, or fewer where the work is smaller: the
// grid-stride loops take the rest
template <bool SCALE>
int launch(const float* x, const float* scale, uint32_t* out, int m, int k,
           int kw, int path, int sms, cudaStream_t stream) {
  const unsigned words = (unsigned)m * (unsigned)kw;
  const int block = 256;
  if (path == kFlat) {
    static int per_sm = 0;
    auto kernel = pack_kernel_flat<SCALE>;
    const long long tiles = ((long long)words + 31) / 32;   // a warp each
    const long long grid =
        min((long long)resident(kernel, per_sm) * sms, (tiles + 7) / 8);
    kernel<<<(unsigned)grid, block, 0, stream>>>(x, scale, out, words,
                                                 (unsigned)kw);
  } else {
    static int per_sm = 0;
    auto kernel = pack_kernel_rows<SCALE>;
    const long long grid = min((long long)resident(kernel, per_sm) * sms,
                               ((long long)words + block - 1) / block);
    kernel<<<(unsigned)grid, block, 0, stream>>>(x, scale, out, words, k,
                                                 (unsigned)kw);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// path: 0 flat, 1 rows (the wrapper's pack_path); a path the
// operands cannot take is refused (cudaErrorInvalidValue).  scale: NULL
// or float32 [k].
extern "C" int pack_launch(const float* x, const float* scale, uint32_t* out,
                           int m, int k, int kw, int path, int sms,
                           cudaStream_t stream) {
  if ((long long)m * kw == 0) return 0;
  const bool flat = k % 32 == 0 && aligned16(x) &&
                    (scale == nullptr || aligned16(scale));
  if (sms <= 0 || (path == kFlat && !flat) || path < kFlat || path > kRows)
    return (int)cudaErrorInvalidValue;
  return scale ? launch<true>(x, scale, out, m, k, kw, path, sms, stream)
               : launch<false>(x, scale, out, m, k, kw, path, sms, stream);
}
