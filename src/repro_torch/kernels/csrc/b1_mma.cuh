// Device helpers of the kernels that sum on the b1 tensor cores
// (packed_conv.cu, fused_mlp.cu, popcount_gemm.cu): cp.async copies into
// shared memory, ldmatrix fragment loads and the b1 AND-popcount
// mma.sync.
//
// mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc gives, for a
// 16 x 256-bit A tile (rows, K) and a 256 x 8-bit B tile (K, columns),
// c += popc(a_row & b_col).  Lane (g, t) = (lane / 4, lane % 4) holds
// A words t and t+4 of rows g and g+8 (a0: row g word t, a1: row g+8
// word t, a2: row g word t+4, a3: row g+8 word t+4), B words t and t+4
// of column g, and the sums of rows g (c0, c1) and g+8 (c2, c3) at
// columns 2t and 2t+1.  An ldmatrix b16 8x8 matrix is 8 rows of 4
// words, exactly one of these b1 fragments.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES (4 or 16) from src to dst, or zeros where ok is false (the
// source is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// c += popc(a & b) over a 16 x 256 by 256 x 8 bit tile
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro
