// Device helpers shared by the binary kernels: the threshold modes of
// the C entry points and packing a warp's decisions into a word.
//
// Replaces the in-kernel helpers of src/repro/kernels/csa.py (csa,
// csa_fold, csa_finalize, pack_bit_planes).  The TPU's VPU has no
// popcount instruction, so the reference runs a Harley-Seal carry-save
// network over bit planes; on Hopper the b1 tensor cores' AND-popcount
// (b1_mma.cuh) and the native 32-bit popcount (__popc) give the same
// totals, and the total is the whole contract.
//
// Packing: lane j of a warp holds the decision for column 32*g + j, so
// __ballot_sync puts it at bit j of word g, which is the PackedArray
// layout (bit b of word j <-> element 32*j + b).  Columns >= valid_n are
// forced to 0, the pad contract every consumer's closed form relies on.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_FULL_MASK 0xffffffffu

namespace repro {

// threshold modes, shared by the C entry points
enum ThresholdMode { kNoThreshold = 0, kScalar = 1, kPerChannel = 2 };

// one packed word per warp: bit j = lane j's decision (all 32 lanes of
// the warp must call this, in step)
__device__ __forceinline__ uint32_t pack_warp(bool bit, int col, int valid_n) {
  return __ballot_sync(REPRO_FULL_MASK, bit && col < valid_n);
}

}  // namespace repro

// every library exports this so the Python wrapper can name an error
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
