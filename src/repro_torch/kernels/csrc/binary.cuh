// Device helpers shared by the binary kernels: the XNOR popcount, the
// closed-form pad correction, and packing a warp's decisions into a word.
//
// Replaces the in-kernel helpers of src/repro/kernels/csa.py (csa,
// csa_fold, csa_finalize, pack_bit_planes).  The TPU's VPU has no
// popcount instruction, so the reference runs a Harley-Seal carry-save
// network over bit planes; Hopper has a native 32-bit popcount
// (__popc), which gives the same total, and the total is the whole
// contract.
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

// popcount of XNOR(a, b): the number of agreeing bits
__device__ __forceinline__ int xnor_popc(uint32_t a, uint32_t b) {
  return __popc(~(a ^ b));
}

// signed +-1 dot over the k valid bits, from the popcount over all
// k_packed bits (pad bits are 0 on both sides, so each agrees)
__device__ __forceinline__ int closed_form_dot(int pc, int k_packed, int k) {
  return 2 * (pc - (k_packed - k)) - k;
}

// threshold modes, shared by the C entry points
enum ThresholdMode { kNoThreshold = 0, kScalar = 1, kPerChannel = 2 };

__device__ __forceinline__ bool decide(int dot, int mode, int thr,
                                       const int32_t* tvec, int col) {
  return dot >= (mode == kPerChannel ? tvec[col] : thr);
}

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
