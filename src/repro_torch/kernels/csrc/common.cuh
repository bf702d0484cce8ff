// Shared by the bit-serial kernels: the export macro, the error string
// entry every library carries, and the warp-ballot bit-plane pack.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxBits = 8;

// The whole warp holds 32 consecutive codes, lane i holding element i.
// Bit b of every code, gathered by one ballot, is exactly the packed word of
// plane b: bit i of the word comes from lane i (the pack_bits layout).
__device__ __forceinline__ uint32_t plane_word(int code, int b) {
  return __ballot_sync(kFullMask, (code >> b) & 1);
}
