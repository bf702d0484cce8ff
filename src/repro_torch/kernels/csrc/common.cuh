// Shared by the kernels: the export macro, the error string entry every
// library carries, and the 8 x 32 bit transpose between bit planes and
// byte codes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr int kMaxBits = 8;

// The 8 x 32 bit transpose: viewing the 256 bits of x by (word w, bit
// j), three rounds of masked swaps exchange bit s of the word index with bit
// s of the bit position (s = 0, 1, 2). Plane words (word b, bit j the bit b
// of code j) become code words (word q, byte i the code q + 8i), and, each
// round being its own inverse, code words become plane words.
__device__ __forceinline__ void transpose_8x32(uint32_t (&x)[8]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if (!(w & (1 << s))) {
        const int w2 = w | (1 << s);
        const uint32_t mask =
            s == 0 ? 0x55555555u : s == 1 ? 0x33333333u : 0x0f0f0f0fu;
        const uint32_t d = ((x[w] >> (1 << s)) ^ x[w2]) & mask;
        x[w2] ^= d;
        x[w] ^= d << (1 << s);
      }
    }
  }
}
