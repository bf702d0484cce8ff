// Bit-plane slice + 32-lane pack of integer codes.
//
// Replaces: src/repro/kernels/bitplane_pack.py::bitplane_pack (Pallas; body
// _kernel). codes (M, K) int32 -> planes (bits, M, ceil(K/32)) 32-bit words,
// all planes in one pass over the codes.
//
// Bound on the H100: memory. It reads 4*M*K bytes and writes
// bits*M*ceil(K/32)*4; the work per code is a shift, an AND and a ballot.
//
// Design: one warp per 32 consecutive codes of a row. The warp's load is one
// 128-byte coalesced transaction, and __ballot_sync of bit b over the warp is
// the packed word of plane b with no shifting or summing (lane i -> bit i).
// K need not be a multiple of 32: lanes past K contribute the zero code, the
// same zero padding the JAX wrapper applies with jnp.pad, without a copy.
#include "common.cuh"

__global__ void bitplane_pack_kernel(const int* __restrict__ q,
                                     uint32_t* __restrict__ out, int64_t m,
                                     int k, int kw, int bits) {
  const int lane = threadIdx.x & 31;
  const int64_t word = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (word >= m * kw) return;  // uniform across the warp
  const int64_t row = word / kw;
  const int w = int(word % kw);
  const int col = w * 32 + lane;
  const int code = col < k ? q[row * k + col] : 0;
  for (int b = 0; b < bits; ++b) {
    const uint32_t packed = plane_word(code, b);
    if (lane == 0) out[(int64_t(b) * m + row) * kw + w] = packed;
  }
}

REPRO_EXPORT int repro_bitplane_pack(const void* q, void* out, long long m,
                                     int k, int kw, int bits, void* stream) {
  constexpr int kThreads = 256;
  const long long threads = m * kw * 32;
  const unsigned blocks = unsigned((threads + kThreads - 1) / kThreads);
  bitplane_pack_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<uint32_t*>(out), m, k, kw, bits);
  return int(cudaGetLastError());
}
