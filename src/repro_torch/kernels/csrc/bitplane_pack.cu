// Bit-plane slice + 32-lane pack of integer codes.
//
// Replaces: src/repro/kernels/bitplane_pack.py::bitplane_pack (Pallas; body
// _kernel). codes (M, K) int32 -> planes (bits, M, ceil(K/32)) 32-bit words,
// 1 <= bits <= 16, all planes in one pass over the codes.
//
// Bound on the H100: memory. It reads 4*M*K bytes and writes
// bits*M*ceil(K/32)*4; the work per code is a byte insert, and per word
// three rounds of masked swaps.
//
// Design: one thread per output word position (row, w), threads ordered w
// fastest, then row, so that the stores of each plane from a warp are
// contiguous words. The thread reads its 32 codes 16 bytes at a time where
// the rows allow it (K % 4 == 0 and an aligned base), else one code at a
// time; codes past K read as zero, the zero padding of the JAX wrapper
// without a copy. Where K <= 32 a thread is a row, and a warp reads 32*K
// contiguous codes. The codes are narrowed to bytes, word q holding in
// byte i the low byte of code q + 8i; transpose_8x32 (common.cuh) turns
// those 8 words into plane words 0..7. Codes of more than 8 bits take a
// second set of words from their second byte, for planes 8..15. A plane
// takes the bits of the two's-complement code, as slice_and_pack's shift
// and mask do.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 16;

// Code j into byte j / 8 of word j % 8 (low byte), and of hi (second byte).
template <bool kWide>
__device__ __forceinline__ void put_code(uint32_t (&lo)[8], uint32_t (&hi)[8],
                                         int j, int code) {
  const uint32_t c = static_cast<uint32_t>(code);
  lo[j % 8] |= (c & 0xffu) << (8 * (j / 8));
  if (kWide) hi[j % 8] |= ((c >> 8) & 0xffu) << (8 * (j / 8));
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads) bitplane_pack_kernel(
    const int* __restrict__ q, uint32_t* __restrict__ out, int64_t m, int k,
    int kw, int bits, bool vec) {
  const int64_t idx = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t total = m * kw;
  if (idx >= total) return;
  int64_t row;
  int w;
  if (kw == 1) {
    row = idx;
    w = 0;
  } else if (total <= 0x7fffffff) {
    row = unsigned(idx) / unsigned(kw);
    w = int(unsigned(idx) - unsigned(row) * unsigned(kw));
  } else {
    row = idx / kw;
    w = int(idx - row * kw);
  }
  const int* p = q + row * k + w * 32;
  const int n = min(32, k - w * 32);
  uint32_t lo[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t hi[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (vec && n == 32) {
    const int4* p4 = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 c = __ldg(p4 + i);
      put_code<kWide>(lo, hi, 4 * i, c.x);
      put_code<kWide>(lo, hi, 4 * i + 1, c.y);
      put_code<kWide>(lo, hi, 4 * i + 2, c.z);
      put_code<kWide>(lo, hi, 4 * i + 3, c.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < n) put_code<kWide>(lo, hi, j, __ldg(p + j));
  }
  uint32_t* o = out + idx;
  transpose_8x32(lo);
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (b < bits) o[b * total] = lo[b];
  if (kWide) {
    transpose_8x32(hi);
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (8 + b < bits) o[(8 + b) * total] = hi[b];
  }
}

}  // namespace

REPRO_EXPORT int repro_bitplane_pack(const void* q, void* out, long long m,
                                     int k, int kw, int bits, void* stream) {
  if (bits < 1 || bits > kMaxPlanes || k < 1 || kw != (k + 31) / 32 || m < 0)
    return int(cudaErrorInvalidValue);
  const long long threads = m * kw;
  if (threads == 0) return int(cudaSuccess);
  const unsigned blocks = unsigned((threads + kThreads - 1) / kThreads);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* qi = static_cast<const int*>(q);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (bits > 8)
    bitplane_pack_kernel<true><<<blocks, kThreads, 0, s>>>(qi, o, m, k, kw,
                                                           bits, vec);
  else
    bitplane_pack_kernel<false><<<blocks, kThreads, 0, s>>>(qi, o, m, k, kw,
                                                            bits, vec);
  return int(cudaGetLastError());
}
