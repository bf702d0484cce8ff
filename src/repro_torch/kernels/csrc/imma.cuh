// Device pieces shared by the int8 tensor-core kernels (bitserial_matmul.cu
// and conv2d_fused.cu): asynchronous staging into shared memory, the
// bit-plane -> u8 code transpose, and the u8 mma.sync.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxDevices = 64;  // devices whose kernels are configured

constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// Blocks of `bytes` of dynamic shared memory that fit an SM (228 KB, of
// which the runtime keeps 1 KB a block).
constexpr int blocks_per_sm(int bytes) { return 228 * 1024 / (bytes + 1024); }

// Copies 4 << vec_shift bytes; the bytes past 4 * valid are zero-filled.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int vec_shift, int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = 4 * valid;
  if (vec_shift == 2) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  } else if (vec_shift == 1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void store8(uint32_t* dst, const uint32_t (&x)[8]) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// The 32 codes of one row's 32-K group from its staged planes (plane b at
// p[b * plane_stride], bit j the code of k = j) into dst[0..7], word q
// holding in byte i the code of k = q + 8i (transpose_8x32), which leaves
// bit b of code j in word j % 8 at bit 8 * (j / 8) + b.
__device__ __forceinline__ void planes_to_u8(const uint32_t* p,
                                             int plane_stride, int bits,
                                             uint32_t (&dst)[8]) {
  uint32_t x[8];
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b) x[b] = b < bits ? p[b * plane_stride] : 0;
  transpose_8x32(x);
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q] = x[q];
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// log2 of the widest copy (4, 2 or 1 words, at most max_words) that keeps
// every copy aligned: rows of row_words words from base p.
int copy_shift(const void* p, int64_t row_words, int max_words) {
  int v = max_words;
  while (v > 1 && (row_words % v || reinterpret_cast<uintptr_t>(p) % (4 * v)))
    v /= 2;
  return ilog2(v);
}

}  // namespace
