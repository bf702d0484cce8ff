// Fused bit-serial matmul (paper Eq. 1) from activation codes and
// prepacked weight planes:
//   P[m, n] = sum_{x, y} 2^(x+y) * popcount(a_x[m, :] & w_y[n, :])
//
// Replaces: src/repro/kernels/bitserial_matmul.py::bitserial_matmul_fused
// (Pallas; body _fused_kernel + _accumulate). qa (M, K) int32 codes,
// pw (w_bits, N, ceil(K/32)) 32-bit words -> P (M, N) int32.
//
// Bound on the H100. The product itself is M*N*K multiply-adds of codes of
// at most 8 bits, which the int8 tensor cores run at 1,979 TOP/s (H100 SXM
// data sheet); its least time is the larger of that and the bytes moved
// (codes in, planes in, P out, at 3.35 TB/s), and at the shapes that
// chip_smoke.py times the bytes are the larger. This kernel does the product on the
// CUDA cores instead, as M*N*ceil(K/32)*a_bits*w_bits AND+POPC pairs, and
// __popc issues at 16 per clock per SM (CUDA C++ Programming Guide,
// arithmetic instruction throughput, compute capability 9.0): that issue
// rate, not the bytes, is what holds this design back, and the tensor
// cores' b1 AND+POPC mma is the route past it.
//
// Design: one block per 64x64 output tile, 256 threads, each thread 4x4
// outputs in registers. K runs innermost in steps of 8 words: the block
// packs its 64 rows of activation codes into a_bits planes in shared memory
// with one warp ballot per plane and word (the packed planes never reach
// device memory, as in the Pallas kernel), stages the w_bits weight planes
// beside them, and every thread ANDs and popcounts its rows against its
// columns. The sum is kept in uint32 so overflow wraps mod 2^32 like the
// reference's int32 (signed overflow would be undefined), and its bits are
// stored as int32. Ragged M, N and K edges are masked in place: rows and
// columns past the edge read zero codes and zero words, and only real
// outputs are stored, so no size needs to divide a tile.
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kWords = 8;
constexpr int kTM = 4, kTN = 4;
constexpr int kThreads = 256;  // (kBM / kTM) * (kBN / kTN)

__global__ void __launch_bounds__(kThreads)
bitserial_matmul_fused_kernel(const int* __restrict__ qa,
                              const uint32_t* __restrict__ pw,
                              uint32_t* __restrict__ out, int m, int n, int k,
                              int kw, int a_bits, int w_bits) {
  __shared__ uint32_t a_s[kMaxBits][kWords][kBM];
  __shared__ uint32_t w_s[kMaxBits][kWords][kBN + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int64_t row0 = int64_t(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  uint32_t acc[kTM][kTN] = {};

  for (int kw0 = 0; kw0 < kw; kw0 += kWords) {
    const int nw = min(kWords, kw - kw0);
    // Slice and pack this K step of the block's activation rows.
    for (int t = warp; t < kBM * nw; t += kThreads / 32) {
      const int r = t / nw, w = t % nw;
      const int64_t row = row0 + r;
      const int col = (kw0 + w) * 32 + lane;
      const int code = (row < m && col < k) ? qa[row * k + col] : 0;
#pragma unroll
      for (int b = 0; b < kMaxBits; ++b) {
        if (b < a_bits) {
          const uint32_t word = plane_word(code, b);
          if (lane == 0) a_s[b][w][r] = word;
        }
      }
    }
    // Stage the weight planes of the block's columns.
    for (int b = 0; b < w_bits; ++b) {
      for (int t = tid; t < kBN * nw; t += kThreads) {
        const int c = t / nw, w = t % nw;
        const int col = col0 + c;
        w_s[b][w][c] = col < n ? pw[(int64_t(b) * n + col) * kw + kw0 + w] : 0u;
      }
    }
    __syncthreads();
    for (int w = 0; w < nw; ++w) {
      uint32_t a[kMaxBits][kTM], wv[kMaxBits][kTN];
#pragma unroll
      for (int b = 0; b < kMaxBits; ++b) {
        if (b < a_bits) {
#pragma unroll
          for (int i = 0; i < kTM; ++i) a[b][i] = a_s[b][w][ty + i * (kBM / kTM)];
        }
        if (b < w_bits) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) wv[b][j] = w_s[b][w][tx + j * (kBN / kTN)];
        }
      }
#pragma unroll
      for (int x = 0; x < kMaxBits; ++x) {
        if (x < a_bits) {
#pragma unroll
          for (int y = 0; y < kMaxBits; ++y) {
            if (y < w_bits) {
#pragma unroll
              for (int i = 0; i < kTM; ++i) {
#pragma unroll
                for (int j = 0; j < kTN; ++j) {
                  acc[i][j] += uint32_t(__popc(a[x][i] & wv[y][j])) << (x + y);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = row0 + ty + i * (kBM / kTM);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + j * (kBN / kTN);
      if (row < m && col < n) out[row * n + col] = acc[i][j];
    }
  }
}

}  // namespace

REPRO_EXPORT int repro_bitserial_matmul_fused(const void* qa, const void* pw,
                                              void* out, int m, int n, int k,
                                              int kw, int a_bits, int w_bits,
                                              void* stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  bitserial_matmul_fused_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qa), static_cast<const uint32_t*>(pw),
      static_cast<uint32_t*>(out), m, n, k, kw, a_bits, w_bits);
  return int(cudaGetLastError());
}
