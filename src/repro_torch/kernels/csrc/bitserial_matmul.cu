// Bit-serial matmul (paper Eq. 1) against prepacked weight planes:
//   P[m, n] = sum_{x, y} 2^(x+y) * popcount(a_x[m, :] & w_y[n, :])
//
// Two entry points share one tile loop and differ only in where the
// activation planes come from:
//
//   repro_bitserial_matmul_fused   qa (M, K) int32 codes, sliced and packed
//     inside the kernel. Replaces src/repro/kernels/bitserial_matmul.py::
//     bitserial_matmul_fused (Pallas; body _fused_kernel + _accumulate).
//   repro_bitserial_matmul_packed  pa (a_bits, M, KW) 32-bit words, packed
//     beforehand (the popcount backend packs with bitplane_pack.cu).
//     Replaces src/repro/kernels/bitserial_matmul.py::
//     bitserial_matmul_packed (Pallas; body _kernel + _accumulate).
//
// Both take pw (w_bits, N, KW) 32-bit words and return P (M, N) int32.
//
// Bound on the H100. The product itself is M*N*K multiply-adds of codes of
// at most 8 bits, which the int8 tensor cores run at 1,979 TOP/s (H100 SXM
// data sheet); its least time is the larger of that and the bytes moved
// (codes or planes in, weight planes in, P out, at 3.35 TB/s), and at the
// shapes that chip_smoke.py times the bytes are the larger. This kernel
// does the product on the CUDA cores instead, as M*N*KW*a_bits*w_bits
// AND+POPC pairs, and __popc issues at 16 per clock per SM (CUDA C++
// Programming Guide, arithmetic instruction throughput, compute capability
// 9.0): that issue rate, not the bytes, is what holds this design back, and
// the tensor cores' b1 AND+POPC mma is the route past it.
//
// Design: one block per 64x64 output tile, 256 threads, each thread 4x4
// outputs in registers. K runs innermost in steps of 8 words: the block
// stages its 64 rows of activation planes in shared memory (the fused entry
// packs them from the codes with one warp ballot per plane and word, so its
// packed planes never reach device memory, as in the Pallas kernel; the
// packed entry copies the words), stages the w_bits weight planes beside
// them, and every thread ANDs and popcounts its rows against its columns.
// The sum is kept in uint32 so overflow wraps mod 2^32 like the reference's
// int32 (signed overflow would be undefined), and its bits are stored as
// int32. Ragged M, N and K edges are masked in place: rows and columns past
// the edge read zero codes and zero words, and only real outputs are
// stored, so no size needs to divide a tile (the Pallas kernel needed
// divisor tiles, and its bn % 128 != 0 path once dropped columns).
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kWords = 8;
constexpr int kTM = 4, kTN = 4;
constexpr int kThreads = 256;  // (kBM / kTM) * (kBN / kTN)

// kFromCodes: ``a`` is (M, K) int32 codes; otherwise (a_bits, M, KW) words.
template <bool kFromCodes>
__global__ void __launch_bounds__(kThreads)
bitserial_matmul_kernel(const void* __restrict__ a,
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
    if constexpr (kFromCodes) {
      // Slice and pack this K step of the block's activation rows.
      const int* qa = static_cast<const int*>(a);
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
    } else {
      // Copy this K step of the block's packed activation planes.
      const uint32_t* pa = static_cast<const uint32_t*>(a);
      for (int b = 0; b < a_bits; ++b) {
        for (int t = tid; t < kBM * nw; t += kThreads) {
          const int r = t / nw, w = t % nw;
          const int64_t row = row0 + r;
          a_s[b][w][r] = row < m ? pa[(int64_t(b) * m + row) * kw + kw0 + w] : 0u;
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
      uint32_t av[kMaxBits][kTM], wv[kMaxBits][kTN];
#pragma unroll
      for (int b = 0; b < kMaxBits; ++b) {
        if (b < a_bits) {
#pragma unroll
          for (int i = 0; i < kTM; ++i) av[b][i] = a_s[b][w][ty + i * (kBM / kTM)];
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
                  acc[i][j] += uint32_t(__popc(av[x][i] & wv[y][j])) << (x + y);
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

template <bool kFromCodes>
int launch(const void* a, const void* pw, void* out, int m, int n, int k,
           int kw, int a_bits, int w_bits, void* stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  bitserial_matmul_kernel<kFromCodes><<<grid, kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint32_t*>(pw), static_cast<uint32_t*>(out), m, n,
      k, kw, a_bits, w_bits);
  return int(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT int repro_bitserial_matmul_fused(const void* qa, const void* pw,
                                              void* out, int m, int n, int k,
                                              int kw, int a_bits, int w_bits,
                                              void* stream) {
  return launch<true>(qa, pw, out, m, n, k, kw, a_bits, w_bits, stream);
}

REPRO_EXPORT int repro_bitserial_matmul_packed(const void* pa, const void* pw,
                                               void* out, int m, int n, int kw,
                                               int a_bits, int w_bits,
                                               void* stream) {
  return launch<false>(pa, pw, out, m, n, kw * 32, kw, a_bits, w_bits, stream);
}
