// Bit-serial matmul (paper Eq. 1) against prepacked weight planes:
//   P[m, n] = sum_{x, y} 2^(x+y) * popcount(a_x[m, :] & w_y[n, :])
//           = sum_k a[m, k] * w[n, k]   (mod 2^32, like the reference's int32)
// where a and w are the codes (at most 8 bits) that the planes slice.
//
// Three entry points share one kernel template and differ only in where
// the activation codes come from and in how many products one launch runs:
//
//   repro_bitserial_matmul_fused   qa (M, K) int32 codes; the kernel keeps
//     each code's low a_bits bits (the bits the Pallas kernel slices).
//     Replaces src/repro/kernels/bitserial_matmul.py::
//     bitserial_matmul_fused (Pallas; body _fused_kernel + _accumulate).
//   repro_bitserial_matmul_packed  pa (a_bits, M, KW) 32-bit words, packed
//     beforehand (the popcount backend packs with bitplane_pack.cu).
//     Replaces src/repro/kernels/bitserial_matmul.py::
//     bitserial_matmul_packed (Pallas; body _kernel + _accumulate).
//   repro_bitserial_matmul_fused_batched  E products in one launch: qa
//     (E, M, K) int32 codes against pw (E, w_bits, N, KW), P (E, M, N).
//     The counterpart of bitserial_matmul_fused under jax.vmap over an MoE
//     expert bank (src/repro/models/lm/moe.py::_packed_expert_ffn), which
//     is one batched pallas_call with the expert on its grid; here the
//     expert is on blockIdx.z beside the K split, and each expert's
//     operands and output are reached through its stride.
//
// All take pw (w_bits, N, KW) 32-bit words, the prepacked subarray image
// (an expert's slice of it for the batched entry), and return P (M, N)
// int32. All also take the launch plan that
// kernels/bitserial_matmul.py::_plan makes: the tile, the words of K per
// split and the number of splits. repro_bitserial_matmul_tile reports each
// tile's geometry, which the wrapper holds against its own table at load.
//
// Bound on the H100. P is M*N*K multiply-adds of codes of at most 8 bits,
// which the int8 tensor cores run at 1,979 TOP/s (H100 SXM data sheet), and
// it moves the codes or planes in, the weight planes in and P out at 3.35
// TB/s. At every shape the served paths give (M from 1 to 25,088) the bytes
// take longer; the operations bound only a large square product.
//
// Design. The planes are rebuilt into u8 codes and multiplied on the int8
// tensor cores with mma.sync.m16n8k32.row.col.s32.u8.u8.s32:
// - Codes rebuilt once per block. After each pipeline step's copies land,
//   the block turns them into u8 tiles in shared memory, each row's or
//   column's 32-K group once: 8 plane words become 8 code words by a
//   transpose of the 8 x 32 bit matrix in three rounds of masked swaps (no
//   table), and the fused entry packs int32 codes into bytes with
//   __byte_perm and cuts them to a_bits. Inside a group, code word q (0..7)
//   holds in byte i the code of k = q + 8i, which is the order the swaps
//   give; both operands use it, and a dot product does not care which. The
//   warps then load their mma fragments with plain 32-bit shared loads, the
//   tile rows padded to 4 words past a multiple of 8 so the loads of a
//   fragment fall in distinct banks.
// - Tiles sized to M. A 16-row tile (one m16 tile, eight warps across 128
//   columns) for M <= 16, where every row past M would be padding, and a
//   64x128 tile (eight warps of 32x32) above. Padding rows cost mma slots
//   only, which the tensor cores spare at these shapes. (Measured on the
//   H100: the copies, not the conversion or the mma, take most of a step,
//   and more warps an SM and fewer, larger steps hide them best.)
// - Two blocks an SM at least, as _plan assumes. Shared memory admits two
//   or more blocks of every variant (static_assert in Smem), and
//   __launch_bounds__ asks for two, which caps a thread at 128 registers
//   (ptxas spills nothing there). The 64-row tile on int32 codes would
//   need 128,000 B with u8 tiles of its own, one block an SM, so it writes
//   them over the ring stage it has just read instead (every thread
//   converts into registers, the block syncs, then stores): 100,352 B, two
//   blocks. The others keep their own tiles: measured on the H100, moving
//   them too gained no block where registers already hold two, cost 5-10%
//   for the extra barrier, and let a third 16-row block in, which ran the
//   rwkv6-3b head's 512 blocks in 1.3 waves instead of 2, 1.9x slower.
// - Split K. Where the tiles give fewer than two blocks per SM, blocks
//   also split K (blockIdx.z, beside the batched entry's product) and add
//   their partial P to the output with uint32 atomicAdd; the entry zeroes
//   the output first (cudaMemsetAsync on the caller's stream), on that
//   path only. The batched entry's plan counts its E products' tiles when
//   it fills the card, so a bank of 16 experts splits K less. Integer
//   addition mod 2^32 is associative, so the result is exact and the same
//   in every run.
// - Exact and wrapping. A split covers at most 1,024 words (32,768 K), so
//   its s32 mma sum is exact (255^2 * 32,768 < 2^31) and never relies on
//   the mma's own overflow; the splits are added as uint32, which wraps
//   mod 2^32 like the reference, and the bits are stored as int32.
// - Asynchronous staging. Each pipeline step's codes or planes go into a
//   ring of 3 (16-row tile) or 2 (64-row tile) stages in dynamic shared
//   memory with cp.async (16, 8 or 4 bytes per copy, as K's alignment
//   allows), so the next steps' loads are in flight while the block
//   converts and multiplies the current one.
// - Ragged edges masked in place. Words past K, KW or the split's end are
//   zero-filled by the copies themselves (cp.async's source size); rows
//   and columns past M and N are neither copied nor converted, since they
//   reach only outputs past the edge, and only real outputs are stored. No
//   size divides a tile, and the host neither pads nor copies an operand.
//
// The copies, the plane transpose and the mma are in imma.cuh, shared
// with the fused conv (conv2d_fused.cu).
//
// Why u8 and not the binary mma (m16n8k256 .b1 .and.popc): that one keeps
// Eq. 1's plane pairs, so a 16x8x256 product at <8:8> takes 64 mmas (one
// per plane pair) plus their shifted sums, where u8 takes 8. Every served
// path runs <8:8>.
#include "imma.cuh"

namespace {

constexpr int kSlabWords = 1024;  // 32,768 K: the most one split may sum
constexpr uint32_t kByteLsb = 0x01010101u;

// kMT 16-row mma tiles by kNT 8-column mma tiles per warp, WM x kWN
// warps, kKS words of K (32 K each) per pipeline stage, kStages stages.
template <int MT, int WM, int WN, int NT, int KS, int STAGES>
struct Tile {
  static constexpr int kMT = MT, kWN = WN, kNT = NT, kKS = KS;
  static constexpr int kStages = STAGES;
  static constexpr int kBM = 16 * MT * WM, kBN = 8 * NT * WN;
  static constexpr int kThreads = 32 * WM * WN;
  // Words per row of the staged int32 codes and of the u8 tiles: 4 past a
  // multiple of 32 and of 8, for conflict-free shared loads.
  static constexpr int kCodeStride = 32 * KS + 4;
  static constexpr int kU8Stride = 8 * KS + 4;
};
using SmallM = Tile<1, 1, 8, 2, 4, 3>;  // 16 x 128, 8 warps, 128 K a stage
using LargeM = Tile<2, 2, 4, 4, 4, 2>;  // 64 x 128, 8 warps, 128 K a stage

// Shared memory in 32-bit words: kStages ring stages, each holding the
// activations' copies, then the weights'; then the two u8 tiles (kBM then
// kBN rows of kU8Stride words), or, where that would not fit two blocks an
// SM (kOverlay), the tiles written over the start of the stage they come
// from.
template <class T, bool kFromCodes>
struct Smem {
  static constexpr int kA = kFromCodes ? T::kBM * T::kCodeStride
                                       : kMaxBits * T::kBM * T::kKS;
  static constexpr int kStage = kA + kMaxBits * T::kBN * T::kKS;
  static constexpr int kRing = T::kStages * kStage;
  static constexpr int kTiles = (T::kBM + T::kBN) * T::kU8Stride;
  static constexpr bool kOverlay = blocks_per_sm((kRing + kTiles) * 4) < 2;
  static constexpr int kBytes = (kOverlay ? kRing : kRing + kTiles) * 4;
  static_assert(blocks_per_sm(kBytes) >= 2, "_plan plans two blocks an SM");
  static_assert(!kOverlay || kTiles <= kStage, "tiles must fit a stage");
  static_assert(kStage % 4 == 0, "stages must stay 16-byte aligned");
};

// Stages words [kw0, kw0 + kKS) of planes 0..bits-1 of rows row0..row0 +
// kRows - 1 (of `total`) into dst[b][r][kKS]; words at or past kw_hi read
// zero. Rows at or past `total` are not copied: they feed only outputs past
// the edge, which are never stored. A thread keeps one word offset and
// walks rows, and for each row its planes, so a copy costs a pointer add.
template <int kRows, int kKS, int kThreads>
__device__ __forceinline__ void stage_planes(uint32_t* dst,
                                             const uint32_t* src, int bits,
                                             int total, int row0, int kw,
                                             int kw0, int kw_hi, int vec_shift,
                                             int tid) {
  const int per_row = kKS >> vec_shift;  // copies per row: 1, 2 or 4
  const int w = (tid & (per_row - 1)) << vec_shift;
  const int valid_w = max(0, min(1 << vec_shift, kw_hi - (kw0 + w)));
  const int64_t plane = int64_t(total) * kw;
  const int rows = min(kRows, total - row0);
  for (int r = tid / per_row; r < rows; r += kThreads / per_row) {
    const uint32_t* s = src + int64_t(row0 + r) * kw + kw0 + w;
#pragma unroll
    for (int b = 0; b < kMaxBits; ++b) {
      if (b < bits) {
        cp_async(dst + (b * kRows + r) * kKS + w,
                 valid_w ? s + b * plane : src, vec_shift, valid_w);
      }
    }
  }
}

// Stages codes [k0, k0 + 32 * kKS) of rows row0..row0 + kBM - 1 into
// dst[r][kCodeStride]; codes at or past k_hi read 0, rows at or past m are
// not copied.
template <class T>
__device__ __forceinline__ void stage_codes(uint32_t* dst, const int* qa,
                                            int m, int k, int row0, int k0,
                                            int k_hi, int vec_shift, int tid) {
  const int per_row = (32 * T::kKS) >> vec_shift;  // copies per row
  const int e = (tid & (per_row - 1)) << vec_shift;
  const int valid_e = max(0, min(1 << vec_shift, k_hi - (k0 + e)));
  const int rows = min(T::kBM, m - row0);
  for (int r = tid / per_row; r < rows; r += T::kThreads / per_row) {
    cp_async(dst + r * T::kCodeStride + e,
             valid_e ? qa + int64_t(row0 + r) * k + k0 + e : qa, vec_shift,
             valid_e);
  }
}

// The 32 int32 codes c[0..31] of one row's 32-K group, each cut to the low
// bits mask4 keeps in every byte, into dst[0..7] in the same order as
// planes_to_u8: byte i of word q is code q + 8i.
__device__ __forceinline__ void codes_to_u8(const int* c, uint32_t mask4,
                                            uint32_t (&dst)[8]) {
  int v[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int4 q = reinterpret_cast<const int4*>(c)[i];
    v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t lo = __byte_perm(v[q], v[q + 8], 0x0040);
    const uint32_t hi = __byte_perm(v[q + 16], v[q + 24], 0x0040);
    dst[q] = __byte_perm(lo, hi, 0x5410) & mask4;
  }
}

// kFromCodes: ``a`` is (M, K) int32 codes; otherwise (a_bits, M, KW) words.
// Block (x, y, z) computes rows x*kBM.., columns y*kBN.. of product
// z / splits (whose a, pw and out start a_stride, w_stride and out_stride
// words past the previous product's) over the words [s * split_words,
// (s + 1) * split_words) of K, s = z % splits.
// The launch bound asks for two blocks an SM (128 registers a thread):
// without one, ptxas assumes 1,024 threads a block and spills at 64.
template <bool kFromCodes, class T>
__global__ void __launch_bounds__(T::kThreads, 2)
bitserial_matmul_kernel(const void* __restrict__ a_base,
                        const uint32_t* __restrict__ pw_base,
                        uint32_t* __restrict__ out_base, int m, int n, int k,
                        int kw, int a_bits, int w_bits, int split_words,
                        int splits, int64_t a_stride, int64_t w_stride,
                        int64_t out_stride, int vec_a, int vec_w) {
  using S = Smem<T, kFromCodes>;
  constexpr int kKS = T::kKS, kU8 = T::kU8Stride;
  // Conversion units (a row's or column's 32-K group) per thread.
  constexpr int kAUnits = (T::kBM * kKS + T::kThreads - 1) / T::kThreads;
  constexpr int kWUnits = (T::kBN * kKS + T::kThreads - 1) / T::kThreads;
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::kWN, wn = warp % T::kWN;
  const int row0 = blockIdx.x * T::kBM, col0 = blockIdx.y * T::kBN;
  const int product = blockIdx.z / splits;
  const bool atomic = splits > 1;
  const void* const a =
      static_cast<const uint32_t*>(a_base) + product * a_stride;
  const uint32_t* const pw = pw_base + product * w_stride;
  uint32_t* const out = out_base + product * out_stride;
  const int kw_lo = (blockIdx.z % splits) * split_words;
  const int kw_hi = min(kw, kw_lo + split_words);
  const int steps = (kw_hi - kw_lo + kKS - 1) / kKS;
  const uint32_t mask4 = ((1u << a_bits) - 1) * kByteLsb;

  auto load = [&](int slot, int step) {
    uint32_t* base = smem + slot * S::kStage;
    const int kw0 = kw_lo + step * kKS;
    if constexpr (kFromCodes) {
      stage_codes<T>(base, static_cast<const int*>(a), m, k, row0, kw0 * 32,
                     min(k, kw_hi * 32), vec_a, tid);
    } else {
      stage_planes<T::kBM, kKS, T::kThreads>(
          base, static_cast<const uint32_t*>(a), a_bits, m, row0, kw, kw0,
          kw_hi, vec_a, tid);
    }
    stage_planes<T::kBN, kKS, T::kThreads>(base + S::kA, pw, w_bits, n, col0,
                                           kw, kw0, kw_hi, vec_w, tid);
  };
  // One stage's copies -> the u8 tiles at a8 and w8, each (row, 32-K
  // group) once. Over the stage itself (kOverlay), all of the stage is read
  // into registers before any tile word is stored. Rows and columns past
  // the edge keep whatever the tiles held: they reach only outputs that
  // are never stored.
  const int a_units = min(T::kBM, m - row0) * kKS;
  const int w_units = min(T::kBN, n - col0) * kKS;
  auto convert = [&](const uint32_t* stage, uint32_t* a8, uint32_t* w8) {
    if constexpr (!S::kOverlay) {
      for (int u = tid; u < a_units; u += T::kThreads) {
        uint32_t x[8];
        if constexpr (kFromCodes) {
          codes_to_u8(reinterpret_cast<const int*>(stage) +
                          (u / kKS) * T::kCodeStride + (u % kKS) * 32,
                      mask4, x);
        } else {
          planes_to_u8(stage + u, T::kBM * kKS, a_bits, x);
        }
        store8(a8 + (u / kKS) * kU8 + (u % kKS) * 8, x);
      }
      for (int u = tid; u < w_units; u += T::kThreads) {
        uint32_t x[8];
        planes_to_u8(stage + S::kA + u, T::kBN * kKS, w_bits, x);
        store8(w8 + (u / kKS) * kU8 + (u % kKS) * 8, x);
      }
      return;
    }
    uint32_t xa[kAUnits][8], xw[kWUnits][8];
#pragma unroll
    for (int i = 0; i < kAUnits; ++i) {
      const int u = tid + i * T::kThreads;
      if (u < a_units) {
        if constexpr (kFromCodes) {
          codes_to_u8(reinterpret_cast<const int*>(stage) +
                          (u / kKS) * T::kCodeStride + (u % kKS) * 32,
                      mask4, xa[i]);
        } else {
          planes_to_u8(stage + u, T::kBM * kKS, a_bits, xa[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kWUnits; ++i) {
      const int u = tid + i * T::kThreads;
      if (u < w_units)
        planes_to_u8(stage + S::kA + u, T::kBN * kKS, w_bits, xw[i]);
    }
    __syncthreads();  // the whole stage is read
#pragma unroll
    for (int i = 0; i < kAUnits; ++i) {
      const int u = tid + i * T::kThreads;
      if (u < a_units) store8(a8 + (u / kKS) * kU8 + (u % kKS) * 8, xa[i]);
    }
#pragma unroll
    for (int i = 0; i < kWUnits; ++i) {
      const int u = tid + i * T::kThreads;
      if (u < w_units) store8(w8 + (u / kKS) * kU8 + (u % kKS) * 8, xw[i]);
    }
  };

  int acc[T::kMT][T::kNT][4] = {};
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // this step's copies are in; the last mma is done
    const int next = step + T::kStages - 1;
    if (next < steps) load(next % T::kStages, next);
    cp_async_commit();
    uint32_t* const stage = smem + (step % T::kStages) * S::kStage;
    uint32_t* const a8 = S::kOverlay ? stage : smem + S::kRing;
    uint32_t* const w8 = a8 + T::kBM * kU8;
    convert(stage, a8, w8);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kKS; ++w) {
      // Lane (g, t) holds code words t and t + 4 of its rows and column.
      uint32_t af[T::kMT][4], bf[T::kNT][2];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        const uint32_t* p =
            a8 + ((wm * T::kMT + i) * 16 + g) * kU8 + w * 8 + t;
        af[i][0] = p[0];
        af[i][1] = p[8 * kU8];
        af[i][2] = p[4];
        af[i][3] = p[8 * kU8 + 4];
      }
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        const uint32_t* p = w8 + ((wn * T::kNT + j) * 8 + g) * kU8 + w * 8 + t;
        bf[j][0] = p[0];
        bf[j][1] = p[4];
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) mma_u8(acc[i][j], af[i], bf[j]);
      }
    }
  }

  // Accumulator e of an m16n8 tile: row g + 8 * (e / 2), column 2t + e % 2.
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (wm * T::kMT + i) * 16 + g + 8 * (e >> 1);
        const int col = col0 + (wn * T::kNT + j) * 8 + 2 * t + (e & 1);
        if (row < m && col < n) {
          uint32_t* o = out + int64_t(row) * n + col;
          const uint32_t v = static_cast<uint32_t>(acc[i][j][e]);
          if (atomic) {
            atomicAdd(o, v);
          } else {
            *o = v;
          }
        }
      }
    }
  }
}

template <bool kFromCodes, class T>
int launch(const void* a, const void* pw, void* out, int e, int m, int n,
           int k, int kw, int a_bits, int w_bits, int split_words, int splits,
           void* stream) {
  using S = Smem<T, kFromCodes>;
  const auto kernel = bitserial_matmul_kernel<kFromCodes, T>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return int(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  if (int64_t(e) * splits > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid((m + T::kBM - 1) / T::kBM, (n + T::kBN - 1) / T::kBN,
                  e * splits);
  if (grid.y > 65535) return int(cudaErrorInvalidValue);
  if (splits > 1) {  // the splits add into P
    err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * size_t(e) * m * n,
                          static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return int(err);
  }
  constexpr int kPlaneVec = T::kKS < 4 ? T::kKS : 4;  // 16 bytes at most
  const int va =
      kFromCodes ? copy_shift(a, k, 4) : copy_shift(a, kw, kPlaneVec);
  const int vw = copy_shift(pw, kw, kPlaneVec);
  // Each product's operands: (M, K) codes or (a_bits, M, KW) words, then
  // (w_bits, N, KW) words; its output (M, N). A row's alignment carries
  // over to every product, whose start is a whole number of rows on.
  const int64_t a_stride =
      kFromCodes ? int64_t(m) * k : int64_t(a_bits) * m * kw;
  kernel<<<grid, T::kThreads, S::kBytes, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint32_t*>(pw), static_cast<uint32_t*>(out), m, n,
      k, kw, a_bits, w_bits, split_words, splits, a_stride,
      int64_t(w_bits) * n * kw, int64_t(m) * n, va, vw);
  return int(cudaGetLastError());
}

// variant 0 is the 16-row tile, 1 the 64-row tile. Rejects a plan whose
// splits do not tile [0, kw) or whose split could overflow the s32 sum.
template <bool kFromCodes>
int run(const void* a, const void* pw, void* out, int e, int m, int n, int k,
        int kw, int a_bits, int w_bits, int variant, int split_words,
        int splits, void* stream) {
  const int ks = variant == 0 ? SmallM::kKS : LargeM::kKS;
  const bool tiles = kw > 0 ? int64_t(splits - 1) * split_words < kw &&
                                  int64_t(splits) * split_words >= kw
                            : splits == 1;
  if ((variant != 0 && variant != 1) || e < 1 || splits < 1 ||
      split_words < ks || split_words % ks || split_words > kSlabWords ||
      !tiles)
    return int(cudaErrorInvalidValue);
  return variant == 0
             ? launch<kFromCodes, SmallM>(a, pw, out, e, m, n, k, kw, a_bits,
                                          w_bits, split_words, splits, stream)
             : launch<kFromCodes, LargeM>(a, pw, out, e, m, n, k, kw, a_bits,
                                          w_bits, split_words, splits, stream);
}

}  // namespace

// Variant's tile into geometry[0..3]: rows, columns, words of K a pipeline
// stage, and the most words one split may sum.
REPRO_EXPORT int repro_bitserial_matmul_tile(int variant, int* geometry) {
  if (variant != 0 && variant != 1) return int(cudaErrorInvalidValue);
  geometry[0] = variant == 0 ? SmallM::kBM : LargeM::kBM;
  geometry[1] = variant == 0 ? SmallM::kBN : LargeM::kBN;
  geometry[2] = variant == 0 ? SmallM::kKS : LargeM::kKS;
  geometry[3] = kSlabWords;
  return 0;
}

REPRO_EXPORT int repro_bitserial_matmul_fused(const void* qa, const void* pw,
                                              void* out, int m, int n, int k,
                                              int kw, int a_bits, int w_bits,
                                              int variant, int split_words,
                                              int splits, void* stream) {
  return run<true>(qa, pw, out, 1, m, n, k, kw, a_bits, w_bits, variant,
                   split_words, splits, stream);
}

REPRO_EXPORT int repro_bitserial_matmul_packed(const void* pa, const void* pw,
                                               void* out, int m, int n, int kw,
                                               int a_bits, int w_bits,
                                               int variant, int split_words,
                                               int splits, void* stream) {
  return run<false>(pa, pw, out, 1, m, n, kw * 32, kw, a_bits, w_bits,
                    variant, split_words, splits, stream);
}

// E products: qa (E, M, K) int32 codes, pw (E, w_bits, N, KW) words and out
// (E, M, N), each contiguous; one plan for all of them.
REPRO_EXPORT int repro_bitserial_matmul_fused_batched(
    const void* qa, const void* pw, void* out, int e, int m, int n, int k,
    int kw, int a_bits, int w_bits, int variant, int split_words, int splits,
    void* stream) {
  return run<true>(qa, pw, out, e, m, n, k, kw, a_bits, w_bits, variant,
                   split_words, splits, stream);
}
