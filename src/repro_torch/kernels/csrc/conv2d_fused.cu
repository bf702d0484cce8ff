// Fused implicit-im2col convolution (paper Eq. 1 over patches) on the int8
// tensor cores.
//
// Replaces: src/repro/kernels/conv2d_fused.py::conv2d_bitserial_fused
// (Pallas; body _kernel). pa (a_bits, N*Hp, Wp, CW) channel-packed
// activation planes of the zero-code-padded input, pw (KH, w_bits, O, KW, CW)
// = PackedConvWeight.fused_planes -> P (N*OH, OW, O) int32:
//   P[r, x, o] = sum_{kh, kw, c} a[n*Hp + oh*stride + kh, x*stride + kw, c]
//                               * w[kh, kw, c, o]     (mod 2^32)
// for output row r = n*OH + oh, where a and w are the codes (at most 8
// bits) that the planes slice. The (N*OH*OW, KH*KW*C) patch matrix never
// exists.
//
// Bound on the H100. The conv is N*OH*OW*O*KH*KW*C multiply-adds of codes
// of at most 8 bits, which the int8 tensor cores run at 1,979 TOP/s (H100
// SXM data sheet), and it moves the planes in and P out at 3.35 TB/s. The
// wide layers with C = 512 (VGG19 conv4_2, conv5_1) and AlexNet conv2 are
// bound by the operations, the others by the bytes, most of all P itself
// (103 MB at VGG19 conv1_1 in a bucket of 8).
//
// Design: an implicit GEMM. Rows are output pixels, columns output
// channels, and the contraction runs over (kh, kw, c). Planes are rebuilt
// into u8 codes in shared memory and multiplied with
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 (imma.cuh, shared with
// bitserial_matmul.cu):
// - Tile. A block takes kBM = 128 output pixels, tr output rows of tw
//   columns each (the launch plan, kernels/conv2d_fused.py::_plan: tw = OW,
//   or OW cut into equal parts of at most 128, and tr = 128 / tw rows where
//   shared memory allows, so a 7-wide map can fill 126 of the 128 rows), by
//   kBN = 64 output channels; 8 warps of 32 x 32.
// - Implicit im2col in shared memory. For each kernel row kh (and channel
//   step), the block stages with cp.async the input span its tile reads:
//   for each of its tr rows, input row n*Hp + oh*stride + kh, columns
//   ow0*stride ... (ow0 + tw - 1)*stride + KW - 1, every activation plane.
//   It rebuilds each staged input pixel's codes once, and every kw reads
//   them at column i*stride + kw: a converted pixel serves up to KW taps.
// - One barrier a pipeline unit. After it, unit u's u8 tiles are built and
//   unit u + 1's copies are in; then the block starts the copies of a later
//   unit, builds unit u + 1's tiles into the other of two buffers and
//   multiplies unit u, so the warps' integer work, copies and mma overlap.
// - Wide variant (C >= 32). A channel word is a 32-deep K group, and a
//   step takes ks words (the plan cuts CW into equal steps of at most 4).
//   A unit is one (kh, step, kw): the weight tile pw[kh, :, o0:o0+64, kw,
//   words] is staged and rebuilt for each, the activations at its kw = 0.
//   Code words are in planes_to_u8's order (byte i of word q is channel q
//   + 8i) in both operands. The staged pixels' rows are padded to 8*ks +
//   4/gcd(stride, 4) words, so the eight pixels of a fragment load fall in
//   distinct banks at strides 1, 2 and 4. A block takes one output tile.
// - Narrow variant (C < 32, one word a pixel). A word holds C live lanes of
//   32 (C = 3 at the ResNet stem, AlexNet conv1 and VGG19 conv1_1: 10.7x
//   the real work as 32-deep groups). So for each kh the staged codes are
//   laid out densely, C bytes a column: the patch row of output i is the
//   bytes [i*stride*C, i*stride*C + KW*C), taken in 32-byte K groups in
//   (kw, c) order. The weights are rebuilt into the same order, zero past
//   KW*C, so the bytes a group reads past its patch meet zero weights. A
//   fragment register, 4 bytes at any offset, is a funnel shift of two
//   aligned words. The weights of all of a split's kernel rows are small
//   (45 KB at AlexNet conv1), so a block rebuilds them once and keeps them,
//   and walks an equal share of the output tiles (the plan's m_blocks
//   blocks, about two an SM), one unit a (tile, kh), with a ring of 2 or 3
//   stages.
// - Exact and wrapping. A block sums at most 1,024 words (32,768 K: a
//   split of (kh, step) pairs, or of kernel rows), so its s32 mma sum is
//   exact (255^2 * 32,768 < 2^31) and never relies on the mma's own
//   overflow. Where the plan splits K (past one slab, or to give the card
//   two blocks an SM), blocks add their P with uint32 atomics into an
//   output the entry zeroes first (cudaMemsetAsync, on that path only): it
//   wraps mod 2^32 like the reference and the plain version.
// - Ragged edges masked in place. Pixels past OW, rows past N*OH and
//   channels past O reach only outputs that are never stored, so their
//   copies are skipped; words past CW are zero-filled by the copies
//   (cp.async's source size), lanes past C are zero in both operands. The
//   host neither pads nor copies an operand.
// - Two blocks an SM. The plan keeps each launch's shared memory within
//   kSmemLimit (static_assert: two blocks fit), __launch_bounds__ asks for
//   two, and the C entry rejects any plan past the limit, past a slab, or
//   whose splits do not tile K.
#include "imma.cuh"

namespace {

constexpr int kSlabWords = 1024;        // 32,768 K: the most a block sums
constexpr int kStages = 2;              // wide: cp.async ring depth
constexpr int kMaxStages = 3;           // narrow: 2 or 3, as planned
constexpr int kMT = 2, kNT = 4;         // mma tiles a warp: 32 x 32
constexpr int kWM = 4, kWN = 2;         // warps
constexpr int kBM = 16 * kMT * kWM;     // 128 output pixels a block
constexpr int kBN = 8 * kNT * kWN;      // 64 output channels a block
constexpr int kThreads = 32 * kWM * kWN;
constexpr int kMaxKS = 4;               // wide: channel words a step
constexpr int kSmemLimit = 112 * 1024;  // bytes a block
static_assert(blocks_per_sm(kSmemLimit) >= 2, "the plan asks two blocks an SM");

constexpr int kWide = 0, kNarrow = 1;

__host__ __device__ constexpr int round4(int words) {
  return (words + 3) & ~3;
}

// Shared memory of one launch, in 32-bit words at 16-byte aligned offsets.
// Planes are staged for kMaxBits whatever the precision, so a plan's size
// depends on its shape only.
struct Layout {
  int span, ncols;         // staged columns a row; rows x span
  int a_slot, w_slot;      // words of one ring stage (narrow: no w ring)
  int a_ring, w_ring;      // offsets of the rings
  int a_pitch, w_pitch;    // words a staged pixel / a weight row (u8)
  int row_bytes;           // narrow: bytes of one dense row of codes
  int a_tile, w_tile;      // words of one u8 buffer
  int a_u8, w_u8;          // offsets of the u8 buffers
  int words;               // total
};

__host__ __device__ inline int stride_pad(int stride) {
  return stride % 4 == 0 ? 1 : stride % 2 == 0 ? 2 : 4;
}

// Wide: `stages` ring stages of activation and weight planes, then two
// buffers each of the staged pixels' u8 codes and of the weight tile.
// Narrow: `stages` ring stages of activation planes, two buffers of the
// dense rows of codes (each with 64 bytes for the groups that read past
// its last row), and the weights of `kh_rows` kernel rows, kept for the
// whole block.
__host__ __device__ inline Layout layout(int variant, int tw, int tr, int ks,
                                         int groups, int stride, int kw_sz,
                                         int c, int kh_rows, int stages) {
  Layout l;
  l.span = (tw - 1) * stride + kw_sz;
  l.ncols = tr * l.span;
  int w_tiles;
  if (variant == kWide) {
    l.a_slot = round4(kMaxBits * l.ncols * ks);
    l.w_slot = round4(kMaxBits * kBN * ks);
    l.a_pitch = 8 * ks + stride_pad(stride);
    l.w_pitch = 8 * ks + 4;
    l.row_bytes = 0;
    l.a_tile = round4(l.ncols * l.a_pitch);
    l.w_tile = round4(kBN * l.w_pitch);
    w_tiles = 2 * l.w_tile;
  } else {
    l.a_slot = round4(kMaxBits * l.ncols);
    l.w_slot = 0;
    l.a_pitch = 0;
    l.w_pitch = 8 * groups + 4;
    l.row_bytes = (l.span * c + 15) & ~15;
    l.a_tile = round4((tr * l.row_bytes + 64) / 4);
    l.w_tile = round4(kBN * l.w_pitch);
    w_tiles = kh_rows * l.w_tile;
  }
  l.a_ring = 0;
  l.w_ring = l.a_ring + stages * l.a_slot;
  l.a_u8 = l.w_ring + stages * l.w_slot;
  l.w_u8 = l.a_u8 + 2 * l.a_tile;
  l.words = l.w_u8 + w_tiles;
  return l;
}

struct Geo {
  int n_oh, rows, hp, oh, ow, wp, cw, c, o, kh_sz, kw_sz, stride;
  int a_bits, w_bits;
  int tw, tr, ks, groups, steps, split_pairs, stages, ow_tiles, m_tiles;
  int vec_a, vec_w;
  bool atomic;
};

// The output pixel of tile slot p (row lr < tr, column lc < tw): false if
// it lies past the tile's rows, N*OH or OW.
__device__ __forceinline__ bool slot_pixel(const Geo& g, int p, int r0,
                                           int ow0, int& lr, int& lc) {
  lr = p / g.tw;
  lc = p - lr * g.tw;
  return lr < g.tr && r0 + lr < g.n_oh && ow0 + lc < g.ow;
}

// Wide variant: stages activation words [w0, w0 + ks) of kernel row kh for
// the tile's rows into dst[b][lr * span + col][ks]; words past CW read
// zero. Columns past Wp and rows past N*OH are not copied: they reach only
// pixels that are never stored.
__device__ __forceinline__ void stage_act(uint32_t* dst,
                                          const uint32_t* __restrict__ pa,
                                          const Geo& g, const Layout& l,
                                          int r0, int c0, int kh, int w0,
                                          int tid) {
  const int per_col = g.ks >> g.vec_a;
  const int units = l.ncols * per_col;
  const int64_t plane = int64_t(g.rows) * g.wp * g.cw;
  const int stride_b = l.ncols * g.ks;
  for (int u = tid; u < units; u += kThreads) {
    const int col = u / per_col;
    const int w = (u - col * per_col) << g.vec_a;
    const int lr = col / l.span, cc = col - lr * l.span;
    const int r = r0 + lr;
    if (r >= g.n_oh || c0 + cc >= g.wp) continue;
    const int img = r / g.oh, y = r - img * g.oh;
    const int64_t in_row = int64_t(img) * g.hp + int64_t(y) * g.stride + kh;
    const int valid = max(0, min(1 << g.vec_a, g.cw - (w0 + w)));
    const uint32_t* s = pa + (in_row * g.wp + c0 + cc) * g.cw + w0 + w;
    uint32_t* d = dst + col * g.ks + w;
#pragma unroll
    for (int b = 0; b < kMaxBits; ++b) {
      if (b < g.a_bits)
        cp_async(d + b * stride_b, valid ? s + b * plane : pa, g.vec_a, valid);
    }
  }
}

// Wide variant: stages weight words [w0, w0 + ks) of (kh, kw) for channels
// o0.. into dst[b][n][ks]; words past CW read zero. Channels past O are not
// copied.
__device__ __forceinline__ void stage_wgt(uint32_t* dst,
                                          const uint32_t* __restrict__ pw,
                                          const Geo& g, int o0, int kh,
                                          int kwi, int w0, int tid) {
  const int per_row = g.ks >> g.vec_w;
  const int units = min(kBN, g.o - o0) * per_row;
  const int64_t plane = int64_t(g.o) * g.kw_sz * g.cw;
  const int stride_b = kBN * g.ks;
  const uint32_t* base = pw + int64_t(kh) * g.w_bits * plane + w0;
  for (int u = tid; u < units; u += kThreads) {
    const int n = u / per_row;
    const int w = (u - n * per_row) << g.vec_w;
    const int valid = max(0, min(1 << g.vec_w, g.cw - (w0 + w)));
    const uint32_t* s = base + (int64_t(o0 + n) * g.kw_sz + kwi) * g.cw + w;
    uint32_t* d = dst + n * g.ks + w;
#pragma unroll
    for (int b = 0; b < kMaxBits; ++b) {
      if (b < g.w_bits)
        cp_async(d + b * stride_b, valid ? s + b * plane : pw, g.vec_w, valid);
    }
  }
}

// Eight code words to dst at a pitch that keeps 16, 8 or 4 bytes aligned.
__device__ __forceinline__ void store8_pitch(uint32_t* dst,
                                             const uint32_t (&x)[8],
                                             int pad) {
  if (pad == 4) {
    store8(dst, x);
  } else if (pad == 2) {
#pragma unroll
    for (int q = 0; q < 8; q += 2)
      reinterpret_cast<uint2*>(dst)[q / 2] = make_uint2(x[q], x[q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) dst[q] = x[q];
  }
}

// The codes of channels 0..c-1 from planes_to_u8's words (channel q + 8i
// in byte i of word q) to d[0..c-1], in channel order.
__device__ __forceinline__ void store_codes(uint8_t* d,
                                            const uint32_t (&x)[8], int c) {
  if (c <= 8) {  // one byte of each word
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < c) d[q] = static_cast<uint8_t>(x[q]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q + 8 * i < c) d[q + 8 * i] = static_cast<uint8_t>(x[q] >> (8 * i));
    }
  }
}

// Accumulators -> P. Slot rows past the tile and channels past O are not
// stored; on the split path the blocks add their sums with atomics.
__device__ __forceinline__ void store_tile(uint32_t* __restrict__ out,
                                           const Geo& g,
                                           const int (&acc)[kMT][kNT][4],
                                           int r0, int ow0, int o0, int wm,
                                           int wn, int gq, int t) {
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int lr, lc;
      const int p = (wm * kMT + i) * 16 + gq + 8 * h;
      if (!slot_pixel(g, p, r0, ow0, lr, lc)) continue;
      uint32_t* row = out + (int64_t(r0 + lr) * g.ow + ow0 + lc) * g.o;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = o0 + (wn * kNT + j) * 8 + 2 * t;
        const uint32_t v0 = static_cast<uint32_t>(acc[i][j][2 * h]);
        const uint32_t v1 = static_cast<uint32_t>(acc[i][j][2 * h + 1]);
        if (g.atomic) {
          if (col < g.o) atomicAdd(row + col, v0);
          if (col + 1 < g.o) atomicAdd(row + col + 1, v1);
        } else if (col + 1 < g.o && !(g.o & 1)) {
          *reinterpret_cast<uint2*>(row + col) = make_uint2(v0, v1);
        } else {
          if (col < g.o) row[col] = v0;
          if (col + 1 < g.o) row[col + 1] = v1;
        }
      }
    }
  }
}

// Wide variant: pipeline units (kh, step, kw) over the split's (kh, step)
// pairs; a pair's activations are staged and rebuilt at its kw = 0.
__global__ void __launch_bounds__(kThreads, 2)
conv2d_fused_wide_kernel(const uint32_t* __restrict__ pa,
                         const uint32_t* __restrict__ pw,
                         uint32_t* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout l =
      layout(kWide, g.tw, g.tr, g.ks, 0, g.stride, g.kw_sz, g.c, 0, kStages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp / kWN, wn = warp % kWN;
  const int rt = blockIdx.x / g.ow_tiles;
  const int r0 = rt * g.tr, ow0 = (blockIdx.x - rt * g.ow_tiles) * g.tw;
  const int c0 = ow0 * g.stride, o0 = blockIdx.y * kBN;
  const int pairs = g.kh_sz * g.steps;
  const int q_lo = blockIdx.z * g.split_pairs;
  const int units = (min(pairs, q_lo + g.split_pairs) - q_lo) * g.kw_sz;
  uint32_t* const a8 = smem + l.a_u8;
  uint32_t* const w8 = smem + l.w_u8;
  const int pad = stride_pad(g.stride);

  // Each lane's fragment rows: tile slots g and g + 8 of its m16 tiles, as
  // offsets of their staged pixel at kw = 0 (slots past the tile read
  // column 0: their outputs are never stored).
  int a_off[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int lr, lc;
      const int p = (wm * kMT + i) * 16 + gq + 8 * h;
      const bool in = slot_pixel(g, p, r0, ow0, lr, lc);
      a_off[i][h] = (in ? lr * l.span + lc * g.stride : 0) * l.a_pitch + t;
    }
  }

  auto load = [&](int u) {
    const int q = q_lo + u / g.kw_sz, kwi = u % g.kw_sz;
    const int kh = q / g.steps, w0 = (q - kh * g.steps) * g.ks;
    if (kwi == 0)
      stage_act(smem + l.a_ring + (u / g.kw_sz % kStages) * l.a_slot, pa, g,
                l, r0, c0, kh, w0, tid);
    stage_wgt(smem + l.w_ring + (u % kStages) * l.w_slot, pw, g, o0, kh, kwi,
              w0, tid);
  };

  // Unit u's planes -> its u8 tiles: the weights into buffer u % 2, and at
  // kw = 0 the pair's activations into buffer (u / KW) % 2. A thread
  // rebuilds two units at a time, so the two transposes' chains interleave
  // (5-8% on the wide rows, measured on the H100).
  auto convert = [&](int u) {
    const int pq = u / g.kw_sz;
    if (u - pq * g.kw_sz == 0) {
      const uint32_t* st = smem + l.a_ring + (pq % kStages) * l.a_slot;
      uint32_t* dst = a8 + (pq & 1) * l.a_tile;
      const int n_units = l.ncols * g.ks;
      for (int v = tid; v < n_units; v += 2 * kThreads) {
        uint32_t x[8], y[8];
        const int v2 = v + kThreads;
        planes_to_u8(st + v, n_units, g.a_bits, x);
        if (v2 < n_units) planes_to_u8(st + v2, n_units, g.a_bits, y);
        const int col = v / g.ks;
        store8_pitch(dst + col * l.a_pitch + (v - col * g.ks) * 8, x, pad);
        if (v2 < n_units) {
          const int col2 = v2 / g.ks;
          store8_pitch(dst + col2 * l.a_pitch + (v2 - col2 * g.ks) * 8, y,
                       pad);
        }
      }
    }
    const uint32_t* st = smem + l.w_ring + (u % kStages) * l.w_slot;
    uint32_t* dst = w8 + (u & 1) * l.w_tile;
    const int n_units = min(kBN, g.o - o0) * g.ks;
    for (int v = tid; v < n_units; v += 2 * kThreads) {
      uint32_t x[8], y[8];
      const int v2 = v + kThreads;
      planes_to_u8(st + v, kBN * g.ks, g.w_bits, x);
      if (v2 < n_units) planes_to_u8(st + v2, kBN * g.ks, g.w_bits, y);
      const int n = v / g.ks;
      store8(dst + n * l.w_pitch + (v - n * g.ks) * 8, x);
      if (v2 < n_units) {
        const int n2 = v2 / g.ks;
        store8(dst + n2 * l.w_pitch + (v2 - n2 * g.ks) * 8, y);
      }
    }
  };

  // One barrier a unit: after it, unit u's tiles are converted, unit u + 1's
  // copies are in and unit u - 1's mma is done. Then the block stages unit
  // u + 2, converts unit u + 1 and multiplies unit u, so the warps' integer
  // work, copies and mma overlap.
  int acc[kMT][kNT][4] = {};
  load(0);
  cp_async_commit();
  if (units > 1) load(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  convert(0);
  for (int u = 0; u < units; ++u) {
    cp_async_wait<0>();
    __syncthreads();
    if (u + 2 < units) load(u + 2);
    cp_async_commit();
    if (u + 1 < units) convert(u + 1);
    const int kwi = u % g.kw_sz;
    const uint32_t* a_kw = a8 + (u / g.kw_sz & 1) * l.a_tile + kwi * l.a_pitch;
    const uint32_t* w_u = w8 + (u & 1) * l.w_tile;
#pragma unroll
    for (int w = 0; w < kMaxKS; ++w) {
      if (w >= g.ks) break;
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint32_t* p0 = a_kw + a_off[i][0] + w * 8;
        const uint32_t* p1 = a_kw + a_off[i][1] + w * 8;
        af[i][0] = p0[0];
        af[i][1] = p1[0];
        af[i][2] = p0[4];
        af[i][3] = p1[4];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t* p =
            w_u + ((wn * kNT + j) * 8 + gq) * l.w_pitch + w * 8 + t;
        bf[j][0] = p[0];
        bf[j][1] = p[4];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_u8(acc[i][j], af[i], bf[j]);
      }
    }
  }
  store_tile(out, g, acc, r0, ow0, o0, wm, wn, gq, t);
}

// Narrow variant: stages the planes of one kernel row of the tile's rows
// (one word a pixel) into dst[b][lr * span + col]. Rows past N*OH and
// columns past Wp are not copied.
__device__ __forceinline__ void stage_rows(uint32_t* dst,
                                           const uint32_t* __restrict__ pa,
                                           const Geo& g, const Layout& l,
                                           int r0, int c0, int kh, int tid) {
  const int64_t plane = int64_t(g.rows) * g.wp;
  const int cols = min(l.span, g.wp - c0);
  for (int lr = 0; lr < g.tr && r0 + lr < g.n_oh; ++lr) {
    const int r = r0 + lr, img = r / g.oh;
    const int64_t in_row =
        int64_t(img) * g.hp + int64_t(r - img * g.oh) * g.stride + kh;
    const uint32_t* s = pa + in_row * g.wp + c0;
    uint32_t* d = dst + lr * l.span;
    for (int cc = tid; cc < cols; cc += kThreads) {
#pragma unroll
      for (int b = 0; b < kMaxBits; ++b) {
        if (b < g.a_bits) cp_async(d + b * l.ncols + cc, s + b * plane + cc, 0, 1);
      }
    }
  }
}

// Narrow variant (C < 32, CW = 1). A block first rebuilds the weights of
// its split's kernel rows for its 64 channels, once, in (kw, c) byte order;
// then it walks its output tiles (blockIdx.x, + gridDim.x, ...) and, for
// each, the kernel rows: a pipeline unit stages one kernel row of the
// tile's input rows, rebuilds their codes densely (C bytes a column) and
// runs the row's 32-byte K groups. The ring runs across tiles, and a tile's
// P is stored after its last kernel row.
__global__ void __launch_bounds__(kThreads, 2)
conv2d_fused_narrow_kernel(const uint32_t* __restrict__ pa,
                           const uint32_t* __restrict__ pw,
                           uint32_t* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout l = layout(kNarrow, g.tw, g.tr, 1, g.groups, g.stride,
                          g.kw_sz, g.c, g.split_pairs, g.stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp / kWN, wn = warp % kWN;
  const int o0 = blockIdx.y * kBN;
  const int kh_lo = blockIdx.z * g.split_pairs;
  const int khn = min(g.kh_sz, kh_lo + g.split_pairs) - kh_lo;
  const int tiles = (g.m_tiles - int(blockIdx.x) + int(gridDim.x) - 1)
                    / int(gridDim.x);
  const int units = tiles * khn;
  uint32_t* const rows8 = smem + l.a_u8;
  uint8_t* const rows_b = reinterpret_cast<uint8_t*>(rows8);
  uint32_t* const w8 = smem + l.w_u8;
  uint8_t* const w_b = reinterpret_cast<uint8_t*>(w8);
  const int n_real = min(kBN, g.o - o0);

  auto tile_of = [&](int u, int& r0, int& ow0) {
    const int mt = int(blockIdx.x) + (u / khn) * int(gridDim.x);
    const int rt = mt / g.ow_tiles;
    r0 = rt * g.tr;
    ow0 = (mt - rt * g.ow_tiles) * g.tw;
  };
  auto load = [&](int u) {
    int r0, ow0;
    tile_of(u, r0, ow0);
    stage_rows(smem + l.a_ring + (u % g.stages) * l.a_slot, pa, g, l, r0,
               ow0 * g.stride, kh_lo + u % khn, tid);
  };
  // Unit u's planes -> the dense rows of buffer u % 2.
  auto convert = [&](int u) {
    const uint32_t* st = smem + l.a_ring + (u % g.stages) * l.a_slot;
    uint8_t* dst = rows_b + (u & 1) * l.a_tile * 4;
    for (int v = tid; v < l.ncols; v += kThreads) {
      uint32_t x[8];
      planes_to_u8(st + v, l.ncols, g.a_bits, x);
      const int lr = v / l.span;
      store_codes(dst + lr * l.row_bytes + (v - lr * l.span) * g.c, x, g.c);
    }
  };

  // The first units' copies fly while the weights are rebuilt.
  for (int s = 0; s < g.stages; ++s) {
    if (s < units) load(s);
    cp_async_commit();
  }
  // The split's weights: bytes past KW*C stay zero, as do channels past O.
  for (int v = tid; v < khn * l.w_tile; v += kThreads) w8[v] = 0;
  __syncthreads();
  {
    const int plane = g.o * g.kw_sz;  // pw words a plane, CW = 1
    for (int v = tid; v < khn * n_real * g.kw_sz; v += kThreads) {
      const int nk = v / g.kw_sz, kwi = v - nk * g.kw_sz;
      const int khi = nk / n_real, n = nk - khi * n_real;
      uint32_t x[8];
      planes_to_u8(pw + (int64_t(kh_lo + khi) * g.w_bits * g.o + o0 + n)
                            * g.kw_sz + kwi,
                   plane, g.w_bits, x);
      store_codes(w_b + (khi * l.w_tile + n * l.w_pitch) * 4 + kwi * g.c, x,
                  g.c);
    }
  }

  // Each lane's fragment rows as byte offsets of their patches; slots past
  // the tile's rows read row 0, and slots past N*OH or OW read what their
  // columns hold: their outputs are never stored.
  int a_off[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm * kMT + i) * 16 + gq + 8 * h;
      const int lr = p / g.tw, lc = p - lr * g.tw;
      a_off[i][h] = lr < g.tr ? lr * l.row_bytes + lc * g.stride * g.c : 0;
    }
  }

  // One barrier a unit, as in the wide kernel: after it, unit u's rows are
  // rebuilt and unit u + 1's copies are in; the block stages unit u +
  // stages, rebuilds unit u + 1 and multiplies unit u.
  int acc[kMT][kNT][4] = {};
  if (g.stages == 3) {
    cp_async_wait<2>();
  } else {
    cp_async_wait<1>();
  }
  __syncthreads();  // also: the weights are in
  convert(0);
  for (int u = 0; u < units; ++u) {
    if (g.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (u + g.stages < units) load(u + g.stages);
    cp_async_commit();
    if (u + 1 < units) convert(u + 1);
    const int khi = u % khn;
    const uint32_t* rows = rows8 + (u & 1) * l.a_tile;
    const uint32_t* wk = w8 + khi * l.w_tile;
    for (int gi = 0; gi < g.groups; ++gi) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // a0, a1: bytes 4t.. of rows g, g + 8; a2, a3: bytes 16 + 4t..
          const int off = a_off[i][r & 1] + 32 * gi + 16 * (r >> 1) + 4 * t;
          const uint32_t* s = rows + (off >> 2);
          af[i][r] = __funnelshift_r(s[0], s[1], 8 * (off & 3));
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t* p =
            wk + ((wn * kNT + j) * 8 + gq) * l.w_pitch + gi * 8 + t;
        bf[j][0] = p[0];
        bf[j][1] = p[4];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_u8(acc[i][j], af[i], bf[j]);
      }
    }
    if (khi == khn - 1) {
      int r0, ow0;
      tile_of(u, r0, ow0);
      store_tile(out, g, acc, r0, ow0, o0, wm, wn, gq, t);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
        }
      }
    }
  }
}

int plan_bytes(int variant, int tw, int tr, int ks, int stride, int kw_sz,
               int c, int split_pairs, int stages) {
  const int groups = (kw_sz * c + 31) / 32;
  return 4 * layout(variant, tw, tr, ks, groups, stride, kw_sz, c,
                    split_pairs, stages).words;
}

}  // namespace

// The tile geometry into geometry[0..5]: output pixels and channels a
// block, the wide variant's ring stages, the narrow variant's most, the
// most words a block sums, and the shared memory a block may take.
REPRO_EXPORT int repro_conv2d_fused_tile(int* geometry) {
  geometry[0] = kBM;
  geometry[1] = kBN;
  geometry[2] = kStages;
  geometry[3] = kMaxStages;
  geometry[4] = kSlabWords;
  geometry[5] = kSmemLimit;
  return 0;
}

// Shared memory bytes of a plan at a conv's stride, KW and C.
REPRO_EXPORT int repro_conv2d_fused_smem(int variant, int tw, int tr, int ks,
                                         int split_pairs, int stages,
                                         int stride, int kw_sz, int c) {
  return plan_bytes(variant, tw, tr, ks, stride, kw_sz, c, split_pairs,
                    stages);
}

// Rejects (cudaErrorInvalidValue) a plan that does not tile the output,
// whose splits do not tile K or sum past a slab, or past kSmemLimit.
REPRO_EXPORT int repro_conv2d_fused(const void* pa, const void* pw, void* out,
                                    int n_oh, int rows, int hp, int oh, int ow,
                                    int wp, int cw, int c, int o, int kh_sz,
                                    int kw_sz, int stride, int a_bits,
                                    int w_bits, int variant, int tw, int tr,
                                    int ks, int split_pairs, int splits,
                                    int stages, int m_blocks, void* stream) {
  const bool narrow = variant == kNarrow;
  if ((variant != kWide && !narrow) || tw < 1 || tr < 1 || tw * tr > kBM ||
      c < 1 || c > 32 * cw || (narrow && (cw != 1 || c >= 32)) ||
      (!narrow && (ks < 1 || ks > kMaxKS || stages != kStages)) ||
      (narrow && (stages < 2 || stages > kMaxStages)) || split_pairs < 1 ||
      splits < 1 || kh_sz < 1 || kw_sz < 1 || stride < 1 || a_bits < 1 ||
      a_bits > kMaxBits || w_bits < 1 || w_bits > kMaxBits || m_blocks < 1)
    return int(cudaErrorInvalidValue);
  Geo g;
  g.n_oh = n_oh, g.rows = rows, g.hp = hp, g.oh = oh, g.ow = ow, g.wp = wp;
  g.cw = cw, g.c = c, g.o = o, g.kh_sz = kh_sz, g.kw_sz = kw_sz;
  g.stride = stride, g.a_bits = a_bits, g.w_bits = w_bits;
  g.tw = tw, g.tr = tr, g.ks = narrow ? 1 : ks;
  g.groups = (kw_sz * c + 31) / 32;
  g.steps = narrow ? 1 : (cw + ks - 1) / ks;
  g.split_pairs = split_pairs, g.stages = stages;
  g.ow_tiles = (ow + tw - 1) / tw;
  const int64_t m_tiles = int64_t((n_oh + tr - 1) / tr) * g.ow_tiles;
  g.m_tiles = int(m_tiles);
  const int pairs = kh_sz * g.steps;
  const int64_t words =
      int64_t(split_pairs) * (narrow ? g.groups : kw_sz * g.ks);
  // The wide kernel takes one output tile a block, the narrow one walks
  // m_blocks of them at a stride.
  if (words > kSlabWords || int64_t(splits - 1) * split_pairs >= pairs ||
      int64_t(splits) * split_pairs < pairs || m_tiles > 0x7fffffff ||
      (!narrow && m_blocks != m_tiles) || m_blocks > m_tiles)
    return int(cudaErrorInvalidValue);
  const int smem = plan_bytes(variant, tw, tr, g.ks, stride, kw_sz, c,
                              split_pairs, stages);
  const int grid_y = (o + kBN - 1) / kBN;
  if (smem > kSmemLimit || grid_y > 65535 || splits > 65535)
    return int(cudaErrorInvalidValue);
  // Copies of 4, 2 or 1 words: within a step (ks words) and a pixel's CW.
  g.vec_a = copy_shift(pa, cw, g.ks & -g.ks);
  g.vec_w = copy_shift(pw, cw, g.ks & -g.ks);
  g.atomic = splits > 1;

  const auto kernel = narrow ? conv2d_fused_narrow_kernel
                             : conv2d_fused_wide_kernel;
  static bool configured[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices || !configured[variant][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return int(err);
    if (dev < kMaxDevices) configured[variant][dev] = true;
  }
  if (g.atomic) {  // the splits add into P
    err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * size_t(n_oh) * ow * o,
                          static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(unsigned(m_blocks), grid_y, splits);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(pw),
      static_cast<uint32_t*>(out), g);
  return int(cudaGetLastError());
}
