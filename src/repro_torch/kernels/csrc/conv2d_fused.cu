// Fused implicit-im2col bit-serial convolution (paper Eq. 1 over patches).
//
// Replaces: src/repro/kernels/conv2d_fused.py::conv2d_bitserial_fused
// (Pallas; body _kernel). pa (a_bits, N*Hp, Wp, CW) channel-packed
// activation planes of the zero-code-padded input, pw (KH, w_bits, O, KW, CW)
// = PackedConvWeight.fused_planes -> P (N*OH, OW, O) int32. The
// (N*OH*OW, KH*KW*C) patch matrix never exists.
//
// Bound on the H100. The conv is N*OH*OW*O*KH*KW*C multiply-adds of codes
// of at most 8 bits, which the int8 tensor cores run at 1,979 TOP/s (H100
// SXM data sheet); its least time is the larger of that and the bytes moved
// (planes in, P out, at 3.35 TB/s), and at the shapes that chip_smoke.py
// times the bytes are the larger. This kernel runs N*OH*OW*O*KH*KW*CW*
// a_bits*w_bits AND+POPC pairs on the CUDA cores, where __popc issues at 16
// per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
// throughput, compute capability 9.0): that rate is what holds this design
// back (and a word holds only C lanes when C < 32, as at the stem). Its
// input planes are KH*KW/stride^2 times smaller than the patch matrix the
// im2col path would write and read.
//
// Design: one block per (output row n*OH + oh, 64 output channels), 256
// threads over (ow, o): consecutive threads take consecutive channels, and
// each thread keeps 8 output positions of a 32-wide ow chunk in registers.
// For each kernel row kh the block stages input row n*Hp + oh*stride + kh
// (every activation plane, only the columns the chunk reads) in shared
// memory; for each kernel column kw it stages the w_bits weight planes of
// its channels, and output ow reads word column kw + ow*stride of the row —
// that index arithmetic is the whole implicit im2col. Channel tiles past O
// read zero weight words and are not stored, in place of the Pallas
// kernel's O padding (_pad_o_blocks). The sum is uint32 (mod 2^32, like the
// reference's int32 wrap) stored as int32 bits.
#include "common.cuh"

namespace {

constexpr int kBO = 64;              // output channels per block
constexpr int kLanesOW = 4;          // 256 threads = kLanesOW x kBO
constexpr int kTOW = 8;              // output positions per thread per chunk
constexpr int kChunkOW = kLanesOW * kTOW;
constexpr int kThreads = kLanesOW * kBO;
constexpr int kWPitch = kBO + 1;     // w_s row pitch (staging bank spread)

__global__ void __launch_bounds__(kThreads)
conv2d_fused_kernel(const uint32_t* __restrict__ pa,
                    const uint32_t* __restrict__ pw,
                    uint32_t* __restrict__ out, int rows, int hp, int oh,
                    int ow, int wp, int cw, int o, int kh_sz, int kw_sz,
                    int stride, int a_bits, int w_bits) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int ol = tid % kBO, lane_ow = tid / kBO;
  const int r = blockIdx.x;  // n * OH + oh
  const int o0 = blockIdx.y * kBO;
  const int img = r / oh, y = r % oh;
  const int span_max = min(wp, (kChunkOW - 1) * stride + kw_sz);
  uint32_t* in_s = smem;                              // [a_bits][span][cw]
  uint32_t* w_s = smem + a_bits * span_max * cw;      // [w_bits][cw][kWPitch]

  for (int ow0 = 0; ow0 < ow; ow0 += kChunkOW) {
    const int c0 = ow0 * stride;
    const int span = min(wp - c0, span_max);
    uint32_t acc[kTOW] = {};
    for (int kh = 0; kh < kh_sz; ++kh) {
      __syncthreads();  // the previous step's readers are done with in_s, w_s
      const int64_t in_row = int64_t(img) * hp + int64_t(y) * stride + kh;
      for (int x = 0; x < a_bits; ++x) {
        const uint32_t* src = pa + ((int64_t(x) * rows + in_row) * wp + c0) * cw;
        for (int t = tid; t < span * cw; t += kThreads)
          in_s[x * span_max * cw + t] = src[t];
      }
      for (int kw = 0; kw < kw_sz; ++kw) {
        if (kw) __syncthreads();  // readers are done with w_s
        for (int yb = 0; yb < w_bits; ++yb) {
          for (int t = tid; t < kBO * cw; t += kThreads) {
            const int oc = t / cw, c = t % cw;
            const int och = o0 + oc;
            w_s[(yb * cw + c) * kWPitch + oc] =
                och < o ? pw[(((int64_t(kh) * w_bits + yb) * o + och) * kw_sz + kw)
                             * cw + c]
                        : 0u;
          }
        }
        __syncthreads();
        for (int c = 0; c < cw; ++c) {
          uint32_t wv[kMaxBits];
#pragma unroll
          for (int yb = 0; yb < kMaxBits; ++yb)
            if (yb < w_bits) wv[yb] = w_s[(yb * cw + c) * kWPitch + ol];
#pragma unroll
          for (int i = 0; i < kTOW; ++i) {
            const int oww = ow0 + lane_ow + i * kLanesOW;
            if (oww >= ow) break;
            const int col = oww * stride + kw - c0;
#pragma unroll
            for (int x = 0; x < kMaxBits; ++x) {
              if (x < a_bits) {
                const uint32_t a = in_s[(x * span_max + col) * cw + c];
#pragma unroll
                for (int yb = 0; yb < kMaxBits; ++yb)
                  if (yb < w_bits)
                    acc[i] += uint32_t(__popc(a & wv[yb])) << (x + yb);
              }
            }
          }
        }
      }
    }
    const int och = o0 + ol;
#pragma unroll
    for (int i = 0; i < kTOW; ++i) {
      const int oww = ow0 + lane_ow + i * kLanesOW;
      if (oww < ow && och < o) out[(int64_t(r) * ow + oww) * o + och] = acc[i];
    }
  }
}

}  // namespace

REPRO_EXPORT int repro_conv2d_fused(const void* pa, const void* pw, void* out,
                                    int n_oh, int rows, int hp, int oh, int ow,
                                    int wp, int cw, int o, int kh_sz, int kw_sz,
                                    int stride, int a_bits, int w_bits,
                                    void* stream) {
  const int span_max = min(wp, (kChunkOW - 1) * stride + kw_sz);
  const int smem = int(sizeof(uint32_t))
                   * (a_bits * span_max * cw + w_bits * cw * kWPitch);
  // Dynamic shared memory above 48 KB must be allowed first; the allowance
  // is raised only when a launch needs more than any launch before (the
  // port drives one device per process). The runtime refuses a size above
  // the card's limit: that error is cleared and returned like a launch's.
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv2d_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return int(err);
    }
    smem_allowed = smem;
  }
  const dim3 grid(n_oh, (o + kBO - 1) / kBO);
  conv2d_fused_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(pw),
      static_cast<uint32_t*>(out), rows, hp, oh, ow, wp, cw, o, kh_sz, kw_sz,
      stride, a_bits, w_bits);
  return int(cudaGetLastError());
}
