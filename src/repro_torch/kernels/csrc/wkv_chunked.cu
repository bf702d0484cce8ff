// Chunked RWKV-6 WKV: the linear recurrence of the rwkv time-mix, L tokens
// at a time.
//
// Replaces: src/repro/kernels/rwkv_chunk.py::wkv_chunked (Pallas; body
// _kernel). r, k, v, lw (BH, S, D) float32, lw the clamped log decay <= 0;
// u (BH, D); s0 (BH, D, D) -> y (BH, S, D), s_final (BH, D, D) float32.
// Per chunk of L tokens, with P the inclusive cumsum of lw over the chunk:
//   r~ = r e^{P - lw},  k~ = k e^{-P},  A = strict_lower(r~ k~^T)  (L, L)
//   y  = r~ S + A v + (sum_d r u k) v
//   S <- diag(e^{P_L}) S + (k e^{P_L - P})^T v
// the algebra of repro.models.lm.rwkv6._chunked_wkv, kept as it is so that
// the kernel and its plain version round alike (k e^{-P} reaches e^80 at
// L = 16; build without fast math, since __expf would move y).
//
// Bound on the H100: memory. It reads r, k, v, lw, u and s0 once and writes
// y and s_final once (one 256-token prefill of rwkv6-3b, BH = 40, D = 64:
// about 14 MB, 4.3 us at 3.35 TB/s); its float32 work is about 0.29 MFLOP
// per chunk and head (2.8 us for the same prefill at 67 TFLOP/s).
//
// Design: the TPU kernel walks the chunks as a sequential grid axis with the
// (D, D) state in VMEM scratch. Blocks on Hopper run in no order, so here
// one block owns one (b*h) row and a slice of `cols` state columns, and
// loops over the chunks itself with its (D, cols) slice of the state in
// shared memory; s_final is written once at the end. The columns of S and
// y are independent, so a head splits over D / cols blocks (160 blocks for
// a batch-1 prefill of rwkv6-3b on 132 SMs), each recomputing the small A.
// Per chunk the block stages one (L, D) tile each of r, k and lw and the
// (L, cols) tile of v; the (L, D) tiles are padded to D + 1 words a row so
// that the row-strided reads of A's dot products miss no bank.
#include "common.cuh"

constexpr int kMaxL = 32;
constexpr int kMaxD = 64;
constexpr int kLd = kMaxD + 1;       // padded row of an (L, D) tile
constexpr int kCols = 16;            // state columns per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) wkv_chunked_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_out, int seq, int d,
    int L) {
  __shared__ float rt[kMaxL * kLd];  // r, then r~ = r e^{P - lw}
  __shared__ float kr[kMaxL * kLd];  // k, then k e^{P_L - P}
  __shared__ float pk[kMaxL * kLd];  // lw, then P, then k~ = k e^{-P}
  __shared__ float vs[kMaxL * kCols];
  __shared__ float st[kMaxD * kCols];
  __shared__ float a[kMaxL * kMaxL];
  __shared__ float bonus[kMaxL];
  __shared__ float plast[kMaxD];
  __shared__ float us[kMaxD];

  const int tid = threadIdx.x;
  const int cols = min(kCols, d);
  const int c0 = blockIdx.y * cols;
  const int64_t head = blockIdx.x;
  const float* s_in = s0 + head * d * d;
  for (int i = tid; i < d * cols; i += kThreads)
    st[i] = s_in[(i / cols) * d + c0 + i % cols];
  for (int i = tid; i < d; i += kThreads) us[i] = u[head * d + i];

  for (int t0 = 0; t0 < seq; t0 += L) {
    const int64_t off = (head * seq + t0) * d;
    for (int i = tid; i < L * d; i += kThreads) {
      const int s = (i / d) * kLd + i % d;
      rt[s] = r[off + i];
      kr[s] = k[off + i];
      pk[s] = lw[off + i];
    }
    for (int i = tid; i < L * cols; i += kThreads)
      vs[i] = v[off + (i / cols) * d + c0 + i % cols];
    __syncthreads();

    // The u-bonus of each token, sum_d r u k, before r becomes r~.
    for (int t = tid; t < L; t += kThreads) {
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc += rt[t * kLd + e] * us[e] * kr[t * kLd + e];
      bonus[t] = acc;
    }
    __syncthreads();

    // One thread per channel: the inclusive cumsum P of the log decay.
    for (int e = tid; e < d; e += kThreads) {
      float p = 0.f;
      for (int t = 0; t < L; ++t) {
        const float l = pk[t * kLd + e];
        p += l;
        rt[t * kLd + e] *= expf(p - l);
        pk[t * kLd + e] = p;
      }
      plast[e] = p;
    }
    __syncthreads();

    for (int i = tid; i < L * d; i += kThreads) {
      const int s = (i / d) * kLd + i % d;
      const float p = pk[s], kv = kr[s];
      pk[s] = kv * expf(-p);
      kr[s] = kv * expf(plast[i % d] - p);
    }
    __syncthreads();

    // A[t, s] = r~_t . k~_s for s < t, else 0.
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, s = i % L;
      float acc = 0.f;
      if (s < t)
        for (int e = 0; e < d; ++e) acc += rt[t * kLd + e] * pk[s * kLd + e];
      a[i] = acc;
    }
    __syncthreads();

    for (int i = tid; i < L * cols; i += kThreads) {
      const int t = i / cols, j = i % cols;
      float carry = 0.f, intra = 0.f;
      for (int e = 0; e < d; ++e) carry += rt[t * kLd + e] * st[e * cols + j];
      for (int s = 0; s < L; ++s) intra += a[t * L + s] * vs[s * cols + j];
      y[off + t * d + c0 + j] = (carry + intra) + bonus[t] * vs[i];
    }
    __syncthreads();

    for (int i = tid; i < d * cols; i += kThreads) {
      const int e = i / cols, j = i % cols;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc += kr[s * kLd + e] * vs[s * cols + j];
      st[i] = expf(plast[e]) * st[i] + acc;
    }
    __syncthreads();
  }

  float* s_fin = s_out + head * d * d;
  for (int i = tid; i < d * cols; i += kThreads)
    s_fin[(i / cols) * d + c0 + i % cols] = st[i];
}

REPRO_EXPORT int repro_wkv_chunked(const void* r, const void* k,
                                   const void* v, const void* lw,
                                   const void* u, const void* s0, void* y,
                                   void* s_out, int bh, int seq, int d,
                                   int chunk, void* stream) {
  if (d > kMaxD || chunk > kMaxL) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(bh), unsigned(d / min(kCols, d)));
  wkv_chunked_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), seq, d, chunk);
  return int(cudaGetLastError());
}
