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
// the algebra of repro.models.lm.rwkv6._chunked_wkv (k e^{P_L - P} is
// formed as k~ e^{P_L}). k~ reaches e^80 at L = 16: float32 on the FMA
// units, built without fast math (__expf would move y).
//
// Bound on the H100: memory. It reads r, k, v, lw, u and s0 once and writes
// y and s_final once (a 256-token prefill of rwkv6-3b, BH = 40, D = 64:
// about 14 MB, 4.3 us at 3.35 TB/s); its float32 work is about 0.19 GFLOP
// for the same prefill (2.8 us at 67 TFLOP/s).
//
// Design: the TPU kernel walks the chunks as a sequential grid axis with the
// (D, D) state in VMEM. Only two things are sequential: S_{c+1} = diag(e^
// {P_L,c}) S_c + dS_c, which is elementwise in S, and the carry-in y_c +=
// r~_c S_c once S_c is known. The rest of a chunk (the cumsum, r~, k~,
// k e^{P_L - P}, A, the bonus, A v, dS_c = k_rem^T v) does not depend on
// the state. So a block of 512 threads owns one (b*h) row and a slice of
// `cols` state columns (columns of S and y are independent), keeps its
// (D, cols) slice of S in registers (a 4 x TJ tile a thread), and walks the
// sequence `tokens` at a time (several chunks), each step over all chunks
// of the batch at once:
//   1. the cumsum and exponentials, a thread per (chunk, channel, 8
//      tokens);
//   2. A' = A + diag(bonus): A in 4 x 4 tiles of the lower triangle (D
//      split over 2 lanes, summed by a shuffle), the bonus a thread per
//      token; and dS_c in 8 x 4 tiles;
//   3. the scan: each thread walks the chunks for its state tile, leaving
//      S_c where dS_c was;
//   4. y = r~ S_c + A' v in 4 x 4 tiles (D and the keys split over 2
//      lanes), stored as float4.
// Four barriers a batch. The next batch's r, k, lw and v tiles are staged
// with cp.async while this one runs. Inputs are read through a head and a
// token stride (D contiguous), so a (1, S, H, D) tensor seen as (H, S, D)
// is read in place; y is written through the same strides. A block of a
// head recomputes step 1 and A for its column slice; the launch plan
// (rwkv_chunk.py::_plan) trades that against filling the SMs when it
// picks `cols`. At one block an SM (its shared memory) the steps are
// latency-bound: clock64 timers put each at 2-4x its instruction count.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may take

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  long long hs, ts;  // head and token strides of r, k, v, lw and y
  int seq, d, cols, tokens;
};

// Shared memory in floats: two staging buffers of r, k, lw (rows of D + 4)
// and v (rows of cols + 4), then r u k of the batch, dS_c / S_c of each
// chunk of the batch, A' transposed (a row of L + 4 a key), e^{P_L} of each
// chunk, u.
struct Layout {
  int ldd, ldv, lda, k, lw, v, raw, bk, sbuf, a, decay, u, words;
};

__host__ __device__ inline Layout layout(int d, int cols, int tokens, int L) {
  Layout l;
  l.ldd = d + 4;
  l.ldv = cols + 4;
  l.lda = L + 4;
  l.k = tokens * l.ldd;
  l.lw = 2 * tokens * l.ldd;
  l.v = 3 * tokens * l.ldd;
  l.raw = l.v + tokens * l.ldv;
  l.bk = 2 * l.raw;
  l.sbuf = l.bk + tokens * l.ldd;
  l.a = l.sbuf + (tokens / L) * d * l.ldv;
  l.decay = l.a + tokens * l.lda;
  l.u = l.decay + (tokens / L) * d;
  l.words = l.u + d;
  return l;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Sums v over the `lanes` (1, 2 or 4) adjacent lanes of a group; every lane
// of the warp takes part.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = 1; off < lanes; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stages tokens t0 .. t0 + nt - 1 of the block's head: r, k, lw whole rows,
// v the block's columns, 16 bytes a copy (D / 4 and cols / 4 copies a row,
// powers of two).
__device__ __forceinline__ void stage(const Args& g, const Layout& lo,
                                      float* buf, int64_t head, int c0,
                                      int t0, int nt) {
  const int dshift = __ffs(g.d / 4) - 1, vshift = __ffs(g.cols / 4) - 1;
  const float* base[3] = {g.r + head * g.hs, g.k + head * g.hs,
                          g.lw + head * g.hs};
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    for (int i = threadIdx.x; i < nt << dshift; i += kThreads) {
      const int tok = i >> dshift, e = 4 * (i - (tok << dshift));
      cp_async16(buf + which * lo.k + tok * lo.ldd + e,
                 base[which] + (t0 + tok) * g.ts + e);
    }
  }
  const float* vb = g.v + head * g.hs + c0;
  for (int i = threadIdx.x; i < nt << vshift; i += kThreads) {
    const int tok = i >> vshift, j = 4 * (i - (tok << vshift));
    cp_async16(buf + lo.v + tok * lo.ldv + j, vb + (t0 + tok) * g.ts + j);
  }
}

template <int L, int TJ>
__global__ void __launch_bounds__(kThreads, 1) wkv_chunked_kernel(Args g) {
  extern __shared__ __align__(16) float sm[];
  const int d = g.d, cols = g.cols, T = g.tokens;
  const Layout lo = layout(d, cols, T, L);
  const int ncs = d / cols;
  const int64_t head = blockIdx.x / ncs;
  const int c0 = (blockIdx.x - int(head) * ncs) * cols;
  const int tid = threadIdx.x;
  float* bk = sm + lo.bk;
  float* sbuf = sm + lo.sbuf;
  float* at = sm + lo.a;     // A'[t][s] at at[(c L + s) lda + t]
  float* decay = sm + lo.decay;
  float* us = sm + lo.u;
  for (int e = tid; e < d; e += kThreads) us[e] = g.u[head * d + e];
  // Above the diagonal A' stays 0; step 2 writes the lower tiles only.
  for (int i = tid; i < T * lo.lda; i += kThreads) at[i] = 0.f;

  // This thread's tile of the state: rows e0 .. e0 + 3, columns j0 ..
  // j0 + TJ - 1 of the block's slice.
  const int jgroups = cols / TJ;
  const bool owner = tid < (d / 4) * jgroups;
  const int e0 = 4 * (tid / jgroups), j0 = TJ * (tid % jgroups);
  float st[4][TJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj)
      st[i][jj] = owner ? g.s0[(head * d + e0 + i) * d + c0 + j0 + jj] : 0.f;
  }

  const int nbatch = (g.seq + T - 1) / T;
  stage(g, lo, sm, head, c0, 0, min(T, g.seq));
  cp_async_commit();
  for (int b = 0; b < nbatch; ++b) {
    const int t0 = b * T, nt = min(T, g.seq - t0), nb = nt / L;
    float* buf = sm + (b & 1) * lo.raw;
    cp_async_wait_all();
    __syncthreads();  // the batch staged; every thread done with the last
    if (b + 1 < nbatch)
      stage(g, lo, sm + ((b + 1) & 1) * lo.raw, head, c0, t0 + T,
            min(T, g.seq - t0 - T));
    cp_async_commit();
    float* rs = buf;           // r, then r~
    float* ks = buf + lo.k;    // k, then k~
    float* ls = buf + lo.lw;   // lw, then k_rem = k~ e^{P_L}
    const float* vs = buf + lo.v;

    // 1. One thread per (chunk, channel, 8 tokens), one pass (nt * D / 8
    //    <= kThreads): the cumsum (each thread sums the chunk's L log
    //    decays itself, in order), r u k (the bonus terms), r~, k~, e^{P_L}
    //    and k_rem. The L / 8 threads of a (chunk, channel) are adjacent
    //    lanes: all read the log decays before any overwrites them with
    //    k_rem.
    {
      constexpr int kSplit = L / 8;
      const bool act = tid < nb * d * kSplit;
      const int h = tid % kSplit, ce = tid / kSplit;
      const int c = ce / d, e = ce - c * d;
      const int o0 = c * L * lo.ldd + e, oh = o0 + 8 * h * lo.ldd;
      float p = 0.f, p_end = 0.f, lv[8], rv[8], kv[8];
      if (act) {
#pragma unroll
        for (int t = 0; t < L; ++t) {
          p_end += ls[o0 + t * lo.ldd];
          if (t < 8 * h) p = p_end;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          lv[t] = ls[oh + t * lo.ldd];
          rv[t] = rs[oh + t * lo.ldd];
          kv[t] = ks[oh + t * lo.ldd];
        }
      }
      __syncwarp();
      if (act) {
        const float ue = us[e], dec = expf(p_end);
        if (h == kSplit - 1) decay[c * d + e] = dec;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int o = oh + t * lo.ldd;
          bk[o] = rv[t] * ue * kv[t];
          p += lv[t];
          rs[o] = rv[t] * expf(p - lv[t]);
          const float kt = kv[t] * expf(-p);
          ks[o] = kt;
          ls[o] = kt * dec;
        }
      }
    }
    __syncthreads();

    // 2a. A' of each chunk in 4 x 4 tiles (rows t, keys s) of the lower
    //     triangle, r~_t . k~_s for s < t and 0 above, D split over 2
    //     adjacent lanes; and the bonus sum_e r u k of each token on the
    //     diagonal, a thread per token.
    {
      constexpr int kN = L / 4, kTiles = kN * (kN + 1) / 2;
      const int n_tiles = nb * kTiles * 2;
      for (int i0 = 0; i0 < n_tiles + nt; i0 += kThreads) {
        const int it = i0 + tid;
        const bool act = it < n_tiles;
        const int es = it & 1, tile = it >> 1;
        const int c = tile / kTiles, k = tile - c * kTiles;
        int ti = 0;
        while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
        const int si = k - ti * (ti + 1) / 2;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
        }
        if (act) {
          const float* rrow = rs + (c * L + 4 * ti) * lo.ldd;
          const float* krow = ks + (c * L + 4 * si) * lo.ldd;
#pragma unroll 2
          for (int e = 4 * es; e < d; e += 8) {
            float4 x[4], y[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) x[r] = ld4(rrow + r * lo.ldd + e);
#pragma unroll
            for (int q = 0; q < 4; ++q) y[q] = ld4(krow + q * lo.ldd + e);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[r][q] = fmaf(x[r].x, y[q].x, acc[r][q]);
                acc[r][q] = fmaf(x[r].y, y[q].y, acc[r][q]);
                acc[r][q] = fmaf(x[r].z, y[q].z, acc[r][q]);
                acc[r][q] = fmaf(x[r].w, y[q].w, acc[r][q]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = group_sum(acc[r][q], 2);
        }
        if (act) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if ((r & 1) != es) continue;
            const int t = 4 * ti + r;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int s = 4 * si + q;
              if (s != t) at[(c * L + s) * lo.lda + t] = s < t ? acc[r][q] : 0.f;
            }
          }
        } else if (it >= n_tiles && it < n_tiles + nt) {
          const int tok = it - n_tiles, t = tok % L;
          const float* brow = bk + tok * lo.ldd;
          float b0 = 0.f, b1 = 0.f;
          for (int e = 0; e < d; e += 8) {
            const float4 z = ld4(brow + e), w = ld4(brow + e + 4);
            b0 += (z.x + z.y) + (z.z + z.w);
            b1 += (w.x + w.y) + (w.z + w.w);
          }
          at[tok * lo.lda + t] = b0 + b1;
        }
      }
    }

    // 2b. dS_c = k_rem_c^T v_c of every chunk in 8 x 4 tiles (rows e,
    //     columns j), into S_c's slot.
    {
      const int jb = cols / 4, eb = d / 8;
      for (int it = tid; it < nb * eb * jb; it += kThreads) {
        const int j = 4 * (it % jb), e = 8 * ((it / jb) % eb);
        const int c = it / (jb * eb);
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
        }
#pragma unroll 4
        for (int s = 0; s < L; ++s) {
          const int tok = c * L + s;
          const float4 k0 = ld4(ls + tok * lo.ldd + e);
          const float4 k1 = ld4(ls + tok * lo.ldd + e + 4);
          const float4 vr = ld4(vs + tok * lo.ldv + j);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ki = comp(i < 4 ? k0 : k1, i & 3);
            acc[i][0] = fmaf(ki, vr.x, acc[i][0]);
            acc[i][1] = fmaf(ki, vr.y, acc[i][1]);
            acc[i][2] = fmaf(ki, vr.z, acc[i][2]);
            acc[i][3] = fmaf(ki, vr.w, acc[i][3]);
          }
        }
        float* o = sbuf + (c * d + e) * lo.ldv + j;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(o + i * lo.ldv) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();

    // 3. The scan, for this thread's state tile: S_c replaces dS_c, and
    //    S_{c+1} = e^{P_L} S_c + dS_c.
    if (owner) {
      for (int c = 0; c < nb; ++c) {
        float* sb = sbuf + (c * d + e0) * lo.ldv + j0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = decay[c * d + e0 + i];
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj) {
            const float ds = sb[i * lo.ldv + jj];
            sb[i * lo.ldv + jj] = st[i][jj];
            st[i][jj] = a * st[i][jj] + ds;
          }
        }
      }
    }
    __syncthreads();

    // 4. y = r~ S_c + A' v in 4 x 4 tiles (tokens, columns); lane es of a
    //    pair takes every other float4 of D and key of the chunk, and the
    //    pair sums by a shuffle.
    {
      const int jq = cols / 4, ey = min(2, d / 4);
      const int n_items = (nt / 4) * jq * ey;
      for (int i0 = 0; i0 < n_items; i0 += kThreads) {
        const int it = i0 + tid;
        const bool act = it < n_items;
        const int es = it % ey, tile = it / ey;
        const int jy = 4 * (tile % jq), tok0 = 4 * (tile / jq);
        const int c = tok0 / L, tl = tok0 - c * L;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
        }
        if (act) {
          const float* sb = sbuf + c * d * lo.ldv + jy;
          const float* rrow = rs + tok0 * lo.ldd;
#pragma unroll 2
          for (int e = 4 * es; e < d; e += 4 * ey) {
            float4 x[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) x[r] = ld4(rrow + r * lo.ldd + e);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 sv = ld4(sb + (e + q) * lo.ldv);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float xr = comp(x[r], q);
                acc[r][0] = fmaf(xr, sv.x, acc[r][0]);
                acc[r][1] = fmaf(xr, sv.y, acc[r][1]);
                acc[r][2] = fmaf(xr, sv.z, acc[r][2]);
                acc[r][3] = fmaf(xr, sv.w, acc[r][3]);
              }
            }
          }
#pragma unroll 4
          for (int s = es; s < L; s += ey) {
            const float4 a4 = ld4(at + (c * L + s) * lo.lda + tl);
            const float4 vv = ld4(vs + (c * L + s) * lo.ldv + jy);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float a = comp(a4, r);
              acc[r][0] = fmaf(a, vv.x, acc[r][0]);
              acc[r][1] = fmaf(a, vv.y, acc[r][1]);
              acc[r][2] = fmaf(a, vv.z, acc[r][2]);
              acc[r][3] = fmaf(a, vv.w, acc[r][3]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = group_sum(acc[r][j], ey);
        }
        if (act) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (r % ey != es) continue;
            *reinterpret_cast<float4*>(g.y + head * g.hs +
                                       (t0 + tok0 + r) * g.ts + c0 + jy) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          }
        }
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
        g.s_out[(head * d + e0 + i) * d + c0 + j0 + jj] = st[i][jj];
    }
  }
}

// The state tile's width: 4 x TJ elements a thread, kThreads threads a
// slice.
int tile_j(int d, int cols) {
  return d * cols > 4 * kThreads ? d * cols / (4 * kThreads) : 1;
}

template <int L, int TJ>
int launch(const Args& g, int bh, int smem, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(wkv_chunked_kernel<L, TJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return int(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  wkv_chunked_kernel<L, TJ>
      <<<unsigned(bh * (g.d / g.cols)), kThreads, smem, stream>>>(g);
  return int(cudaGetLastError());
}

template <int L>
int launch_l(const Args& g, int bh, int smem, cudaStream_t stream) {
  switch (tile_j(g.d, g.cols)) {
    case 1: return launch<L, 1>(g, bh, smem, stream);
    case 2: return launch<L, 2>(g, bh, smem, stream);
    case 4: return launch<L, 4>(g, bh, smem, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory bytes of a block at head dim d, `cols` state columns a
// block, `tokens` staged at a time, chunk length `chunk`.
REPRO_EXPORT int repro_wkv_chunked_smem(int d, int cols, int tokens,
                                        int chunk) {
  return 4 * layout(d, cols, tokens, chunk).words;
}

// Rejects (cudaErrorInvalidValue) a shape or plan the kernel does not take:
// D in {8, 16, 32, 64}, chunk in {8, 16, 32}, S a positive multiple of the
// chunk, cols a multiple of 8 dividing D, tokens a multiple of the chunk
// with tokens * D <= 8 * kThreads (step 1 is one pass), strides in whole
// 16-byte words, past kSmemLimit. r, k, v, lw and y share
// one layout: head stride hs and token stride ts (in floats), D contiguous.
REPRO_EXPORT int repro_wkv_chunked(const void* r, const void* k,
                                   const void* v, const void* lw,
                                   const void* u, const void* s0, void* y,
                                   void* s_out, long long hs, long long ts,
                                   int bh, int seq, int d, int chunk,
                                   int cols, int tokens, void* stream) {
  bool aligned = hs % 4 == 0 && ts % 4 == 0;
  for (const void* p : {r, k, v, lw, static_cast<const void*>(y)})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if ((d != 8 && d != 16 && d != 32 && d != 64) ||
      (chunk != 8 && chunk != 16 && chunk != 32) || seq < chunk ||
      seq % chunk || cols < 8 || cols % 8 || d % cols || tokens < chunk ||
      tokens % chunk || tokens * d > 8 * kThreads || bh < 0 || !aligned)
    return int(cudaErrorInvalidValue);
  const int smem = repro_wkv_chunked_smem(d, cols, tokens, chunk);
  if (smem > kSmemLimit) return int(cudaErrorInvalidValue);
  if (bh == 0) return int(cudaSuccess);
  Args g;
  g.r = static_cast<const float*>(r);
  g.k = static_cast<const float*>(k);
  g.v = static_cast<const float*>(v);
  g.lw = static_cast<const float*>(lw);
  g.u = static_cast<const float*>(u);
  g.s0 = static_cast<const float*>(s0);
  g.y = static_cast<float*>(y);
  g.s_out = static_cast<float*>(s_out);
  g.hs = hs, g.ts = ts;
  g.seq = seq, g.d = d, g.cols = cols, g.tokens = tokens;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 8: return launch_l<8>(g, bh, smem, s);
    case 16: return launch_l<16>(g, bh, smem, s);
    case 32: return launch_l<32>(g, bh, smem, s);
  }
  return int(cudaErrorInvalidValue);
}
