// Gradient of the chunked RWKV-6 WKV (the backward of kernel 5,
// wkv_chunked.cu).
//
// Replaces: no Pallas kernel. The JAX package's Pallas forward
// (src/repro/kernels/rwkv_chunk.py::wkv_chunked) has no custom_vjp; it
// trains rwkv6 by differentiating its jnp _chunked_wkv
// (src/repro/models/lm/rwkv6.py:74, a lax.scan over the chunks) with XLA's
// autodiff. This kernel is that gradient, written by hand.
//
// r, k, v, lw, dy (BH, S, D) float32 through one (head, token) stride pair,
// u (BH, D), s0 (BH, D, D), dS_final (BH, D, D) or null (zero) ->
// dr, dk, dv, dlw (BH, S, D) through the same strides, du (BH, D),
// ds0 (BH, D, D); `states` (BH, S / L, D, D) is scratch the wrapper
// allocates. Per chunk of L tokens, with P the inclusive cumsum of lw,
// Pp = P - lw, r~ = r e^{Pp}, k~ = k e^{-P}, k_rem = k e^{P_L - P},
// A = strict_lower(r~ k~^T), b = sum_d r u k and dS the carry from the
// next chunk (rwkv_chunk.py::wkv_chunked_bwd_plain, the same equations):
//   dv  = A^T dy + b dy + k_rem dS
//   dA  = strict_lower(dy v^T),  db = sum_v dy v
//   dr~ = dA k~ + dy S_c^T,  dk~ = dA^T r~,  dk_rem = v dS^T
//   dr  = dr~ e^{Pp} + db u k,  dk = dk~ e^{-P} + dk_rem e^{P_L - P} + db u r
//   du += sum_t db r k
//   dP  = -dk~ k~ - dk_rem k_rem, at P_L + sum_s dk_rem k_rem
//         + e^{P_L} sum_v dS S_c
//   dlw = revcumsum(dP) + revcumsum(dPp) - dPp,  dPp = dr~ r~
//   dS <- e^{P_L} dS (row-wise) + r~^T dy
// k~ reaches e^80 at L = 16: float32 on the FMA units, built without fast
// math, as the forward is.
//
// Bound on the H100: float32 operations, about as far as bytes. At
// rwkv6-3b's training shape (BH = 640, S = 256, D = 64, L = 16) it reads
// r, k, v, lw, dy and writes dr, dk, dv, dlw once (~377 MB, 0.113 ms at
// 3.35 TB/s) and does ~8.4 GFLOP with the state recompute (0.125 ms at
// 67 TFLOP/s).
//
// Design (a simple kernel first): one block of 256 threads a head owns the
// whole (D, D) state. The backward needs S_c, the state at the start of
// each chunk, which only a forward sweep gives: the block first walks the
// chunks forward, its state in registers (D * D / 256 elements a thread),
// writing each S_c to the scratch. Then it walks them in reverse with dS
// in shared memory, one chunk of L tokens at a time, in five steps with a
// barrier after each: (1) the cumsum and exponentials, a thread per
// (token, channel); (2) A, dA, b, db, a thread per entry; (3) dv, dr, dk
// and the per-token terms of dlw, a thread per (token, channel), every
// dot product from shared memory; (4) a thread per channel sums dP and
// dPp from the end of the chunk (dlw) and its share of du; (5) dS <-
// e^{P_L} dS + r~^T dy, a thread per state element. Shared-memory rows
// are padded to D + 1 floats so column walks hit distinct banks. No
// register tiling yet: the steps are scalar loops over shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may take

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;
  const float* dy;
  const float* dsf;  // null: dS_final = 0
  float* dr;
  float* dk;
  float* dv;
  float* dlw;
  float* du;
  float* ds0;
  float* states;
  long long hs, ts;  // head and token strides of the (BH, S, D) tensors
  int seq;
};

// Shared memory in floats: fourteen (L, D + 1) tiles of a chunk (r, k, v,
// lw, dy; e^{Pp}, e^{-P}, e^{P_L - P}; r~, k~, k_rem; dP, dPp,
// dk_rem k_rem), S_c and dS (D, D + 1), A and dA (L, L + 1), b and db,
// e^{P_L} and u.
struct Layout {
  int ld, lda, r, k, v, lw, dy, epp, enp, erem, rt, kt, kr, dp, dpp, q, sc,
      ds, a, da, b, db, epl, u, words;
};

__host__ __device__ inline Layout layout(int d, int L) {
  Layout l;
  l.ld = d + 1;
  l.lda = L + 1;
  const int tile = L * l.ld;
  l.r = 0;
  l.k = tile;
  l.v = 2 * tile;
  l.lw = 3 * tile;
  l.dy = 4 * tile;
  l.epp = 5 * tile;
  l.enp = 6 * tile;
  l.erem = 7 * tile;
  l.rt = 8 * tile;
  l.kt = 9 * tile;
  l.kr = 10 * tile;
  l.dp = 11 * tile;
  l.dpp = 12 * tile;
  l.q = 13 * tile;
  l.sc = 14 * tile;
  l.ds = l.sc + d * l.ld;
  l.a = l.ds + d * l.ld;
  l.da = l.a + L * l.lda;
  l.b = l.da + L * l.lda;
  l.db = l.b + L;
  l.epl = l.db + L;
  l.u = l.epl + d;
  l.words = l.u + d;
  return l;
}

template <int L, int D>
__global__ void __launch_bounds__(kThreads) wkv_chunked_bwd_kernel(Args g) {
  extern __shared__ __align__(16) float sm[];
  const Layout lo = layout(D, L);
  const int ld = lo.ld, lda = lo.lda;
  constexpr int kPer = (D * D + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int64_t head = blockIdx.x;
  const int n = g.seq / L;
  const int64_t hoff = head * g.hs;
  float* rs = sm + lo.r;
  float* ks = sm + lo.k;
  float* vs = sm + lo.v;
  float* lws = sm + lo.lw;
  float* dys = sm + lo.dy;
  float* epp = sm + lo.epp;
  float* enp = sm + lo.enp;
  float* erem = sm + lo.erem;
  float* rt = sm + lo.rt;
  float* kt = sm + lo.kt;
  float* kr = sm + lo.kr;
  float* dps = sm + lo.dp;
  float* dpps = sm + lo.dpp;
  float* qs = sm + lo.q;
  float* scs = sm + lo.sc;
  float* dss = sm + lo.ds;
  float* as = sm + lo.a;
  float* das = sm + lo.da;
  float* bs = sm + lo.b;
  float* dbs = sm + lo.db;
  float* epl = sm + lo.epl;
  float* us = sm + lo.u;
  float* states = g.states + head * n * (D * D);
  for (int e = tid; e < D; e += kThreads) us[e] = g.u[head * D + e];

  // 1. The forward sweep: S_c of every chunk into the scratch, the state
  //    in registers (element i = tid + m * kThreads of the row-major D x D).
  float st[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * kThreads;
    st[m] = i < D * D ? g.s0[head * (D * D) + i] : 0.f;
  }
  for (int c = 0; c < n; ++c) {
    const int64_t t0 = int64_t(c) * L;
    for (int i = tid; i < L * D; i += kThreads) {
      const int t = i / D, e = i - t * D;
      const int64_t off = hoff + (t0 + t) * g.ts + e;
      ks[t * ld + e] = g.k[off];
      vs[t * ld + e] = g.v[off];
      lws[t * ld + e] = g.lw[off];
    }
    __syncthreads();
    for (int i = tid; i < L * D; i += kThreads) {
      const int t = i / D, e = i - t * D;
      float p = 0.f, pl = 0.f;
      for (int s = 0; s < L; ++s) {
        pl += lws[s * ld + e];
        if (s == t) p = pl;
      }
      kr[t * ld + e] = ks[t * ld + e] * expf(pl - p);
      if (t == L - 1) epl[e] = expf(pl);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = tid + m * kThreads;
      if (i < D * D) {
        const int d = i / D, j = i - d * D;
        states[int64_t(c) * (D * D) + i] = st[m];
        float acc = 0.f;
        for (int s = 0; s < L; ++s)
          acc = fmaf(kr[s * ld + d], vs[s * ld + j], acc);
        st[m] = epl[d] * st[m] + acc;
      }
    }
    __syncthreads();  // the tiles are reloaded for the next chunk
  }

  // 2. The reverse sweep, dS carried back from dS_final.
  for (int i = tid; i < D * D; i += kThreads) {
    const int d = i / D, j = i - d * D;
    dss[d * ld + j] = g.dsf ? g.dsf[head * (D * D) + i] : 0.f;
  }
  float du_acc = 0.f;  // channel tid's du (D <= kThreads)
  for (int c = n - 1; c >= 0; --c) {
    const int64_t t0 = int64_t(c) * L;
    for (int i = tid; i < L * D; i += kThreads) {
      const int t = i / D, e = i - t * D;
      const int64_t off = hoff + (t0 + t) * g.ts + e;
      const int o = t * ld + e;
      rs[o] = g.r[off];
      ks[o] = g.k[off];
      vs[o] = g.v[off];
      lws[o] = g.lw[off];
      dys[o] = g.dy[off];
    }
    for (int i = tid; i < D * D; i += kThreads) {
      const int d = i / D, j = i - d * D;
      scs[d * ld + j] = states[int64_t(c) * (D * D) + i];
    }
    __syncthreads();

    // (1) The cumsum (each thread sums the chunk's log decays in order),
    //     the exponentials, r~, k~ and k_rem.
    for (int i = tid; i < L * D; i += kThreads) {
      const int t = i / D, e = i - t * D;
      const int o = t * ld + e;
      float p = 0.f, pl = 0.f;
      for (int s = 0; s < L; ++s) {
        pl += lws[s * ld + e];
        if (s == t) p = pl;
      }
      const float a_pp = expf(p - lws[o]), a_np = expf(-p),
                  a_rem = expf(pl - p);
      epp[o] = a_pp;
      enp[o] = a_np;
      erem[o] = a_rem;
      rt[o] = rs[o] * a_pp;
      kt[o] = ks[o] * a_np;
      kr[o] = ks[o] * a_rem;
      if (t == L - 1) epl[e] = expf(pl);
    }
    __syncthreads();

    // (2) A and dA below the diagonal (0 on and above it), b and db.
    for (int i = tid; i < L * L + L; i += kThreads) {
      if (i < L * L) {
        const int t = i / L, s = i - t * L;
        float a = 0.f, da = 0.f;
        if (s < t) {
          for (int e = 0; e < D; ++e) {
            a = fmaf(rt[t * ld + e], kt[s * ld + e], a);
            da = fmaf(dys[t * ld + e], vs[s * ld + e], da);
          }
        }
        as[t * lda + s] = a;
        das[t * lda + s] = da;
      } else {
        const int t = i - L * L;
        float b = 0.f, db = 0.f;
        for (int e = 0; e < D; ++e) {
          b = fmaf(rs[t * ld + e] * us[e], ks[t * ld + e], b);
          db = fmaf(dys[t * ld + e], vs[t * ld + e], db);
        }
        bs[t] = b;
        dbs[t] = db;
      }
    }
    __syncthreads();

    // (3) A thread per (token t, channel e): dv (e a value column), dr~,
    //     dk~, dk_rem (e a key channel), then dr, dk, dv to device memory
    //     and the per-token terms of dP and dPp.
    for (int i = tid; i < L * D; i += kThreads) {
      const int t = i / D, e = i - t * D;
      const int o = t * ld + e;
      float dvv = bs[t] * dys[o];
      for (int tp = t + 1; tp < L; ++tp)
        dvv = fmaf(as[tp * lda + t], dys[tp * ld + e], dvv);
      for (int d = 0; d < D; ++d)
        dvv = fmaf(kr[t * ld + d], dss[d * ld + e], dvv);
      float drt = 0.f;
      for (int s = 0; s < t; ++s)
        drt = fmaf(das[t * lda + s], kt[s * ld + e], drt);
      for (int j = 0; j < D; ++j)
        drt = fmaf(dys[t * ld + j], scs[e * ld + j], drt);
      float dkt = 0.f;
      for (int tp = t + 1; tp < L; ++tp)
        dkt = fmaf(das[tp * lda + t], rt[tp * ld + e], dkt);
      float dkr = 0.f;
      for (int j = 0; j < D; ++j)
        dkr = fmaf(vs[t * ld + j], dss[e * ld + j], dkr);
      const float dbu = dbs[t] * us[e];
      const int64_t off = hoff + (t0 + t) * g.ts + e;
      g.dr[off] = drt * epp[o] + dbu * ks[o];
      g.dk[off] = dkt * enp[o] + dkr * erem[o] + dbu * rs[o];
      g.dv[off] = dvv;
      const float q = dkr * kr[o];
      dps[o] = -dkt * kt[o] - q;
      dpps[o] = drt * rt[o];
      qs[o] = q;
    }
    __syncthreads();

    // (4) A thread per channel: the gradient of P_L, then dlw from the end
    //     of the chunk (dP summed from t on, dPp from t + 1 on), and du.
    for (int e = tid; e < D; e += kThreads) {
      float gpl = 0.f;
      for (int j = 0; j < D; ++j)
        gpl = fmaf(dss[e * ld + j], scs[e * ld + j], gpl);
      float sq = 0.f;
      for (int s = 0; s < L; ++s) sq += qs[s * ld + e];
      float run = epl[e] * gpl + sq, run_pp = 0.f, duc = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        const int o = t * ld + e;
        run += dps[o];
        g.dlw[hoff + (t0 + t) * g.ts + e] = run + run_pp;
        run_pp += dpps[o];
        duc = fmaf(dbs[t] * rs[o], ks[o], duc);
      }
      du_acc += duc;
    }
    __syncthreads();

    // (5) dS <- e^{P_L} dS + r~^T dy.
    for (int i = tid; i < D * D; i += kThreads) {
      const int d = i / D, j = i - d * D;
      float acc = 0.f;
      for (int t = 0; t < L; ++t)
        acc = fmaf(rt[t * ld + d], dys[t * ld + j], acc);
      dss[d * ld + j] = epl[d] * dss[d * ld + j] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < D * D; i += kThreads) {
    const int d = i / D, j = i - d * D;
    g.ds0[head * (D * D) + i] = dss[d * ld + j];
  }
  if (tid < D) g.du[head * D + tid] = du_acc;
}

template <int L, int D>
int launch(const Args& g, int bh, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const int smem = 4 * layout(D, L).words;
  if (smem > kSmemLimit) return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(wkv_chunked_bwd_kernel<L, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return int(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  wkv_chunked_bwd_kernel<L, D><<<unsigned(bh), kThreads, smem, stream>>>(g);
  return int(cudaGetLastError());
}

template <int L>
int launch_l(const Args& g, int bh, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<L, 8>(g, bh, stream);
    case 16: return launch<L, 16>(g, bh, stream);
    case 32: return launch<L, 32>(g, bh, stream);
    case 64: return launch<L, 64>(g, bh, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory bytes of a block at head dim d and chunk length `chunk`.
REPRO_EXPORT int repro_wkv_chunked_bwd_smem(int d, int chunk) {
  return 4 * layout(d, chunk).words;
}

// Rejects (cudaErrorInvalidValue) a shape the kernel does not take: D in
// {8, 16, 32, 64}, chunk in {8, 16, 32}, S a positive multiple of the
// chunk. r, k, v, lw, dy and dr, dk, dv, dlw share one layout: head
// stride hs and token stride ts (in floats), D contiguous. ds_final may be
// null (zero). `states` holds BH * (S / chunk) * D * D floats.
REPRO_EXPORT int repro_wkv_chunked_bwd(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, const void* dy, const void* ds_final,
    void* dr, void* dk, void* dv, void* dlw, void* du, void* ds0,
    void* states, long long hs, long long ts, int bh, int seq, int d,
    int chunk, void* stream) {
  if ((d != 8 && d != 16 && d != 32 && d != 64) ||
      (chunk != 8 && chunk != 16 && chunk != 32) || seq < chunk ||
      seq % chunk || bh < 0)
    return int(cudaErrorInvalidValue);
  if (bh == 0) return int(cudaSuccess);
  Args g;
  g.r = static_cast<const float*>(r);
  g.k = static_cast<const float*>(k);
  g.v = static_cast<const float*>(v);
  g.lw = static_cast<const float*>(lw);
  g.u = static_cast<const float*>(u);
  g.s0 = static_cast<const float*>(s0);
  g.dy = static_cast<const float*>(dy);
  g.dsf = static_cast<const float*>(ds_final);
  g.dr = static_cast<float*>(dr);
  g.dk = static_cast<float*>(dk);
  g.dv = static_cast<float*>(dv);
  g.dlw = static_cast<float*>(dlw);
  g.du = static_cast<float*>(du);
  g.ds0 = static_cast<float*>(ds0);
  g.states = static_cast<float*>(states);
  g.hs = hs, g.ts = ts;
  g.seq = seq;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 8: return launch_l<8>(g, bh, d, s);
    case 16: return launch_l<16>(g, bh, d, s);
    case 32: return launch_l<32>(g, bh, d, s);
  }
  return int(cudaErrorInvalidValue);
}
