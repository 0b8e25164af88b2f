// Chunked RWKV-6 WKV recurrence (forward), for Hopper (sm_90a). Replaces the
// Pallas kernel repro/kernels/rwkv_chunk.py::_kernel (rwkv_chunk_scan :76).
// Per (batch row b, head h), with head dim N and log decay logw < 0:
//
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_tᵀ
//   y_t = r_tᵀ S_{t-1} + (r_t · (u ⊙ k_t)) v_t
//
// computed chunk by chunk as repro/models/rwkv6.py::_chunk_core does, with
// l_inc = cumsum(logw) and l_exc the same sum one row earlier inside the
// chunk:
//
//   y_t  = (r_t ⊙ e^{l_exc,t}) S0                                 (inter)
//        + Σ_{j<t} [Σ_n r_tn k_jn e^{l_exc,tn - l_inc,jn}] v_j    (intra)
//        + (r_t · (u ⊙ k_t)) v_t                                  (bonus)
//   S1   = e^{l_tot} ⊙ S0 + Σ_j (k_j ⊙ e^{l_tot - l_inc,j}) v_jᵀ
//
// Every exponent is a difference of log cumsums that is <= 0, so nothing
// overflows at any decay (logw = -8 over a 128-token chunk included); the
// intra term is never factored as (r e^{l_exc})(k e^{-l_inc}), which would
// overflow fp32 once |l_inc| > 88.
//
// What bounds it on an H100 at the prefill shape (B 1, S 512, H 40, N 64,
// chunk 128): the function's least work is the per-token recurrence,
// 5·N² + 4·N fp32 flops and N exponentials a token and head: 0.42 GFLOP,
// ~6.3 us at 67 TFLOP/s, against ~19 MB of traffic, ~5.7 us. The chunked
// form taken literally needs c(c-1)/2·N exponentials a chunk and head (86 M
// a launch, ~20 us on the SFU alone), so the intra term is factored at
// sub-block boundaries: for query t in the 16-row sub-block T that starts
// at t0, and key j < t0,
//
//   e^{l_exc,t - l_inc,j} = e^{l_exc,t - l_exc,t0} · e^{l_exc,t0 - l_inc,j}
//
// with both exponents <= 0 (the cumsum never rises), so the off-diagonal
// sub-blocks become fp32 products of rescaled r and k tiles; only the
// diagonal sub-block takes one exponential per (t, j, n). A factor
// underflows only where the true term is below e^-87. At c 128 that is
// ~119 k exponentials a chunk and head (the carry's N² included) where the
// literal form takes ~537 k, and ~2.3 M FMAs: 19 M exponentials and 0.75
// GFLOP a launch, ~4.5 us and ~11 us at the SFU and fp32 peaks
// (chip_smoke.py rwkv_design_work counts them).
//
// Design: three launches, the chunks spread over blocks; only the state
// carry is serial, and it is N² independent chains.
//   rwkv_state_kernel, one block per (b·h, chunk): the chunk's l_tot and
//     its local state term ΔS = Σ_j (k_j ⊙ e^{l_tot - l_inc,j}) v_jᵀ, to
//     fp32 scratch.
//   rwkv_carry_kernel, one thread per state element: S_{i+1} = e^{l_tot,i}
//     ⊙ S_i + ΔS_i in chunk order from state_in, each chunk's entry state
//     S_i written over its ΔS, and the final state.
//   rwkv_out_kernel, one block per (b·h, chunk, pair of sub-blocks T and
//     nb-1-T, so that blocks carry equal work): the bonus and the diagonal
//     sub-block's scores directly, the off-diagonal keys in tiles of 64 as
//     products, then, after griddepcontrol.wait, the inter term from the
//     chunk's entry state, and y.
//   rwkv_out_bf16_kernel, in place of rwkv_out_kernel for the bf16 chunk
//     form (see there): the literal form, its scores rounded as the
//     reference's bf16 einsum rounds them.
// The second and third are programmatic dependent launches: the output
// kernel's intra work runs while the state pass and the carry do. The
// cumsum is a parallel scan: each 16-row sub-block sums its logw serially
// (one thread per (sub-block, n)), a short serial prefix gives the
// boundaries, and a row's l_inc is its sub-block's boundary plus the same
// serial run, so the state and output kernels see the same bits and the
// sequence never rises. All sums are fp32 in a fixed order, with no atomics: two calls
// give the same bits. Scratch comes from the caller.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CMAX = 1024;              // largest chunk
constexpr int SB = 16;                  // rows of a sub-block
constexpr int KT = 64;                  // key rows an output block stages at once
constexpr int AT = 64;                  // rows a state block stages at once
constexpr int CARRY_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

// e^x for x <= 0 (clamped: every exponent here is a difference that is <= 0),
// on the SFU's ex2.approx (relative error ~2^-22; results below 2^-126,
// whose terms are negligible beside the chunk's nearest ones, flush to 0).
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fminf(x, 0.f) * LOG2E));
  return y;
}

template <int K> __device__ __forceinline__ void ld(const float* p, float (&o)[K]);
template <> __device__ __forceinline__ void ld<1>(const float* p, float (&o)[1]) { o[0] = *p; }
template <> __device__ __forceinline__ void ld<2>(const float* p, float (&o)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  o[0] = a.x; o[1] = a.y;
}
template <> __device__ __forceinline__ void ld<4>(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

// Lb[J·N + n] = l_exc,n at row SB·J of the chunk, for J = 0..nb (Lb[0] = 0),
// from the first nb sub-blocks of logw (the last may be short: rows < c).
// Ends with __syncthreads().
template <int N>
__device__ void boundaries(const float* __restrict__ w, size_t rs, int c, int nb,
                           float* __restrict__ Lb) {
  for (int e = threadIdx.x; e < nb * N; e += THREADS) {
    const int J = e / N, n = e % N, nt = min(SB, c - SB * J);
    const float* wp = w + (size_t)SB * J * rs + n;
    float wv[SB];
#pragma unroll
    for (int i = 0; i < SB; ++i) wv[i] = i < nt ? wp[i * rs] : 0.f;   // all in flight
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < SB; ++i) run += wv[i];   // + 0 past nt: the same bits
    Lb[(J + 1) * N + n] = run;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    float acc = 0.f;
    Lb[n] = 0.f;
    for (int J = 1; J <= nb; ++J) {
      acc += Lb[J * N + n];
      Lb[J * N + n] = acc;
    }
  }
  __syncthreads();
}

// Shared memory of the two kernels, in floats; P is a padded row.
template <int N> struct Layout {
  static constexpr int P = N + 4;
  static size_t state_floats(int nb) { return (size_t)(nb + 1) * N + 2 * AT * P; }
  static constexpr int KTP = KT + 1;    // padded row of the transposed key tile
  static size_t out_floats(int nb) {
    return (size_t)(nb + 1) * N + 4 * SB * P + 3 * N * SB + KT * SB + N * KTP + KT * P;
  }
  static_assert(N * KTP + KT * P >= N * N, "the entry state reuses the key tile");
  static_assert(N * KTP % 4 == 0, "16-byte aligned regions");
};

// grid (B·H, chunks). ds (B·H, chunks, N, N) and ltot (B·H, chunks, N):
// fp32 scratch read by rwkv_out_kernel.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 3)
rwkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ logw, float* __restrict__ ds,
                  float* __restrict__ ltot, int S, int H, int c) {
  constexpr int P = Layout<N>::P, TN = N / 16;
  extern __shared__ __align__(16) float smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");   // rwkv_out may start
  const int nb = (c + SB - 1) / SB, tid = threadIdx.x;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const int b = bh / H, h = bh % H;
  float* Lb = smem;                     // (nb + 1, N) boundaries
  float* kh = Lb + (nb + 1) * N;        // (AT, P) k ⊙ e^{l_tot - l_inc}
  float* vt = kh + AT * P;              // (AT, P) v
  const size_t rs = (size_t)H * N;      // between tokens
  const size_t base = ((size_t)b * S + (size_t)ch * c) * rs + (size_t)h * N;

  boundaries<N>(logw + base, rs, c, nb, Lb);
  const float* lt = Lb + nb * N;        // l_tot
  if (tid < N) ltot[((size_t)bh * nc + ch) * N + tid] = lt[tid];

  const int ng = tid / 16, mg = tid % 16;   // ΔS rows ng·TN.., columns mg·TN..
  float acc[TN][TN];
#pragma unroll
  for (int a = 0; a < TN; ++a)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[a][q] = 0.f;
  for (int j0 = 0; j0 < c; j0 += AT) {
    const int rows = min(AT, c - j0);
    __syncthreads();                    // the previous tile is consumed
#pragma unroll 8
    for (int e = tid; e < rows * N; e += THREADS) {
      const int t = e / N, n = e % N;
      vt[t * P + n] = rt::to_f(v[base + (size_t)(j0 + t) * rs + n]);
    }
    for (int e = tid; e < (AT / SB) * N; e += THREADS) {
      const int jl = e / N, n = e % N, t0 = j0 + SB * jl;
      if (t0 < c) {
        const int J = t0 / SB, nt = min(SB, c - t0);
        const size_t g0 = base + (size_t)t0 * rs + n;
        float wv[SB], kv[SB];
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          wv[i] = i < nt ? logw[g0 + i * rs] : 0.f;
          kv[i] = i < nt ? rt::to_f(k[g0 + i * rs]) : 0.f;
        }
        float run = 0.f;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          run += wv[i];
          if (i < nt) kh[(SB * jl + i) * P + n] = kv[i] * exp_neg(lt[n] - (Lb[J * N + n] + run));
        }
      }
    }
    __syncthreads();
    for (int t = 0; t < rows; ++t) {
      float kk[TN], vv[TN];
      ld<TN>(kh + t * P + ng * TN, kk);
      ld<TN>(vt + t * P + mg * TN, vv);
#pragma unroll
      for (int a = 0; a < TN; ++a)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[a][q] = fmaf(kk[a], vv[q], acc[a][q]);
    }
  }
  float* dst = ds + ((size_t)bh * nc + ch) * N * N;
#pragma unroll
  for (int a = 0; a < TN; ++a)
#pragma unroll
    for (int q = 0; q < TN; ++q) dst[(ng * TN + a) * N + mg * TN + q] = acc[a][q];
}

// grid (ceil(B·H·N² / (4·CARRY_THREADS))): the state carry, one thread per
// 4 elements (b·h, n, m..m+3), in chunk order: S_0 = state_in (or 0),
// S_{i+1} = e^{l_tot,i} ⊙ S_i + ΔS_i. Each chunk's ΔS is replaced by the
// chunk's entry state S_i, which rwkv_out_kernel reads; the last S is the
// final state. A programmatic dependent of rwkv_state_kernel and the
// primary of rwkv_out_kernel; small blocks, so that while they wait they
// leave room for the output blocks.
template <int N>
__global__ void __launch_bounds__(CARRY_THREADS)
rwkv_carry_kernel(const float* __restrict__ state_in, float* __restrict__ ds,
                  const float* __restrict__ ltot, float* __restrict__ state_out, int BH,
                  int nc) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");   // rwkv_out may start
  asm volatile("griddepcontrol.wait;\n" ::: "memory");                // rwkv_state's scratch
  const size_t e = ((size_t)blockIdx.x * CARRY_THREADS + threadIdx.x) * 4;
  if (e >= (size_t)BH * N * N) return;
  const size_t bh = e / (N * N);
  const int f = (int)(e % (N * N)), n = f / N;
  float* d = ds + bh * nc * N * N + f;
  const float* lt = ltot + bh * nc * N + n;
  float4 s = state_in ? *reinterpret_cast<const float4*>(state_in + e)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int q = 0; q < nc; ++q) {
    float4* dq = reinterpret_cast<float4*>(d + (size_t)q * N * N);
    const float4 v = *dq;
    const float w = exp_neg(lt[q * N]);
    *dq = s;
    s = make_float4(fmaf(w, s.x, v.x), fmaf(w, s.y, v.y), fmaf(w, s.z, v.z), fmaf(w, s.w, v.w));
  }
  *reinterpret_cast<float4*>(state_out + e) = s;
}

// y[rows] += pᵀ[j][rows] · x[j][m] over j < nj: the thread's RPT rows
// (rg·RPT..) of output column m; pt is key-major (row stride SB), x has row
// stride ldx.
template <int RPT>
__device__ __forceinline__ void accumulate(float (&y)[RPT], const float* __restrict__ pt,
                                           const float* __restrict__ x, int ldx, int nj,
                                           int rg, int m) {
  for (int j = 0; j < nj; ++j) {
    float p[RPT];
    ld<RPT>(pt + j * SB + rg * RPT, p);
    const float xv = x[j * ldx + m];
#pragma unroll
    for (int i = 0; i < RPT; ++i) y[i] = fmaf(p[i], xv, y[i]);
  }
}

// grid (B·H, chunks, ceil(nb / 2)); launched as a programmatic dependent of
// rwkv_carry_kernel, whose entry states it reads after griddepcontrol.wait.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 3)   // three blocks an SM: <= 85 registers
rwkv_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ ds,
                float* __restrict__ y, int S, int H, int c) {
  constexpr int P = Layout<N>::P, RPT = N / 16, EPT = N * N / THREADS;
  static_assert(EPT * THREADS == N * N, "the entry state splits evenly over the threads");
  extern __shared__ __align__(16) float smem[];
  const int nb = (c + SB - 1) / SB, tid = threadIdx.x;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y, grp = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int subs[2] = {nb - 1 - grp, grp};   // the later sub-block first; grp <= nb-1-grp
  const int ns = subs[0] == subs[1] ? 1 : 2;
  float* Lb = smem;                     // (nb + 1, N) boundaries
  constexpr int KTP = Layout<N>::KTP;
  float* rtl = Lb + (nb + 1) * N;       // (N, SB) (r ⊙ e^{l_exc - l_exc,t0})ᵀ
  float* rh = rtl + N * SB;             // 2 × (N, SB) (r ⊙ e^{l_exc})ᵀ, per sub-block
  float* rr = rh + 2 * N * SB;          // (SB, P) r
  float* kr = rr + SB * P;              // (SB, P) k
  float* le = kr + SB * P;              // (SB, P) logw, then l_exc
  float* li = le + SB * P;              // (SB, P) l_inc
  float* pt = li + SB * P;              // (KT, SB) scores, key-major
  float* kt = pt + KT * SB;             // (N, KTP) (k ⊙ e^{l_exc,t0 - l_inc})ᵀ
  float* vt = kt + N * KTP;             // (KT, P) v
  float* st = kt;                       // (N, N) entry state, over kt and vt at the end
  const size_t rs = (size_t)H * N;
  const size_t base = ((size_t)b * S + (size_t)ch * c) * rs + (size_t)h * N;
  const float* uh = u + (size_t)h * N;

  boundaries<N>(logw + base, rs, c, subs[0], Lb);   // Lb[0..T] for both sub-blocks
  const int m = tid % N, rg = tid / N;  // output column; rows rg·RPT..
  float yacc[2][RPT];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < RPT; ++i) yacc[s][i] = 0.f;

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s >= ns) break;
    const int T = subs[s], t0 = SB * T, nt = min(SB, c - t0);
    const float* lT = Lb + T * N;       // l_exc at t0
    __syncthreads();                    // the previous sub-block is done with smem
#pragma unroll
    for (int e = tid; e < SB * N; e += THREADS) {
      const int i = e / N, n = e % N;
      const bool in = i < nt;
      const size_t g = base + (size_t)(t0 + i) * rs + n;
      rr[i * P + n] = in ? rt::to_f(r[g]) : 0.f;
      kr[i * P + n] = in ? rt::to_f(k[g]) : 0.f;
      vt[i * P + n] = in ? rt::to_f(v[g]) : 0.f;
      le[i * P + n] = in ? logw[g] : 0.f;
    }
    __syncthreads();
    if (tid < N) {                      // the sub-block's run from its boundary
      const int n = tid;
      float run = 0.f, prev = lT[n];
      for (int i = 0; i < nt; ++i) {
        const float w = le[i * P + n];
        le[i * P + n] = prev;
        run += w;
        prev = lT[n] + run;
        li[i * P + n] = prev;
      }
    }
    __syncthreads();
    for (int e = tid; e < SB * N; e += THREADS) {   // rows past nt have r = 0
      const int i = e / N, n = e % N;
      const float rv = rr[i * P + n], l = le[i * P + n];
      rtl[n * SB + i] = rv * exp_neg(l - lT[n]);
      rh[(s * N + n) * SB + i] = rv * exp_neg(l);
    }
    {                                   // diagonal sub-block, a thread a pair: pt[j][t]
      static_assert(SB * SB == THREADS, "one thread per (t, j) of the diagonal sub-block");
      const int t = tid / SB, j = tid % SB;
      float p = 0.f;
      if (j <= t && t < nt) {
        for (int n = 0; n < N; n += 4) {
          float rv[4], kv[4], ev[4], lv[4];
          ld<4>(rr + t * P + n, rv);
          ld<4>(kr + j * P + n, kv);
          ld<4>(le + t * P + n, ev);
          ld<4>(li + j * P + n, lv);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            p = j < t ? fmaf(rv[x] * kv[x], exp_neg(ev[x] - lv[x]), p)
                      : fmaf(rv[x] * kv[x], uh[n + x], p);   // the bonus at j == t
        }
      }
      pt[j * SB + t] = p;
    }
    __syncthreads();
    accumulate<RPT>(yacc[s], pt, vt, P, SB, rg, m);

    // off-diagonal keys j < t0, KT at a time
    for (int j0 = 0; j0 < t0; j0 += KT) {
      const int kn = min(KT, t0 - j0);  // whole sub-blocks
      __syncthreads();                  // pt, kt, vt are consumed
#pragma unroll 8
      for (int e = tid; e < kn * N; e += THREADS) {
        const int j = e / N, n = e % N;
        vt[j * P + n] = rt::to_f(v[base + (size_t)(j0 + j) * rs + n]);
      }
      for (int e = tid; e < (KT / SB) * N; e += THREADS) {
        const int jl = e / N, n = e % N;
        if (SB * jl < kn) {
          const int J = j0 / SB + jl;
          const size_t g0 = base + (size_t)(j0 + SB * jl) * rs + n;
          float wv[SB], kv[SB];
#pragma unroll
          for (int i = 0; i < SB; ++i) {
            wv[i] = logw[g0 + i * rs];
            kv[i] = rt::to_f(k[g0 + i * rs]);
          }
          float run = 0.f;
#pragma unroll
          for (int i = 0; i < SB; ++i) {
            run += wv[i];
            kt[n * KTP + SB * jl + i] = kv[i] * exp_neg(lT[n] - (Lb[J * N + n] + run));
          }
        }
      }
      __syncthreads();
      {                                 // scores of rows 4·tq.. against key j
        const int tq = tid / KT, j = tid % KT;
        static_assert(THREADS == 4 * KT, "4 row quads x KT keys");
        if (j < kn) {
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            float rv[4];
            ld<4>(rtl + n * SB + 4 * tq, rv);
            const float kv = kt[n * KTP + j];
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] = fmaf(rv[x], kv, a[x]);
          }
          *reinterpret_cast<float4*>(pt + j * SB + 4 * tq) = make_float4(a[0], a[1], a[2], a[3]);
        }
      }
      __syncthreads();
      accumulate<RPT>(yacc[s], pt, vt, P, kn, rg, m);
    }
  }

  // inter term, from the chunk's entry state (rwkv_carry_kernel's, over ds)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();                      // kt and vt are free
  const float* entry = ds + ((size_t)bh * nc + ch) * N * N;
  float sv[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) sv[i] = entry[tid + i * THREADS];
#pragma unroll
  for (int i = 0; i < EPT; ++i) st[tid + i * THREADS] = sv[i];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s >= ns) break;
    accumulate<RPT>(yacc[s], rh + s * N * SB, st, N, N, rg, m);
    const int t0 = SB * subs[s], nt = min(SB, c - t0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = rg * RPT + i;
      if (t < nt) y[base + (size_t)(t0 + t) * rs + m] = yacc[s][i];
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 chunk form (the reference's rwkv_chunk_dtype="bfloat16",
// repro/models/rwkv6.py::_chunk_core :131-134): there D is rounded to bf16,
// and jnp.einsum contracts r, k and D pairwise, r ⊗ k first, each result
// rounded to bf16. So the score of query t and key j < t is
//
//   s_tj = bf16( Σ_n bf16(bf16(r_tn) · bf16(k_jn)) · bf16(e^{l_exc,tn - l_inc,jn}) )
//
// with the sum over n in fp32 (each product of two bf16 values is exact in
// fp32). The factored form of rwkv_out_kernel cannot round each (t, j, n)'s
// exponential, so this form takes them literally: c(c-1)/2·N a chunk and
// head, 86 M a launch at the prefill shape, 20.5 us on the SFU's 16 a clock
// per SM (the bound). The bonus (j == t) and the inter term stay fp32, as in
// the reference; the state pass and the carry are those of the fp32 form.
//
// rwkv_out_bf16_kernel, built so that the SFU could set the pace: a warp's
// ex2 holds its SMSP's SFU for 8 issue cycles, so all else a (t, j, n)
// costs is kept to about 4 issue slots (measured, the kernel is held back
// by each item's staging and by the state pass beside it: PERF.md §6):
//   - a block takes an item: a (b·h, chunk) and its pair of 16-row
//     sub-blocks T and nb-1-T, so that every block scores as many pairs.
//     Two blocks fit an SM (112 registers a thread, all of the SM's shared
//     memory), and the hardware hands out the items as blocks finish.
//   - an item stages its keys once, KB rows at a time: k rounded to bf16, v,
//     and l_inc from the boundaries and serial runs of the state pass (the
//     same bits; l_exc,t has l_inc,t-1's bits, so every exponent of a pair
//     j < t is <= 0 without a clamp).
//   - a warp takes a query row, its bf16 r and l_exc in registers, and 8 keys
//     at a time: lane (p, q) forms for key j+p and n = 16s+4q..16s+4q+3 four
//     exponentials (an FSUB, an FMUL and an ex2 each), rounds them two at a
//     time (cvt.rn.bf16x2.f32) and forms r·k two at a time (mul.rn.bf16x2:
//     the exact product rounded once, the bits of the fp32 product rounded
//     to bf16 for every pair of bf16 values: bf16_product_check_kernel).
//     Those are the B and A fragments of an mma.sync m16n8k16 (A's rows 8-15
//     zero) whose diagonal C[p][p] is the score of key j+p: the tensor core
//     adds the exact products in fp32. Only a row's last group masks (j+p >=
//     t), by a select.
//   - the scores, bf16 values exactly, go to shared memory; scores · V runs
//     on mma.sync m16n8k16 bf16 -> fp32 where v is bf16 (exact products),
//     on fp32 FFMA where v is fp32.
//   - the inter term needs the chunk's entry state, which the carry writes:
//     a block calls griddepcontrol.wait once its scores are formed (it
//     returns at once after the carry has ended, so only the blocks run
//     beside the state pass can wait), and the entry state lands by
//     cp.async over l_inc while scores · V runs. y = intra + bonus · v +
//     (r ⊙ e^{l_exc}) S0 in fp32 is written once.
// Launched as a programmatic dependent of rwkv_carry_kernel. Every sum has
// a fixed order and there are no atomics: two calls give the same bits.
constexpr int KB = 128;                 // key rows an item stages at once
constexpr int QR = 2 * SB;              // query rows of an item

// Shared memory of rwkv_out_bf16_kernel, byte offsets, for kt key rows a
// tile. An item's: Lb (nb+1, N) boundaries, le (QR, N) l_exc, rr, qk, qv
// (QR, N) r, k, v of the query rows, us (N) u, bonus (QR). A tile: kb (kt,
// LP) bf16 k, li (kt, LP) l_inc, vs (kt, VP) v, sc (QR, kt + 8) bf16
// scores. Over li once the last tile is scored: st (N, N) the entry state,
// rh (QR, N) r ⊙ e^{l_exc}, yo (QR, N + 4) the intra sums. Row strides keep
// warp reads conflict-free: li rows 64 bytes apart mod 128, kb rows 32, the
// ldmatrix rows of vs and sc 16.
template <typename T, int N> struct LayoutB16 {
  static constexpr int LP = N % 32 == 0 ? N + 16 : N;
  static constexpr int VP = N + 8, YP = N + 4;
  int scp;
  size_t le, rr, qk, qv, us, bonus, kb, li, vs, sc, st, rh, yo, total;
  __host__ __device__ LayoutB16(int nb, int kt) : scp(kt + 8) {
    le = (size_t)(nb + 1) * N * 4;
    rr = le + (size_t)QR * N * 4;
    qk = rr + (size_t)QR * N * sizeof(T);
    qv = qk + (size_t)QR * N * sizeof(T);
    us = qv + (size_t)QR * N * sizeof(T);
    bonus = us + (size_t)N * 4;
    kb = bonus + (size_t)QR * 4;
    li = kb + (size_t)kt * LP * 2;
    st = li;
    rh = st + (size_t)N * N * 4;
    yo = rh + (size_t)QR * N * 4;
    const size_t epi = yo + (size_t)QR * YP * 4 - li, lis = (size_t)kt * LP * 4;
    vs = li + (lis > epi ? lis : epi);
    sc = vs + (size_t)kt * VP * sizeof(T);
    total = sc + (size_t)QR * scp * 2;
  }
};

__device__ __forceinline__ float ex2(float x) {   // 2^x; below 2^-126 flushed to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lo and hi rounded to bf16, nearest even, packed with lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// two bf16 products, each exact product rounded once to bf16, nearest even
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// d += a·b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// 4 consecutive elements of T as fp32, and back (8- or 16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) { ld<4>(p, o); }
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]));
}
// 4 consecutive elements of T as two bf16 pairs (rounded where T is fp32)
__device__ __forceinline__ uint2 bf16x4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint2 bf16x4(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}

// One group of 8 keys for a query row: lane (p, q) scores key j+p over n =
// 16s+4q..+3 for every s, on the tensor core's diagonal; lv, rv the row's
// l_exc and bf16 r at those n, lip and kbp key j+p's l_inc and bf16 k
// there. MASK: the row's last group, keys j+p >= t (keep false) scored 0.
// The lane on the diagonal (q == p/2) writes the bf16 score to out.
template <int N, bool MASK>
__device__ __forceinline__ void score_group(const float (&lv)[N / 16][4],
                                            const unsigned (&rv)[N / 16][2],
                                            const float* lip, const __nv_bfloat16* kbp,
                                            bool keep, bool diag, bool odd,
                                            __nv_bfloat16* out) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < N / 16; ++s) {
    const float4 l4 = *reinterpret_cast<const float4*>(lip + 16 * s);
    const uint2 k2 = *reinterpret_cast<const uint2*>(kbp + 16 * s);
    unsigned d01 = pack_bf16(ex2((lv[s][0] - l4.x) * LOG2E), ex2((lv[s][1] - l4.y) * LOG2E));
    unsigned d23 = pack_bf16(ex2((lv[s][2] - l4.z) * LOG2E), ex2((lv[s][3] - l4.w) * LOG2E));
    if (MASK && !keep) d01 = d23 = 0u;   // a select: e^{x > 0} may be inf
    mma_bf16(c, mul_bf16x2(rv[s][0], k2.x), 0u, mul_bf16x2(rv[s][1], k2.y), 0u, d01, d23);
  }
  if (diag && (!MASK || keep)) *out = __float2bfloat16_rn(odd ? c[1] : c[0]);
}

// An item's place: (b·h, chunk, pair of sub-blocks sub0 <= sub1) and its
// rows; local row lr = 16s + i is row 16·sub(s) + i of the chunk.
struct Item {
  int bh, ch, sub0, sub1, ns;
  size_t base;
  __device__ Item(int item, int nb, int nc, int S, int H, int N, int c) {
    const int np = (nb + 1) / 2, z = item % np, rest = item / np;
    ch = rest % nc;
    bh = rest / nc;
    sub0 = z;
    sub1 = nb - 1 - z;
    ns = sub0 == sub1 ? 1 : 2;
    base = ((size_t)(bh / H) * S + (size_t)ch * c) * ((size_t)H * N) + (size_t)(bh % H) * N;
  }
  __device__ int row(int lr) const { return SB * (lr < SB ? sub0 : sub1) + lr % SB; }
  __device__ bool live(int lr, int c) const { return lr < ns * SB && row(lr) < c; }
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {   // 16 bytes, async
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows 0..rows-1 of N elements of T from src (row stride rs) to dst (row
// stride dp), as bf16 (BF: k, rounded) or as T; rows live.. are zero. bf16
// to bf16 lands by cp.async (the caller waits); fp32 goes through
// registers.
template <typename T, bool BF>
using StageT = typename std::conditional<BF, __nv_bfloat16, T>::type;

template <typename T, int N, bool BF>
__device__ __forceinline__ void stage_rows(StageT<T, BF>* dst, int dp,
                                           const T* __restrict__ src, size_t rs, int live,
                                           int rows) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int CPR = N / 8;           // 16-byte chunks a row
    for (int e = threadIdx.x; e < rows * CPR; e += THREADS) {
      const int j = e / CPR, x = 8 * (e % CPR);
      if (j < live) cp16(dst + j * dp + x, src + (size_t)j * rs + x);
      else *reinterpret_cast<uint4*>(dst + j * dp + x) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = threadIdx.x; e < rows * (N / 4); e += THREADS) {
      const int j = e / (N / 4), x = 4 * (e % (N / 4));
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < live) load4(src + (size_t)j * rs + x, a);
      store4(dst + j * dp + x, a);
    }
  }
}

// Serial runs of logw over 16-row sub-blocks from their boundaries, UNR
// tasks a thread in flight at once. Task e < nq: query sub-block s = e / N
// of the item, its l_exc into le; else key sub-block jl of the tile at j0,
// its l_inc into li (rows past kn zero): the runs and boundaries of the
// state pass, so the same bits.
template <int N, int UNR>
__device__ __forceinline__ void logw_runs(const float* __restrict__ w, size_t rs, int c,
                                          const float* Lb, float* le, int sub0, int sub1,
                                          int nq, float* li, int LP, int j0, int kn,
                                          int tasks) {
  for (int e0 = threadIdx.x; e0 < tasks; e0 += UNR * THREADS) {
    float wv[UNR][SB];
#pragma unroll
    for (int x = 0; x < UNR; ++x) {
      const int e = e0 + x * THREADS, n = e % N;
      int r0 = 0, rows = 0;
      if (e < nq) {
        r0 = SB * (e / N ? sub1 : sub0);
        rows = min(SB, c - r0);
      } else if (e < tasks) {
        r0 = j0 + SB * ((e - nq) / N);
        rows = min(SB, j0 + kn - r0);
      }
      const float* wp = w + (size_t)r0 * rs + n;
#pragma unroll
      for (int i = 0; i < SB; ++i) wv[x][i] = i < rows ? wp[i * rs] : 0.f;
    }
#pragma unroll
    for (int x = 0; x < UNR; ++x) {
      const int e = e0 + x * THREADS, n = e % N;
      if (e >= tasks) continue;
      float run = 0.f;
      if (e < nq) {
        const int s = e / N;
        const float lT = Lb[(s ? sub1 : sub0) * N + n];
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          le[(SB * s + i) * N + n] = lT + run;
          run += wv[x][i];
        }
      } else {
        const int jl = (e - nq) / N, rows = min(SB, kn - SB * jl);
        const float lJ = Lb[(j0 / SB + jl) * N + n];
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          run += wv[x][i];
          li[(SB * jl + i) * LP + n] = i < rows ? lJ + run : 0.f;
        }
      }
    }
  }
}

// An item: y = Σ_{j<t} s_tj v_j + bonus_t v_t + (r_t ⊙ e^{l_exc,t}) S0 for
// its rows, S0 the chunk's entry state (rwkv_carry_kernel's, over ds),
// which the first item of a block waits for once its scores are formed.
template <typename T, int N>
__device__ __forceinline__ void bf16_item(
    const Item& it, char* sm, const LayoutB16<T, N>& lay, int kt,
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ logw, const float* __restrict__ u,
    const float* __restrict__ ds, float* __restrict__ y, int H, int c, int nc) {
  using L = LayoutB16<T, N>;
  constexpr int LP = L::LP, VP = L::VP, YP = L::YP, NS = N / 16;
  constexpr int RPV = QR * N / THREADS;          // rows of a thread in the FFMA and final passes
  constexpr int TPW = (N / 8 + 3) / 4;           // n-tiles of a warp in scores · V
  constexpr bool MMA_V = std::is_same<T, __nv_bfloat16>::value;
  const int scp = lay.scp, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* Lb = reinterpret_cast<float*>(sm);
  float* le = reinterpret_cast<float*>(sm + lay.le);
  T* rr = reinterpret_cast<T*>(sm + lay.rr);
  T* qv = reinterpret_cast<T*>(sm + lay.qv);
  float* bonus = reinterpret_cast<float*>(sm + lay.bonus);
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(sm + lay.kb);
  float* li = reinterpret_cast<float*>(sm + lay.li);
  T* vs = reinterpret_cast<T*>(sm + lay.vs);
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(sm + lay.sc);
  const size_t rs = (size_t)H * N, base = it.base;
  const float* uh = u + (size_t)(it.bh % H) * N;
  const int ns = it.ns, thi = it.sub1;
  const int kend = SB * thi + min(SB, c - SB * thi) - 1;   // keys scored: j < kend

  // the query rows' r, k, v and u, and the first tile's k and v, in flight
  // while logw is read (the query sub-blocks are rows of the chunk: one copy
  // each, with the rows past c zero)
  T* qk = reinterpret_cast<T*>(sm + lay.qk);
  float* us = reinterpret_cast<float*>(sm + lay.us);
  for (int s = 0; s < 2; ++s) {
    const int t0 = SB * (s ? it.sub1 : it.sub0), live = s < ns ? min(SB, c - t0) : 0;
    stage_rows<T, N, false>(rr + SB * s * N, N, r + base + (size_t)t0 * rs, rs, live, SB);
    stage_rows<T, N, false>(qk + SB * s * N, N, k + base + (size_t)t0 * rs, rs, live, SB);
    stage_rows<T, N, false>(qv + SB * s * N, N, v + base + (size_t)t0 * rs, rs, live, SB);
  }
  if (tid < N / 4) cp16(us + 4 * tid, uh + 4 * tid);
  if (kend > 0) {
    const int kn = min(kt, kend), kpad = (kn + SB - 1) / SB * SB;
    stage_rows<T, N, true>(kb, LP, k + base, rs, kn, kpad);
    stage_rows<T, N, false>(vs, VP, v + base, rs, kn, kpad);
  }
  boundaries<N>(logw + base, rs, c, thi, Lb);   // Lb[0..thi]

  const int p = lane >> 2, q = lane & 3;   // the lane's key of 8, its n quad
  const bool diag = q == p >> 1, odd = p & 1;   // the lane holding C[p][p]
  const int m = tid % N, rg = tid / N;
  float yc[TPW][4];                      // scores · V on mma: 16 rows x 8 columns a tile
  float yf[RPV];                         // on FFMA: rows rg·RPV.., column m
#pragma unroll
  for (int x = 0; x < TPW; ++x)
#pragma unroll
    for (int i = 0; i < 4; ++i) yc[x][i] = 0.f;
#pragma unroll
  for (int i = 0; i < RPV; ++i) yf[i] = 0.f;

#pragma unroll 1
  for (int j0 = 0; j0 < max(kend, 1); j0 += kt) {
    const int kn = max(0, min(kt, kend - j0)), kpad = (kn + SB - 1) / SB * SB;
    if (j0 > 0) {
      stage_rows<T, N, true>(kb, LP, k + base + (size_t)j0 * rs, rs, kn, kpad);
      stage_rows<T, N, false>(vs, VP, v + base + (size_t)j0 * rs, rs, kn, kpad);
    }
    for (int e = tid; e < QR * scp / 8; e += THREADS)
      reinterpret_cast<uint4*>(sc)[e] = make_uint4(0u, 0u, 0u, 0u);
    const int nq = j0 == 0 ? ns * N : 0;   // the query rows' l_exc with the first tile
    logw_runs<N, 3>(logw + base, rs, c, Lb, le, it.sub0, it.sub1, nq, li, LP, j0, kn,
                    nq + (kpad / SB) * N);
    cp_wait_all();
    __syncthreads();
    if (j0 == 0) {   // the bonus r_t · (u ⊙ k_t), fp32: 8 threads a row, N/8
                     // products each, added in a fixed butterfly
      static_assert(QR * 8 == THREADS, "8 threads a query row");
      const int lr = tid / 8, n0 = (tid % 8) * (N / 8);
      float pb = 0.f;
#pragma unroll
      for (int n = n0; n < n0 + N / 8; ++n)
        pb = fmaf(rt::to_f(rr[lr * N + n]), us[n] * rt::to_f(qk[lr * N + n]), pb);
      pb += __shfl_xor_sync(0xffffffffu, pb, 1);
      pb += __shfl_xor_sync(0xffffffffu, pb, 2);
      pb += __shfl_xor_sync(0xffffffffu, pb, 4);
      if (tid % 8 == 0) bonus[lr] = pb;
    }
    if (kn == 0) break;                  // a chunk of one row: no keys

    // scores: warp w takes rows w and 15 - w of each sub-block (equal
    // work), 8 keys at a time, the row's last group masked
#pragma unroll 1
    for (int x = 0; x < 2 * ns; ++x) {
      const int lr = SB * (x >> 1) + ((x & 1) ? SB - 1 - warp : warp), t = it.row(lr);
      if (t >= c || t <= j0) continue;
      float lv[NS][4];
      unsigned rv[NS][2];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(le + lr * N + 16 * s + 4 * q);
        const uint2 bq = bf16x4(rr + lr * N + 16 * s + 4 * q);
        lv[s][0] = a.x; lv[s][1] = a.y; lv[s][2] = a.z; lv[s][3] = a.w;
        rv[s][0] = bq.x; rv[s][1] = bq.y;
      }
      const int jend = min(t, j0 + kn);
      int j = j0;
#pragma unroll 1
      for (; j + 8 <= jend; j += 8) {
        const int jl = j - j0 + p;
        score_group<N, false>(lv, rv, li + jl * LP + 4 * q, kb + jl * LP + 4 * q, true, diag,
                              odd, sc + lr * scp + jl);
      }
      if (j < jend) {
        const int jl = j - j0 + p;
        score_group<N, true>(lv, rv, li + jl * LP + 4 * q, kb + jl * LP + 4 * q, j + p < t,
                             diag, odd, sc + lr * scp + jl);
      }
    }
    __syncthreads();
    if (j0 + kt >= kend) {               // li is free: the entry state lands during scores · V
      asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the carry's, once a block
      const float* entry = ds + ((size_t)it.bh * nc + it.ch) * N * N;
      float* st = reinterpret_cast<float*>(sm + lay.st);
      for (int e = tid; e < N * N / 4; e += THREADS) cp16(st + 4 * e, entry + 4 * e);
    }

    // scores · V over the tile's keys that each sub-block needs
    if constexpr (MMA_V) {
      const int s = warp & 1, t0 = SB * (s ? it.sub1 : it.sub0);
      const int need = s < ns ? min(kn, t0 + min(SB, c - t0) - 1 - j0) : 0;
#pragma unroll 1
      for (int kk = 0; kk * 16 < need; ++kk) {
        unsigned a[4];
        const int mi = lane >> 3;
        ldsm_x4(a, sc + (SB * s + (lane & 7) + (mi & 1) * 8) * scp + kk * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int x = 0; x < TPW; ++x) {
          const int nt8 = (warp >> 1) + 4 * x;
          if (nt8 < N / 8) {
            unsigned bb[2];
            ldsm_x2_trans(bb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VP + nt8 * 8);
            mma_bf16(yc[x], a[0], a[1], a[2], a[3], bb[0], bb[1]);
          }
        }
      }
    } else {
      const int s = rg * RPV / SB, t0 = SB * (s ? it.sub1 : it.sub0);
      const int need = s < ns ? min(kn, t0 + min(SB, c - t0) - 1 - j0) : 0;
      for (int j = 0; j < need; ++j) {
        const float vv = rt::to_f(vs[j * VP + m]);
#pragma unroll
        for (int i = 0; i < RPV; ++i)
          yf[i] = fmaf(__bfloat162float(sc[(rg * RPV + i) * scp + j]), vv, yf[i]);
      }
    }
    __syncthreads();                     // the tile is consumed
  }
  if (kend <= 0) {                       // a chunk of one row: no tile took the entry state
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const float* entry = ds + ((size_t)it.bh * nc + it.ch) * N * N;
    float* st = reinterpret_cast<float*>(sm + lay.st);
    for (int e = tid; e < N * N / 4; e += THREADS) cp16(st + 4 * e, entry + 4 * e);
  }
  // the intra sums and r ⊙ e^{l_exc} of the rows, then y = intra + bonus · v
  // + (r ⊙ e^{l_exc}) S0, n in order, written once
  const float* st = reinterpret_cast<const float*>(sm + lay.st);
  float* rhs = reinterpret_cast<float*>(sm + lay.rh);
  float* yo = reinterpret_cast<float*>(sm + lay.yo);
  if constexpr (MMA_V) {
    const int s = warp & 1;
    if (s < ns) {
#pragma unroll
      for (int x = 0; x < TPW; ++x) {
        const int nt8 = (warp >> 1) + 4 * x, row = SB * s + p, col = nt8 * 8 + 2 * q;
        if (nt8 < N / 8) {
          yo[row * YP + col] = yc[x][0];
          yo[row * YP + col + 1] = yc[x][1];
          yo[(row + 8) * YP + col] = yc[x][2];
          yo[(row + 8) * YP + col + 1] = yc[x][3];
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RPV; ++i) yo[(rg * RPV + i) * YP + m] = yf[i];
  }
  for (int e = tid; e < QR * N; e += THREADS) {
    const int lr = e / N, n = e % N;
    rhs[e] = it.live(lr, c) ? rt::to_f(rr[e]) * exp_neg(le[lr * N + n]) : 0.f;
  }
  cp_wait_all();
  __syncthreads();
  float acc[RPV];
#pragma unroll
  for (int i = 0; i < RPV; ++i) {
    const int lr = rg * RPV + i;
    acc[i] = fmaf(bonus[lr], rt::to_f(qv[lr * N + m]), yo[lr * YP + m]);
  }
#pragma unroll 4
  for (int n = 0; n < N; n += 4) {
    const float s0 = st[n * N + m], s1 = st[(n + 1) * N + m];
    const float s2 = st[(n + 2) * N + m], s3 = st[(n + 3) * N + m];
#pragma unroll
    for (int i = 0; i < RPV; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(rhs + (rg * RPV + i) * N + n);
      acc[i] = fmaf(a.w, s3, fmaf(a.z, s2, fmaf(a.y, s1, fmaf(a.x, s0, acc[i]))));
    }
  }
#pragma unroll
  for (int i = 0; i < RPV; ++i) {
    const int lr = rg * RPV + i;
    if (it.live(lr, c)) y[base + (size_t)it.row(lr) * rs + m] = acc[i];
  }
}

// At most 112 registers, so that a block fits on an SM beside a state block
// (80 registers a thread) and the carry blocks that wait there, and the
// output pass runs while the state pass does; two blocks an SM after it.
#if __CUDACC_VER_MAJOR__ < 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 4)
#error "rwkv_out_bf16_kernel needs nvcc 12.4 or later (__maxnreg__)"
#endif
// grid (BH · nc · (nb+1)/2): a block an item.
template <typename T, int N>
__global__ void __maxnreg__(112)
rwkv_out_bf16_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ u, const float* __restrict__ ds,
                     float* __restrict__ y, int S, int H, int c) {
  extern __shared__ __align__(16) float smem[];
  const int nb = (c + SB - 1) / SB, nc = S / c, kt = min(KB, SB * nb);
  bf16_item<T, N>(Item(blockIdx.x, nb, nc, S, H, N, c), reinterpret_cast<char*>(smem),
                  LayoutB16<T, N>(nb, kt), kt, r, k, v, logw, u, ds, y, H, c, nc);
}

// Every pair of bf16 values a, b (NaNs skipped): whether mul.rn.bf16x2, the
// exact product rounded once, gives the bits of the product taken in fp32
// and rounded to bf16, as the plain form rounds r ⊗ k. counts[0]: pairs that
// differ; counts[1]: of those, pairs whose fp32 product is normal (>= 2^-126
// in magnitude); first: one differing pair (a << 16 | b), or ~0u.
// grid (256, 256), 256 threads: thread a takes 256 values of b.
__global__ void __launch_bounds__(THREADS)
bf16_product_check_kernel(unsigned long long* counts, unsigned* first) {
  const unsigned a = blockIdx.x * THREADS + threadIdx.x, b0 = blockIdx.y * THREADS;
  const auto is_nan = [](unsigned x) { return (x & 0x7f80u) == 0x7f80u && (x & 0x7fu) != 0u; };
  if (is_nan(a)) return;
  const float fa = __uint_as_float(a << 16);
  unsigned long long bad = 0, bad_normal = 0;
  for (unsigned b = b0; b < b0 + THREADS; b += 2) {
    const unsigned got = mul_bf16x2(a | (a << 16), b | ((b + 1) << 16));
#pragma unroll
    for (unsigned e = 0; e < 2; ++e) {
      const unsigned bb = b + e;
      if (is_nan(bb)) continue;
      const float prod = fa * __uint_as_float(bb << 16);
      const unsigned want = __bfloat16_as_ushort(__float2bfloat16_rn(prod));
      const unsigned g = (got >> (16 * e)) & 0xffffu;
      if (g != want && !(is_nan(g) && is_nan(want))) {
        ++bad;
        bad_normal += fabsf(prod) >= 1.17549435e-38f;
        atomicCAS(first, ~0u, (a << 16) | bb);
      }
    }
  }
  if (bad) {
    atomicAdd(&counts[0], bad);
    atomicAdd(&counts[1], bad_normal);
  }
}

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* state_in, float* ds, float* ltot,
                   float* y, float* state_out, int B, int S, int H, int c, bool bf16,
                   cudaStream_t s) {
  const int nb = (c + SB - 1) / SB, nc = S / c;
  if (B * H == 0) return cudaSuccess;
  if (nc > 65535) return cudaErrorInvalidValue;
  const size_t smem_a = Layout<N>::state_floats(nb) * sizeof(float);
  const size_t smem_c = bf16 ? LayoutB16<T, N>(nb, SB * nb < KB ? SB * nb : KB).total
                            : Layout<N>::out_floats(nb) * sizeof(float);
  cudaError_t err = allow_smem(rwkv_state_kernel<T, N>, smem_a);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory for the state pass, which comes first on
  // an SM: the output pass's blocks can then start beside it
  err = cudaFuncSetAttribute(rwkv_state_kernel<T, N>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (bf16) {
    err = cudaFuncSetAttribute(rwkv_out_bf16_kernel<T, N>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  err = bf16 ? allow_smem(rwkv_out_bf16_kernel<T, N>, smem_c)
             : allow_smem(rwkv_out_kernel<T, N>, smem_c);
  if (err != cudaSuccess) return err;
  rwkv_state_kernel<T, N><<<dim3(B * H, nc), THREADS, smem_a, s>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), logw, ds, ltot, S, H, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((size_t)B * H * N * N / 4 + CARRY_THREADS - 1) / CARRY_THREADS));
  cfg.blockDim = dim3(CARRY_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rwkv_carry_kernel<N>, state_in, ds,
                           static_cast<const float*>(ltot), state_out, B * H, nc);
  if (err != cudaSuccess) return err;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_c;
  if (bf16) {
    cfg.gridDim = dim3((unsigned)((size_t)B * H * nc * ((nb + 1) / 2)));
    err = cudaLaunchKernelEx(&cfg, rwkv_out_bf16_kernel<T, N>, static_cast<const T*>(r),
                             static_cast<const T*>(k), static_cast<const T*>(v), logw, u,
                             static_cast<const float*>(ds), y, S, H, c);
  } else {
    cfg.gridDim = dim3(B * H, nc, (nb + 1) / 2);
    err = cudaLaunchKernelEx(&cfg, rwkv_out_kernel<T, N>, static_cast<const T*>(r),
                             static_cast<const T*>(k), static_cast<const T*>(v), logw, u,
                             static_cast<const float*>(ds), y, S, H, c);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// r, k, v (B,S,H,N) of type `dtype`; logw (B,S,H,N), u (H,N), state_in
// (B,H,N,N) or null (zero state), y (B,S,H,N), state_out (B,H,N,N): fp32.
// Scratch from the caller: ds (B·H·S/chunk·N·N) and ltot (B·H·S/chunk·N)
// fp32. All contiguous. Requires N in {16, 32, 64}, 1 <= chunk <= 1024 and
// S % chunk == 0. bf16_scores != 0 takes the bf16 chunk form's output kernel
// (rwkv_out_bf16_kernel).
// Returns cudaGetLastError() of the launches.
extern "C" int rwkv_chunk_launch(const void* r, const void* k, const void* v,
                                 const float* logw, const float* u,
                                 const float* state_in, float* ds, float* ltot,
                                 float* y, float* state_out, int B, int S, int H,
                                 int N, int chunk, int dtype, int bf16_scores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > CMAX || S % chunk) return cudaErrorInvalidValue;
  const bool bf = bf16_scores != 0;
  RT_DISPATCH(dtype, T, {
    switch (N) {
      case 16: return launch<T, 16>(r, k, v, logw, u, state_in, ds, ltot, y, state_out, B, S, H, chunk, bf, s);
      case 32: return launch<T, 32>(r, k, v, logw, u, state_in, ds, ltot, y, state_out, B, S, H, chunk, bf, s);
      case 64: return launch<T, 64>(r, k, v, logw, u, state_in, ds, ltot, y, state_out, B, S, H, chunk, bf, s);
      default: return cudaErrorInvalidValue;
    }
  });
  return cudaGetLastError();
}

// The packed product's check (bf16_product_check_kernel): counts (2) and
// first (1) from the caller, counts zeroed and first set to ~0u. Returns
// cudaGetLastError() of the launch.
extern "C" int rwkv_bf16_product_check(unsigned long long* counts, unsigned* first,
                                       void* stream) {
  bf16_product_check_kernel<<<dim3(256, 256), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, first);
  return cudaGetLastError();
}
