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

// The bf16 chunk form (the reference's rwkv_chunk_dtype="bfloat16",
// repro/models/rwkv6.py::_chunk_core :131-134): there D is rounded to bf16,
// and jnp.einsum contracts r, k and D pairwise, r ⊗ k first, each result
// rounded to bf16. So the score of query t and key j < t is
//
//   s_tj = bf16( Σ_n bf16(bf16(r_tn) · bf16(k_jn)) · bf16(e^{l_exc,tn - l_inc,jn}) )
//
// with the sum over n in fp32 (each product of two bf16 values is exact in
// fp32). The factored form of rwkv_out_kernel cannot round each (t, j, n)'s
// exponential, so this kernel takes them literally: c(c-1)/2·N a chunk and
// head. The bonus (j == t) and the inter term stay fp32, as in the
// reference; the state pass and the carry are those of the fp32 form.
// grid (B·H, chunks, nb): a block a 16-row sub-block sb of a chunk, its keys
// 0 .. t0+nt-1 in tiles of KT; launched as a programmatic dependent of
// rwkv_carry_kernel, whose entry states it reads after griddepcontrol.wait.
template <int N> struct LayoutBf16 {
  static constexpr int P = N + 4;
  static size_t floats(int nb) {
    return (size_t)(nb + 1) * N + 2 * SB * P + N * SB + KT * SB + 3 * KT * P;
  }
  static_assert(KT * P >= N * N, "the entry state reuses the key tile");
};

__device__ __forceinline__ float bf16r(float x) {   // round to bf16, nearest even
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
rwkv_out_bf16_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ u, const float* __restrict__ ds,
                     float* __restrict__ y, int S, int H, int c) {
  constexpr int P = LayoutBf16<N>::P, RPT = N / 16, EPT = N * N / THREADS;
  constexpr int KQ = KT * SB / THREADS;  // (t, j) pairs a thread scores in a tile
  static_assert(KQ * THREADS == KT * SB && THREADS % SB == 0, "pairs split evenly");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y, sb = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int t0 = SB * sb, nt = min(SB, c - t0);
  float* Lb = smem;                     // (sb + 1, N) boundaries
  float* rr = Lb + ((c + SB - 1) / SB + 1) * N;   // (SB, P) r
  float* le = rr + SB * P;              // (SB, P) logw, then l_exc
  float* rh = le + SB * P;              // (N, SB) (r ⊙ e^{l_exc})ᵀ
  float* pt = rh + N * SB;              // (KT, SB) scores, key-major
  float* kk = pt + KT * SB;             // (KT, P) k
  float* li = kk + KT * P;              // (KT, P) l_inc of the keys
  float* vt = li + KT * P;              // (KT, P) v
  float* st = kk;                       // (N, N) entry state, over kk at the end
  const size_t rs = (size_t)H * N;
  const size_t base = ((size_t)b * S + (size_t)ch * c) * rs + (size_t)h * N;
  const float* uh = u + (size_t)h * N;

  boundaries<N>(logw + base, rs, c, sb, Lb);   // Lb[0..sb]
  for (int e = tid; e < SB * N; e += THREADS) {
    const int i = e / N, n = e % N;
    const bool in = i < nt;
    const size_t g = base + (size_t)(t0 + i) * rs + n;
    rr[i * P + n] = in ? rt::to_f(r[g]) : 0.f;
    le[i * P + n] = in ? logw[g] : 0.f;
  }
  __syncthreads();
  if (tid < N) {                        // l_exc of the query rows, from the boundary
    const int n = tid;
    float run = 0.f;
    const float lT = Lb[sb * N + n];
    for (int i = 0; i < nt; ++i) {
      const float w = le[i * P + n];
      le[i * P + n] = lT + run;
      run += w;
    }
  }
  __syncthreads();
  for (int e = tid; e < SB * N; e += THREADS) {
    const int i = e / N, n = e % N;
    rh[n * SB + i] = rr[i * P + n] * exp_neg(le[i * P + n]);
  }

  const int m = tid % N, rg = tid / N;  // output column; rows rg·RPT..
  float yacc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) yacc[i] = 0.f;
  const int tq = tid % SB, jq = tid / SB;   // the thread's query row; keys jq + (THREADS/SB)·q
  for (int j0 = 0; j0 < t0 + nt; j0 += KT) {
    const int kn = min(KT, t0 + nt - j0);
    __syncthreads();                    // pt, kk, li, vt are consumed
    for (int e = tid; e < kn * N; e += THREADS) {
      const int j = e / N, n = e % N;
      const size_t g = base + (size_t)(j0 + j) * rs + n;
      kk[j * P + n] = rt::to_f(k[g]);
      vt[j * P + n] = rt::to_f(v[g]);
    }
    for (int e = tid; e < (KT / SB) * N; e += THREADS) {   // l_inc, a sub-block's run
      const int jl = e / N, n = e % N;
      const int rows = min(SB, kn - SB * jl);
      if (rows > 0) {
        const int J = j0 / SB + jl;
        const size_t g0 = base + (size_t)(j0 + SB * jl) * rs + n;
        float run = 0.f;
        for (int i = 0; i < rows; ++i) {
          run += logw[g0 + i * rs];
          li[(SB * jl + i) * P + n] = Lb[J * N + n] + run;
        }
      }
    }
    __syncthreads();
    {
      int kind[KQ];                     // 0 none, 1 below the diagonal, 2 the bonus
      float acc[KQ];
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        const int j = jq + (THREADS / SB) * q, jg = j0 + j, tg = t0 + tq;
        kind[q] = (tq >= nt || j >= kn || jg > tg) ? 0 : (jg < tg ? 1 : 2);
        acc[q] = 0.f;
      }
      for (int n = 0; n < N; ++n) {
        const float rv = rr[tq * P + n], rb = bf16r(rv), lv = le[tq * P + n];
#pragma unroll
        for (int q = 0; q < KQ; ++q) {
          const int j = jq + (THREADS / SB) * q;
          if (kind[q] == 1) {
            const float kv = kk[j * P + n];
            const float rk = bf16r(rb * bf16r(kv));
            acc[q] = fmaf(rk, bf16r(exp_neg(lv - li[j * P + n])), acc[q]);
          } else if (kind[q] == 2) {
            acc[q] = fmaf(rv, uh[n] * kk[j * P + n], acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        const int j = jq + (THREADS / SB) * q;
        pt[j * SB + tq] = kind[q] == 1 ? bf16r(acc[q]) : acc[q];
      }
    }
    __syncthreads();
    accumulate<RPT>(yacc, pt, vt, P, kn, rg, m);
  }

  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();                      // kk is free
  const float* entry = ds + ((size_t)bh * nc + ch) * N * N;
#pragma unroll
  for (int i = 0; i < EPT; ++i) st[tid + i * THREADS] = entry[tid + i * THREADS];
  __syncthreads();
  accumulate<RPT>(yacc, rh, st, N, N, rg, m);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = rg * RPT + i;
    if (t < nt) y[base + (size_t)(t0 + t) * rs + m] = yacc[i];
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
  const size_t smem_c = (bf16 ? LayoutBf16<N>::floats(nb) : Layout<N>::out_floats(nb))
                        * sizeof(float);
  cudaError_t err = allow_smem(rwkv_state_kernel<T, N>, smem_a);
  if (err != cudaSuccess) return err;
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
  cfg.gridDim = dim3(B * H, nc, bf16 ? nb : (nb + 1) / 2);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_c;
  err = cudaLaunchKernelEx(&cfg, bf16 ? rwkv_out_bf16_kernel<T, N> : rwkv_out_kernel<T, N>,
                           static_cast<const T*>(r), static_cast<const T*>(k),
                           static_cast<const T*>(v), logw, u,
                           static_cast<const float*>(ds), y, S, H, c);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// r, k, v (B,S,H,N) of type `dtype`; logw (B,S,H,N), u (H,N), state_in
// (B,H,N,N) or null (zero state), y (B,S,H,N), state_out (B,H,N,N): fp32.
// Scratch from the caller: ds (B·H·S/chunk·N·N) and ltot (B·H·S/chunk·N)
// fp32. All contiguous. Requires N in {16, 32, 64}, 1 <= chunk <= 1024 and
// S % chunk == 0. bf16_scores != 0 takes the bf16 chunk form's output kernel
// (rwkv_out_bf16_kernel). Returns cudaGetLastError() of the launches.
extern "C" int rwkv_chunk_launch(const void* r, const void* k, const void* v,
                                 const float* logw, const float* u,
                                 const float* state_in, float* ds, float* ltot,
                                 float* y, float* state_out, int B, int S, int H,
                                 int N, int chunk, int dtype, int bf16_scores,
                                 void* stream) {
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
