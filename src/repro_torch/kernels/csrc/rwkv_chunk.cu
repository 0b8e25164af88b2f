// Chunked RWKV-6 WKV recurrence (forward), for Hopper (sm_90a). Replaces the
// Pallas kernel repro/kernels/rwkv_chunk.py::_kernel (rwkv_chunk_scan :76).
// Per (batch row b, head h), with head dim N and log decay logw < 0:
//
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_tᵀ
//   y_t = r_tᵀ S_{t-1} + (r_t · (u ⊙ k_t)) v_t
//
// computed chunk by chunk as repro/models/rwkv6.py::_chunk_core does, with
// l_inc = cumsum(logw) and l_exc = l_inc - logw inside the chunk:
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
// ~6.3 us at 67 TFLOP/s, against ~19 MB of traffic, ~5.7 us. This chunked
// form does more: c(c-1)/2·N = 0.52 M exponentials per chunk and head, 86
// M a launch (~20 us at 16 a clock on each of 132 SMs), and ~0.85 GFLOP.
// Only B·H = 40 blocks run on 132 SMs.
//
// Design: one block per (b, h); the Pallas grid's sequential chunk axis is
// a loop inside the block, and the (N, N) fp32 state lives in shared
// memory for the whole sequence (nothing carries between blocks). A chunk's
// r, k, v (widened to fp32), l_inc and l_exc sit in shared memory (160 KB
// at c 128, N 64, plus the 16 KB state and a 16 KB score tile). Query rows
// go in tiles of TT: each thread scores one key j against 16 query rows,
// holding k_j and l_inc,j four n at a time in registers while the query
// rows' r and l_exc are read as broadcasts; exponents past the diagonal
// are clamped to 0 and their scores dropped. The tile's scores then meet
// v and the state, one output column per thread. After the last tile the
// state advances in place. All sums are fp32 FMAs in a fixed order; no
// atomics. Splitting a chunk's intra work across blocks (only the state
// carry is serial) is the next step. Nothing is allocated here.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CMAX = 128;               // largest chunk
constexpr int TT = 32;                  // query rows per score tile
constexpr int KEYS = 128;               // key lanes of the score phase (= CMAX)
constexpr int QPT = TT / (THREADS / KEYS);   // query rows each thread scores: 16
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp_nat(float x) { return exp2f(x * LOG2E); }

template <int N> struct Layout {
  static constexpr int P = N + 4;       // padded row: 16-byte aligned, no bank conflicts
  static size_t bytes(int c) {
    return sizeof(float) * (5 * (size_t)c * P + (size_t)N * N + (size_t)TT * c + TT);
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
rwkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ state_in,
                  float* __restrict__ y, float* __restrict__ state_out,
                  int S, int H, int c) {
  constexpr int P = Layout<N>::P;
  constexpr int NT = THREADS / N;       // row groups in the output phases
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                     // (c, P) r, then r ⊙ e^{l_exc}
  float* sk = sr + c * P;               // (c, P) k, then k ⊙ e^{l_tot - l_inc}
  float* sv = sk + c * P;               // (c, P)
  float* sli = sv + c * P;              // (c, P) l_inc
  float* sle = sli + c * P;             // (c, P) logw, then l_exc
  float* st = sle + c * P;              // (N, N) state
  float* sa = st + N * N;               // (TT, c) scores of a query tile
  float* sdiag = sa + TT * c;           // (TT,) bonus dots

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const size_t row_stride = (size_t)H * N;          // between tokens
  const size_t base = ((size_t)b * S * H + h) * N;  // token 0 of (b, h)
  const float* uh = u + (size_t)h * N;

  for (int e = tid; e < N * N; e += THREADS)
    st[e] = state_in ? state_in[((size_t)blockIdx.x) * N * N + e] : 0.f;

  for (int cs = 0; cs < S; cs += c) {
    __syncthreads();                    // the previous chunk is done with smem
    for (int e = tid; e < c * N; e += THREADS) {
      const int t = e / N, n = e % N;
      const size_t g = base + (size_t)(cs + t) * row_stride + n;
      sr[t * P + n] = rt::to_f(r[g]);
      sk[t * P + n] = rt::to_f(k[g]);
      sv[t * P + n] = rt::to_f(v[g]);
      sle[t * P + n] = logw[g];
    }
    __syncthreads();
    if (tid < N) {                      // l_inc = cumsum(logw), l_exc = l_inc - logw
      float run = 0.f;
      for (int t = 0; t < c; ++t) {
        const float w = sle[t * P + tid];
        run += w;
        sli[t * P + tid] = run;
        sle[t * P + tid] = run - w;
      }
    }
    __syncthreads();

    for (int t0 = 0; t0 < c; t0 += TT) {
      const int tend = min(t0 + TT, c);           // rows [t0, tend) of this tile
      // --- scores A[t][j] = Σ_n r_tn k_jn e^{l_exc,tn - l_inc,jn}, j < t
      {
        const int j = tid % KEYS;
        const int tq = t0 + (tid / KEYS) * QPT;   // this thread's first query row
        const int tlast = min(tq + QPT, tend) - 1;
        if (tq < tend && j < tlast) {             // key j scores some row t > j
          float acc[QPT];
#pragma unroll
          for (int i = 0; i < QPT; ++i) acc[i] = 0.f;
          for (int n = 0; n < N; n += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(sk + j * P + n);
            const float4 ll = *reinterpret_cast<const float4*>(sli + j * P + n);
#pragma unroll
            for (int i = 0; i < QPT; ++i) {
              const int t = min(tq + i, c - 1);
              const float4 rr = *reinterpret_cast<const float4*>(sr + t * P + n);
              const float4 ee = *reinterpret_cast<const float4*>(sle + t * P + n);
              float a = acc[i];
              a = fmaf(rr.x * kk.x, exp_nat(fminf(ee.x - ll.x, 0.f)), a);
              a = fmaf(rr.y * kk.y, exp_nat(fminf(ee.y - ll.y, 0.f)), a);
              a = fmaf(rr.z * kk.z, exp_nat(fminf(ee.z - ll.z, 0.f)), a);
              a = fmaf(rr.w * kk.w, exp_nat(fminf(ee.w - ll.w, 0.f)), a);
              acc[i] = a;
            }
          }
          // only entries j < t are read below
#pragma unroll
          for (int i = 0; i < QPT; ++i) {
            const int t = tq + i;
            if (j < t && t < tend) sa[(t - t0) * c + j] = acc[i];
          }
        }
      }
      // --- bonus dots r_t · (u ⊙ k_t), one warp per row
      for (int t = t0 + tid / 32; t < tend; t += THREADS / 32) {
        float s = 0.f;
        for (int n = tid % 32; n < N; n += 32)
          s = fmaf(sr[t * P + n], uh[n] * sk[t * P + n], s);
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (tid % 32 == 0) sdiag[t - t0] = s;
      }
      __syncthreads();
      // --- the tile's r is used up: r ⊙ e^{l_exc} in place, for the inter term
      for (int e = tid; e < (tend - t0) * N; e += THREADS) {
        const int t = t0 + e / N, n = e % N;
        sr[t * P + n] *= exp_nat(sle[t * P + n]);
      }
      __syncthreads();
      // --- y_t = inter + intra + bonus, one column m per thread
      {
        const int m = tid % N;
        for (int t = t0 + tid / N; t < tend; t += NT) {
          float inter = 0.f;
          for (int n = 0; n < N; ++n) inter = fmaf(sr[t * P + n], st[n * N + m], inter);
          float intra = 0.f;
          const float* arow = sa + (t - t0) * c;
          for (int jj = 0; jj < t; ++jj) intra = fmaf(arow[jj], sv[jj * P + m], intra);
          float out = inter + intra;
          out = fmaf(sdiag[t - t0], sv[t * P + m], out);
          y[base + (size_t)(cs + t) * row_stride + m] = out;
        }
      }
      __syncthreads();                  // sa, sdiag are rewritten by the next tile
    }

    // --- state: S1 = e^{l_tot} ⊙ S0 + Σ_j (k_j ⊙ e^{l_tot - l_inc,j}) v_jᵀ
    const float* ltot = sli + (c - 1) * P;
    for (int e = tid; e < c * N; e += THREADS) {
      const int t = e / N, n = e % N;
      sk[t * P + n] *= exp_nat(ltot[n] - sli[t * P + n]);
    }
    __syncthreads();
    {
      constexpr int RPT = N / NT;       // state rows per thread, contiguous
      const int m = tid % N, n0 = (tid / N) * RPT;
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      for (int jj = 0; jj < c; ++jj) {
        const float vv = sv[jj * P + m];
        const float* kr = sk + jj * P + n0;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = fmaf(kr[i], vv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = n0 + i;
        st[n * N + m] = exp_nat(ltot[n]) * st[n * N + m] + acc[i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += THREADS)
    state_out[((size_t)blockIdx.x) * N * N + e] = st[e];
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* state_in, float* y, float* state_out,
                   int B, int S, int H, int c, cudaStream_t s) {
  const size_t smem = Layout<N>::bytes(c);
  cudaError_t err = cudaFuncSetAttribute(rwkv_chunk_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  rwkv_chunk_kernel<T, N><<<B * H, THREADS, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      logw, u, state_in, y, state_out, S, H, c);
  return cudaGetLastError();
}

}  // namespace

// r, k, v (B,S,H,N) of type `dtype`; logw (B,S,H,N), u (H,N), state_in
// (B,H,N,N) or null (zero state), y (B,S,H,N), state_out (B,H,N,N): fp32.
// All contiguous. Requires N in {16, 32, 64}, 1 <= chunk <= 128 and
// S % chunk == 0. Returns cudaGetLastError() of the launch.
extern "C" int rwkv_chunk_launch(const void* r, const void* k, const void* v,
                                 const float* logw, const float* u,
                                 const float* state_in, float* y, float* state_out,
                                 int B, int S, int H, int N, int chunk, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > CMAX || S % chunk) return cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    switch (N) {
      case 16: return launch<T, 16>(r, k, v, logw, u, state_in, y, state_out, B, S, H, chunk, s);
      case 32: return launch<T, 32>(r, k, v, logw, u, state_in, y, state_out, B, S, H, chunk, s);
      case 64: return launch<T, 64>(r, k, v, logw, u, state_in, y, state_out, B, S, H, chunk, s);
      default: return cudaErrorInvalidValue;
    }
  });
  return cudaGetLastError();
}
