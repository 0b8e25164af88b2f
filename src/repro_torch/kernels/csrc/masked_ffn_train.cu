// Client-batched masked FFN for training on Hopper (sm_90a): the forward,
// dx and dW of
//   y_c = ((act(x_c·Wg_c) ⊙ x_c·Wi_c) ⊙ row_mask_c) · Wo_c      (gated)
//   y_c = (act(x_c·Wi_c) ⊙ row_mask_c) · Wo_c                    (ungated)
// for C clients at once, each with its own weights and row masks:
// x (C, M, d), Wi/Wg (C, d, F), Wo (C, F, d), row_mask (C, M, F) fp32.
//
// Replaces the Pallas kernels of repro/kernels/masked_ffn.py as the fleet
// runs them under jax.vmap (one grid axis more per client):
//   train_fwd_kernel  <- _fwd_kernel (:107, via _fwd_impl :289)
//   train_dx_kernel   <- _dx_kernel  (:165, via _dx_impl :327)
//   train_dw_kernel   <- _dw_kernel  (:193, via _dw_impl :367)
// with the Pallas semantics: a (8-row m-tile, 128-neuron f-block) tile is
// skipped when no row of the tile keeps any neuron of the block (each
// block ORs the row mask itself, as _prefetch_mask :259 does); kept tiles
// apply the exact per-row mask; the forward rounds the masked hidden
// activation to the input type before the down product (:129); the
// backward recomputes the pre-activations from (x, weights, mask) and
// saves no activations (_bwd_core :144); every sum is fp32.
//
// What bounds it on an H100: at the fleet's widths (d 64, F 1024, M 10 rows
// a client, ungated) a client's forward reads 2·d·F·4 B = 524 KB of fp32
// weights for 2·2·M·d·F = 2.6 MFLOP — 5 FLOP per byte, far below the ridge —
// and at C = 5 clients a whole pass is a few MB: launch latency and the
// serial d-loop of a tile bound it, not bytes. The design keeps every
// operand of a tile's recompute in shared memory (weights staged in d-chunks
// with padded rows, so the neuron-parallel reads are bank-conflict free) and
// spreads tiles over (f-block, m-tile, client) blocks; wgmma/TMA wait.
//
// Hopper has no sequential grid, so the Pallas accumulators revisited
// across the grid become:
//   forward, dx: one block per (f-block, m-tile, client) writes an fp32
//     partial; a second kernel sums the kept f-blocks' partials in fixed
//     f order (no atomics: deterministic).
//   dW: one block per (f-block, d-chunk, client) owns its output tile and
//     loops over the m-tiles itself; a tile no m-tile keeps is written as
//     exact zeros.
// Masks are data: a new mask never means a new build.
#include "common.cuh"

namespace {

using rt::act_f;
using rt::dact_f;

constexpr int BN = 128;          // neurons per f-block (BLOCK_NEURONS)
constexpr int MT = 8;            // rows per m-tile (the Pallas block_m)
constexpr int KC = 16;           // d-chunk staged per step of the recompute
constexpr int DK = 32;           // d-rows of a dW output tile
constexpr int THREADS = 256;
constexpr int LD = BN + 1;       // padded shared-memory row
constexpr int RPT = MT * BN / THREADS;   // rows per thread in the recompute

static_assert(RPT == 4, "recompute maps 256 threads onto 8 rows x 128 neurons");

struct Recompute {
  float xs[MT][KC];
  float gs[MT][KC];
  float wi[KC][LD];
  float wg[KC][LD];
  float wo[KC][LD];              // wo[k][n] = W_out[f0 + n][k0 + k]
};

struct Smem {
  union {
    Recompute r;
    float ot[BN][DK + 1];        // dW_out tile on its way out
  } u;
  float xk[MT][DK];              // dW: x and gy rows of this block's d-chunk
  float gk[MT][DK];
  float a[MT][BN];               // forward: rounded hm; backward: hm
  float b[MT][BN];               // dzh
  float c[MT][BN];               // dzg
};

// Does any row of the m-tile keep any neuron of the f-block? Block-uniform.
__device__ __forceinline__ bool tile_kept(const float* __restrict__ mask_c,
                                          int m0, int rows, int f0, int F) {
  bool any = false;
  for (int e = threadIdx.x; e < rows * BN; e += THREADS)
    any |= mask_c[(size_t)(m0 + e / BN) * F + f0 + e % BN] != 0.f;
  return __syncthreads_or(any);
}

// Recompute one tile's pre-activations from x (and, for the backward, gy)
// and leave in shared memory:
//   forward:  a = round_T(act-and-gate(z) ⊙ mask)
//   backward: a = hm, b = dzh, c = dzg   (repro _bwd_core, fp32)
// Rows past M read as zero with mask 0. Ends with __syncthreads().
template <typename T, bool BWD>
__device__ void recompute(Smem& s, const T* __restrict__ x_c,
                          const T* __restrict__ g_c,
                          const T* __restrict__ wi_c,
                          const T* __restrict__ wg_c,
                          const T* __restrict__ wo_c,
                          const float* __restrict__ mask_c, int m0, int rows,
                          int f0, int d, int F, int act) {
  const int tid = threadIdx.x, n = tid % BN, r0 = (tid / BN) * RPT;
  const bool gated = wg_c != nullptr;
  float zh[RPT], zg[RPT], gh[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) zh[i] = zg[i] = gh[i] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    const int kn = min(KC, d - k0);
    __syncthreads();                       // previous chunk consumed
    for (int e = tid; e < MT * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const bool in = r < rows && k < kn;
      const size_t at = (size_t)(m0 + r) * d + k0 + k;
      s.u.r.xs[r][k] = in ? rt::to_f(x_c[at]) : 0.f;
      if (BWD) s.u.r.gs[r][k] = in ? rt::to_f(g_c[at]) : 0.f;
    }
    for (int e = tid; e < KC * BN; e += THREADS) {
      const int k = e / BN, nn = e % BN;
      const size_t at = (size_t)(k0 + k) * F + f0 + nn;
      s.u.r.wi[k][nn] = k < kn ? rt::to_f(wi_c[at]) : 0.f;
      if (gated) s.u.r.wg[k][nn] = k < kn ? rt::to_f(wg_c[at]) : 0.f;
    }
    if (BWD) {                             // W_out rows, transposed
      for (int e = tid; e < KC * BN; e += THREADS) {
        const int nn = e / KC, k = e % KC;
        s.u.r.wo[k][nn] = k < kn ? rt::to_f(wo_c[(size_t)(f0 + nn) * d + k0 + k]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float wi = s.u.r.wi[k][n];
      const float wg = gated ? s.u.r.wg[k][n] : 0.f;
      const float wo = BWD ? s.u.r.wo[k][n] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float xv = s.u.r.xs[r0 + i][k];
        zh[i] = fmaf(xv, wi, zh[i]);
        if (gated) zg[i] = fmaf(xv, wg, zg[i]);
        if (BWD) gh[i] = fmaf(s.u.r.gs[r0 + i][k], wo, gh[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i;
    const float rm = r < rows ? mask_c[(size_t)(m0 + r) * F + f0 + n] : 0.f;
    if (!BWD) {
      const float v = gated ? act_f(zg[i], act) * zh[i] : act_f(zh[i], act);
      s.a[r][n] = rt::to_f(rt::from_f<T>(rm != 0.f ? v * rm : 0.f));
    } else {
      const float ghm = gh[i] * rm;
      float hm, dzh, dzg = 0.f;
      if (gated) {
        const float a = act_f(zg[i], act);
        hm = a * zh[i];
        dzh = ghm * a;
        dzg = ghm * zh[i] * dact_f(zg[i], act);
      } else {
        hm = act_f(zh[i], act);
        dzh = ghm * dact_f(zh[i], act);
      }
      s.a[r][n] = hm * rm;
      s.b[r][n] = dzh;
      s.c[r][n] = dzg;
    }
  }
  __syncthreads();
}

// grid (f-blocks, m-tiles, clients). part: (nfb, C, M, d) fp32;
// keep: (C, m-tiles, nfb) int32, read by the reduce.
template <typename T>
__global__ void __launch_bounds__(THREADS)
train_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                 const T* __restrict__ w_gate, const T* __restrict__ w_out,
                 const float* __restrict__ mask, int* __restrict__ keep,
                 float* __restrict__ part, int M, int d, int F, int act) {
  __shared__ Smem s;
  const int fb = blockIdx.x, mt = blockIdx.y, c = blockIdx.z;
  const int nfb = gridDim.x, nmt = gridDim.y, C = gridDim.z;
  const int m0 = mt * MT, rows = min(MT, M - m0), f0 = fb * BN;
  const size_t dF = (size_t)d * F;
  const float* mask_c = mask + (size_t)c * M * F;

  const bool kept = tile_kept(mask_c, m0, rows, f0, F);
  if (threadIdx.x == 0) keep[((size_t)c * nmt + mt) * nfb + fb] = kept;
  if (!kept) return;
  recompute<T, false>(s, x + (size_t)c * M * d, nullptr, w_in + c * dF,
                      w_gate ? w_gate + c * dF : nullptr, nullptr, mask_c,
                      m0, rows, f0, d, F, act);

  // down product of the kept block: thread (column k, 2 rows)
  const T* wo = w_out + c * dF + (size_t)f0 * d;
  const int r0 = (threadIdx.x / 64) * 2;
  for (int k = threadIdx.x % 64; k < d; k += 64) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
    for (int n = 0; n < BN; ++n) {
      const float w = rt::to_f(wo[(size_t)n * d + k]);
      acc0 = fmaf(s.a[r0][n], w, acc0);
      acc1 = fmaf(s.a[r0 + 1][n], w, acc1);
    }
    float* dst = part + (((size_t)fb * C + c) * M + m0 + r0) * d + k;
    if (r0 < rows) dst[0] = acc0;
    if (r0 + 1 < rows) dst[d] = acc1;
  }
}

// grid (f-blocks, m-tiles, clients); same partial layout as the forward.
template <typename T>
__global__ void __launch_bounds__(THREADS)
train_dx_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                const T* __restrict__ w_in, const T* __restrict__ w_gate,
                const T* __restrict__ w_out, const float* __restrict__ mask,
                int* __restrict__ keep, float* __restrict__ part,
                int M, int d, int F, int act) {
  __shared__ Smem s;
  const int fb = blockIdx.x, mt = blockIdx.y, c = blockIdx.z;
  const int nfb = gridDim.x, nmt = gridDim.y, C = gridDim.z;
  const int m0 = mt * MT, rows = min(MT, M - m0), f0 = fb * BN;
  const size_t dF = (size_t)d * F;
  const float* mask_c = mask + (size_t)c * M * F;
  const T* wi_c = w_in + c * dF;
  const T* wg_c = w_gate ? w_gate + c * dF : nullptr;

  const bool kept = tile_kept(mask_c, m0, rows, f0, F);
  if (threadIdx.x == 0) keep[((size_t)c * nmt + mt) * nfb + fb] = kept;
  if (!kept) return;
  recompute<T, true>(s, x + (size_t)c * M * d, gy + (size_t)c * M * d, wi_c,
                     wg_c, w_out + c * dF, mask_c, m0, rows, f0, d, F, act);

  // dx[r][k] = Σ_n dzh[r][n]·W_in[k][f0+n] + dzg[r][n]·W_gate[k][f0+n]:
  // W_in/W_gate rows staged KC at a time; thread (k, row, half of the
  // block's neurons), the two halves summed in fixed order
  const int tid = threadIdx.x, k = tid % KC, r = (tid / KC) % MT;
  const int half = tid / (KC * MT), nb = half * (BN / 2);
  float* pair = &s.u.r.xs[0][0];         // MT*KC floats, free after recompute
  for (int k0 = 0; k0 < d; k0 += KC) {
    const int kn = min(KC, d - k0);
    __syncthreads();
    for (int e = tid; e < KC * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const size_t at = (size_t)(k0 + kk) * F + f0 + nn;
      s.u.r.wi[kk][nn] = kk < kn ? rt::to_f(wi_c[at]) : 0.f;
      if (wg_c) s.u.r.wg[kk][nn] = kk < kn ? rt::to_f(wg_c[at]) : 0.f;
    }
    __syncthreads();
    float acc = 0.f;
#pragma unroll 8
    for (int n = nb; n < nb + BN / 2; ++n) {
      acc = fmaf(s.b[r][n], s.u.r.wi[k][n], acc);
      if (wg_c) acc = fmaf(s.c[r][n], s.u.r.wg[k][n], acc);
    }
    if (half == 1) pair[r * KC + k] = acc;
    __syncthreads();
    if (half == 0 && r < rows && k < kn)
      part[(((size_t)fb * C + c) * M + m0 + r) * d + k0 + k] = acc + pair[r * KC + k];
  }
}

// out[c][m][k] = Σ over the kept f-blocks of part[fb][c][m][k], f in order.
template <typename T>
__global__ void reduce_fb_kernel(const float* __restrict__ part,
                                 const int* __restrict__ keep,
                                 T* __restrict__ out, int C, int M, int d,
                                 int nfb) {
  const size_t total = (size_t)C * M * d;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e / ((size_t)M * d)), m = (int)(e / d % M);
  const int nmt = (M + MT - 1) / MT;
  const int* kp = keep + ((size_t)c * nmt + m / MT) * nfb;
  float acc = 0.f;
  for (int fb = 0; fb < nfb; ++fb)
    if (kp[fb]) acc += part[fb * total + e];
  out[e] = rt::from_f<T>(acc);
}

// grid (f-blocks, d-chunks of DK, clients). Each block owns
// dW_in/dW_gate[c][k0:k0+DK][f0:f0+128] and dW_out[c][f0:f0+128][k0:k0+DK]
// and sums over the kept m-tiles in order; a block no m-tile keeps writes
// zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
train_dw_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                const T* __restrict__ w_in, const T* __restrict__ w_gate,
                const T* __restrict__ w_out, const float* __restrict__ mask,
                T* __restrict__ dw_in, T* __restrict__ dw_gate,
                T* __restrict__ dw_out, int M, int d, int F, int act) {
  __shared__ Smem s;
  const int fb = blockIdx.x, kc0 = blockIdx.y * DK, c = blockIdx.z;
  const int f0 = fb * BN, nmt = (M + MT - 1) / MT;
  const size_t dF = (size_t)d * F;
  const bool gated = w_gate != nullptr;
  const float* mask_c = mask + (size_t)c * M * F;
  const T* x_c = x + (size_t)c * M * d;
  const T* g_c = gy + (size_t)c * M * d;
  const int tid = threadIdx.x, n = tid % BN, kb = (tid / BN) * (DK / 2);

  float a_in[DK / 2], a_g[DK / 2], a_out[DK / 2];
#pragma unroll
  for (int j = 0; j < DK / 2; ++j) a_in[j] = a_g[j] = a_out[j] = 0.f;

  for (int mt = 0; mt < nmt; ++mt) {
    const int m0 = mt * MT, rows = min(MT, M - m0);
    if (!tile_kept(mask_c, m0, rows, f0, F)) continue;
    recompute<T, true>(s, x_c, g_c, w_in + c * dF,
                       gated ? w_gate + c * dF : nullptr, w_out + c * dF,
                       mask_c, m0, rows, f0, d, F, act);
    for (int e = tid; e < MT * DK; e += THREADS) {
      const int r = e / DK, k = e % DK;
      const bool in = r < rows && kc0 + k < d;
      const size_t at = (size_t)(m0 + r) * d + kc0 + k;
      s.xk[r][k] = in ? rt::to_f(x_c[at]) : 0.f;
      s.gk[r][k] = in ? rt::to_f(g_c[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float hm = s.a[r][n], dzh = s.b[r][n], dzg = s.c[r][n];
#pragma unroll
      for (int j = 0; j < DK / 2; ++j) {
        const float xv = s.xk[r][kb + j];
        a_in[j] = fmaf(xv, dzh, a_in[j]);
        if (gated) a_g[j] = fmaf(xv, dzg, a_g[j]);
        a_out[j] = fmaf(hm, s.gk[r][kb + j], a_out[j]);
      }
    }
  }

  // dW_in / dW_gate rows: neighbouring threads write neighbouring neurons
  T* di = dw_in + c * dF + f0 + n;
  T* dg = gated ? dw_gate + c * dF + f0 + n : nullptr;
#pragma unroll
  for (int j = 0; j < DK / 2; ++j) {
    const int k = kc0 + kb + j;
    if (k < d) {
      di[(size_t)k * F] = rt::from_f<T>(a_in[j]);
      if (gated) dg[(size_t)k * F] = rt::from_f<T>(a_g[j]);
    }
  }
  // dW_out rows are d wide: transpose through shared memory
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DK / 2; ++j) s.u.ot[n][kb + j] = a_out[j];
  __syncthreads();
  T* dout = dw_out + c * dF + (size_t)f0 * d;
  for (int e = tid; e < BN * DK; e += THREADS) {
    const int nn = e / DK, k = e % DK;
    if (kc0 + k < d) dout[(size_t)nn * d + kc0 + k] = rt::from_f<T>(s.u.ot[nn][k]);
  }
}

cudaError_t reduce(const float* part, const int* keep, void* out, int C,
                   int M, int d, int nfb, int dtype, cudaStream_t s) {
  const size_t total = (size_t)C * M * d;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  RT_DISPATCH(dtype, T, {
    reduce_fb_kernel<T><<<blocks, 256, 0, s>>>(part, keep, static_cast<T*>(out),
                                              C, M, d, nfb);
  });
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers of row-major arrays; x, gy, the weights
// and the outputs are of type `dtype`, mask is fp32; w_gate (and dw_gate)
// may be null (ungated). Scratch from the caller: keep (C, ceil(M/8), F/128)
// int32 and part (F/128, C, M, d) fp32. F % 128 == 0. Each returns
// cudaGetLastError() after its launches; none allocates or synchronises.
extern "C" int masked_ffn_train_fwd_launch(
    const void* x, const void* w_in, const void* w_gate, const void* w_out,
    const float* mask, int* keep, float* part, void* y,
    int C, int M, int d, int F, int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nfb = F / BN, nmt = (M + MT - 1) / MT;
  RT_DISPATCH(dtype, T, {
    train_fwd_kernel<T><<<dim3(nfb, nmt, C), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w_in),
        static_cast<const T*>(w_gate), static_cast<const T*>(w_out), mask,
        keep, part, M, d, F, act);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(part, keep, y, C, M, d, nfb, dtype, s);
}

extern "C" int masked_ffn_dx_launch(
    const void* gy, const void* x, const void* w_in, const void* w_gate,
    const void* w_out, const float* mask, int* keep, float* part, void* dx,
    int C, int M, int d, int F, int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nfb = F / BN, nmt = (M + MT - 1) / MT;
  RT_DISPATCH(dtype, T, {
    train_dx_kernel<T><<<dim3(nfb, nmt, C), THREADS, 0, s>>>(
        static_cast<const T*>(gy), static_cast<const T*>(x),
        static_cast<const T*>(w_in), static_cast<const T*>(w_gate),
        static_cast<const T*>(w_out), mask, keep, part, M, d, F, act);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(part, keep, dx, C, M, d, nfb, dtype, s);
}

extern "C" int masked_ffn_dw_launch(
    const void* gy, const void* x, const void* w_in, const void* w_gate,
    const void* w_out, const float* mask, void* dw_in, void* dw_gate,
    void* dw_out, int C, int M, int d, int F, int act, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nfb = F / BN;
  RT_DISPATCH(dtype, T, {
    train_dw_kernel<T><<<dim3(nfb, (d + DK - 1) / DK, C), THREADS, 0, s>>>(
        static_cast<const T*>(gy), static_cast<const T*>(x),
        static_cast<const T*>(w_in), static_cast<const T*>(w_gate),
        static_cast<const T*>(w_out), mask, static_cast<T*>(dw_in),
        static_cast<T*>(dw_gate), static_cast<T*>(dw_out), M, d, F, act);
  });
  return cudaGetLastError();
}
