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
// serial d-loop of a tile bound it, not bytes. At femnist_attn's FFN (M 490
// rows a client, F 256) the dW is 0.32 GFLOP over 62 m-tiles a client,
// 4.9 us of fp32 FMA at 67 TFLOP/s: there the work must spread over the
// card's SMs, which a block per (f-block, client) did not (20 blocks). The
// forward and dx keep every operand of a tile's recompute in shared memory
// (weights staged in d-chunks with padded rows, so the neuron-parallel
// reads are bank-conflict free) and spread tiles over (f-block, m-tile,
// client) blocks; wgmma/TMA wait.
//
// Hopper has no sequential grid, so the Pallas accumulators revisited
// across the grid become:
//   forward, dx: one block per (f-block, m-tile, client) writes an fp32
//     partial; a second kernel sums the kept f-blocks' partials in fixed
//     f order (no atomics: deterministic).
//   dW: a (client, f-block) pair's m-tiles are split over G blocks that
//     keep the f-block's weight slab in shared memory; their fp32 partials
//     are added in m-tile order through an fp32 scratch and a second
//     kernel (train_dw_kernel, below); an f-block no m-tile keeps is
//     written as exact zeros.
// Masks are data: a new mask never means a new build.
#include "common.cuh"

namespace {

using rt::act_f;
using rt::dact_f;

constexpr int BN = 128;          // neurons per f-block (BLOCK_NEURONS)
constexpr int MT = 8;            // rows per m-tile (the Pallas block_m)
constexpr int KC = 16;           // d-chunk staged per step of the recompute
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
  Recompute r;
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
      s.r.xs[r][k] = in ? rt::to_f(x_c[at]) : 0.f;
      if (BWD) s.r.gs[r][k] = in ? rt::to_f(g_c[at]) : 0.f;
    }
    for (int e = tid; e < KC * BN; e += THREADS) {
      const int k = e / BN, nn = e % BN;
      const size_t at = (size_t)(k0 + k) * F + f0 + nn;
      s.r.wi[k][nn] = k < kn ? rt::to_f(wi_c[at]) : 0.f;
      if (gated) s.r.wg[k][nn] = k < kn ? rt::to_f(wg_c[at]) : 0.f;
    }
    if (BWD) {                             // W_out rows, transposed
      for (int e = tid; e < KC * BN; e += THREADS) {
        const int nn = e / KC, k = e % KC;
        s.r.wo[k][nn] = k < kn ? rt::to_f(wo_c[(size_t)(f0 + nn) * d + k0 + k]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float wi = s.r.wi[k][n];
      const float wg = gated ? s.r.wg[k][n] : 0.f;
      const float wo = BWD ? s.r.wo[k][n] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float xv = s.r.xs[r0 + i][k];
        zh[i] = fmaf(xv, wi, zh[i]);
        if (gated) zg[i] = fmaf(xv, wg, zg[i]);
        if (BWD) gh[i] = fmaf(s.r.gs[r0 + i][k], wo, gh[i]);
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
  float* pair = &s.r.xs[0][0];         // MT*KC floats, free after recompute
  for (int k0 = 0; k0 < d; k0 += KC) {
    const int kn = min(KC, d - k0);
    __syncthreads();
    for (int e = tid; e < KC * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const size_t at = (size_t)(k0 + kk) * F + f0 + nn;
      s.r.wi[kk][nn] = kk < kn ? rt::to_f(wi_c[at]) : 0.f;
      if (wg_c) s.r.wg[kk][nn] = kk < kn ? rt::to_f(wg_c[at]) : 0.f;
    }
    __syncthreads();
    float acc = 0.f;
#pragma unroll 8
    for (int n = nb; n < nb + BN / 2; ++n) {
      acc = fmaf(s.b[r][n], s.r.wi[k][n], acc);
      if (wg_c) acc = fmaf(s.c[r][n], s.r.wg[k][n], acc);
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

// ---------------------------------------------------------------------------
// dW. A (client, f-block) pair's m-tiles are split over G blocks, block q
// taking the contiguous m-tiles [q·per, (q+1)·per); a block owns DW_DK rows
// of d of every dW output of its f-block (a grid axis only where d > 64).
// It first marks which of its m-tiles some row keeps (masks only), then
// stages the f-block's weight slab (W_in, W_out transposed, W_gate) once
// and keeps it across its m-tiles, or, where the slab does not fit,
// restages it a DW_KC-row chunk at a time for each m-tile. For each kept
// m-tile, 256 threads recompute the pre-activations: thread (n0, ks) sums
// 2 neurons (n0, n0 + 64) x 8 rows over rows ks·8.. of every 32-row chunk
// of d (three 16-byte loads feed 8 FMAs a weight); the 4 k-slice partials
// are added in slice order, the mask and activation give (hm, dzh, dzg),
// and thread (n0, ks) adds the tile's rows in order onto its fp32 partials
// of dW at neurons n0, n0 + 64 and rows kd0 + 16·ks .. + 16 (up to 96
// registers: 256 threads a block keep them without spilling). The blocks'
// partials are then added in block order, which is m-tile order (acc = p0
// + p1 + ...): with G = 1 the block writes dW itself; otherwise each block
// writes its partial to fp32 scratch and train_dw_reduce_kernel (a
// programmatic dependent launch) adds them in order and writes dW. (A
// thread-block cluster whose blocks add the partials through distributed
// shared memory was slower at every shape timed, PERF.md §6.)
// A block reads no weight unless one of its m-tiles is kept; an f-block no
// m-tile keeps gets partials of exact zeros, so its dW is exactly 0.
constexpr int DW_THREADS = 256;
constexpr int DW_DK = 64;         // rows of d a block's dW partial covers
constexpr int DW_KC = 32;         // rows of d of a restaged weight chunk
constexpr int DW_KS = 4;          // k-slices of the recompute
constexpr int DW_KR = DW_KC / DW_KS;          // rows of a chunk a k-slice sums (8)
constexpr int DW_KA = DW_DK / DW_KS;          // rows of d of a thread's dW partial (16)
constexpr int DW_EPT = MT * BN / DW_THREADS;  // (row, neuron) elements a thread finishes
constexpr size_t MAX_SMEM = 227 * 1024;
static_assert(DW_THREADS == 64 * DW_KS, "thread (n0, k-slice): 64 x DW_KS");

struct DwGeom {
  int G, per;          // blocks per (client, f-block, d-chunk); m-tiles a block
  int nfb, ndk;        // f-blocks; d-chunks of DW_DK
  int kch;             // rows of d staged at once (d where the slab is resident)
  int resident;        // the slab is staged once per block
  int region;          // floats of the slab region
};

// Dynamic shared memory in floats past the slab region, for kch rows of d
// and per m-tiles a block: x and gy transposed, x and gy at this block's
// rows of d, the k-slice partials (hm, dzh and dzg lie over them: 3 <=
// DW_KS·nm planes), a kept flag per m-tile.
inline size_t dw_tail_floats(int kch, int nm, int per) {
  return (size_t)2 * kch * MT + 2 * MT * DW_DK + (size_t)DW_KS * nm * MT * BN + per;
}

DwGeom dw_geom(int G, int M, int d, int F, bool gated) {
  DwGeom g{};
  const int nm = gated ? 3 : 2, nmt = (M + MT - 1) / MT;
  g.G = G < 1 ? 1 : G;
  g.per = (nmt + g.G - 1) / g.G;
  g.nfb = F / BN;
  g.ndk = (d + DW_DK - 1) / DW_DK;
  auto region = [&](int kch) { return ((size_t)nm * kch * LD + 3) / 4 * 4; };   // 16-byte aligned
  g.resident = sizeof(float) * (region(d) + dw_tail_floats(d, nm, g.per)) <= MAX_SMEM;
  g.kch = g.resident ? d : DW_KC;
  g.region = (int)region(g.kch);
  return g;
}

inline size_t dw_smem(const DwGeom& g, bool gated) {
  return sizeof(float) * (g.region + dw_tail_floats(g.kch, gated ? 3 : 2, g.per));
}

// Output e of a block's partial (e = i·DW_THREADS + t, accumulator i of
// thread t) is weight i / (2·DW_KA) (in, out, gate) at neuron t % 64 +
// 64·(i / DW_KA % 2) and row kd0 + DW_KA·(t / 64) + i % DW_KA of d.
template <typename T>
__device__ __forceinline__ void dw_store(int e, float v, T* __restrict__ dw_in,
                                         T* __restrict__ dw_out, T* __restrict__ dw_gate,
                                         int f0, int kd0, int d, int F) {
  const int i = e / DW_THREADS, t = e % DW_THREADS;
  const int n = t % 64 + 64 * (i / DW_KA % 2), k = kd0 + DW_KA * (t / 64) + i % DW_KA;
  if (k >= d) return;
  const int w = i / (2 * DW_KA);
  if (w == 1) dw_out[(size_t)(f0 + n) * d + k] = rt::from_f<T>(v);
  else (w == 0 ? dw_in : dw_gate)[(size_t)k * F + f0 + n] = rt::from_f<T>(v);
}

// Stage rows [c0, c0 + kn) of d of the f-block's weights: W_in and W_gate
// rows as they lie, W_out transposed (wo[k][n] = W_out[f0 + n][k]); rows of
// LD floats, so that the transposing stores are nearly free of bank
// conflicts. 16-byte loads, U of each weight in flight a thread before any
// is stored (the staging is latency-bound); W_out by scalars where d is not
// a multiple of a 16-byte vector.
template <typename T, bool GATED>
__device__ void dw_stage_slab(float* __restrict__ slab, int kch, const T* __restrict__ wi_c,
                              const T* __restrict__ wg_c, const T* __restrict__ wo_c,
                              int c0, int kn, int f0, int d, int F) {
  constexpr int V = rt::Vec<T>::N, U = 4, RV = BN / V;
  float* wi = slab;
  float* wo = slab + kch * LD;
  float* wg = slab + 2 * kch * LD;
  const int nr = kn * RV;                 // W_in / W_gate vectors
  const bool vo = d % V == 0 && c0 % V == 0;
  const int cv = kn / V, no = vo ? BN * cv : 0;   // W_out vectors
  for (int b0 = threadIdx.x; b0 < nr || b0 < no; b0 += DW_THREADS * U) {
    float a[U][V], q[U][V], o[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = b0 + u * DW_THREADS;
      if (e < nr) {
        const size_t at = (size_t)(c0 + e / RV) * F + f0 + e % RV * V;
        rt::load16(wi_c + at, a[u]);
        if (GATED) rt::load16(wg_c + at, q[u]);
      }
      if (e < no) rt::load16(wo_c + (size_t)(f0 + e / cv) * d + c0 + e % cv * V, o[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = b0 + u * DW_THREADS;
      if (e < nr) {
        float* di = wi + (e / RV) * LD + e % RV * V;
        float* dg = wg + (e / RV) * LD + e % RV * V;
#pragma unroll
        for (int x = 0; x < V; ++x) {
          di[x] = a[u][x];
          if (GATED) dg[x] = q[u][x];
        }
      }
      if (e < no) {
        const int n = e / cv, k = e % cv * V;
#pragma unroll
        for (int x = 0; x < V; ++x) wo[(k + x) * LD + n] = o[u][x];
      }
    }
  }
  if (!vo) {
#pragma unroll 4
    for (int e = threadIdx.x; e < kn * BN; e += DW_THREADS) {
      const int n = e / kn, k = e % kn;
      wo[k * LD + n] = rt::to_f(wo_c[(size_t)(f0 + n) * d + c0 + k]);
    }
  }
}

// grid (G, nfb·ndk, C), DW_THREADS threads. scratch (G > 1): (C, nfb·ndk,
// G, 2·DW_KA·nm·DW_THREADS) fp32.
template <typename T, bool GATED>
__global__ void __launch_bounds__(DW_THREADS, 1)
train_dw_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                const T* __restrict__ w_in, const T* __restrict__ w_gate,
                const T* __restrict__ w_out, const float* __restrict__ mask,
                T* __restrict__ dw_in, T* __restrict__ dw_gate,
                T* __restrict__ dw_out, float* __restrict__ scratch, DwGeom g,
                int M, int d, int F, int act) {
  constexpr int NM = GATED ? 3 : 2;       // weights, and pre-activations of a tile
  constexpr int NACC = 2 * DW_KA * NM;    // dW partials a thread holds
  extern __shared__ __align__(16) float dsm[];
  if (g.G > 1) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int q = blockIdx.x, fb = blockIdx.y % g.nfb, dk = blockIdx.y / g.nfb, c = blockIdx.z;
  const int f0 = fb * BN, kd0 = dk * DW_DK, tid = threadIdx.x;
  const int n0 = tid % 64, ks = tid / 64;
  const int nmt = (M + MT - 1) / MT, mt0 = q * g.per, mt1 = min(mt0 + g.per, nmt);
  const size_t dF = (size_t)d * F;
  const float* mask_c = mask + (size_t)c * M * F;
  const T* x_c = x + (size_t)c * M * d;
  const T* g_c = gy + (size_t)c * M * d;
  const T* wi_c = w_in + c * dF;
  const T* wg_c = GATED ? w_gate + c * dF : nullptr;
  const T* wo_c = w_out + c * dF;
  T* di_c = dw_in + c * dF;
  T* do_c = dw_out + c * dF;
  T* dg_c = GATED ? dw_gate + c * dF : nullptr;
  float* slab = dsm;                      // (nm, kch, LD): W_in, W_out ᵀ, W_gate
  float* xs = dsm + g.region;             // (kch, MT) x, transposed
  float* gs = xs + g.kch * MT;            // (kch, MT) gy, transposed
  float* xr = gs + g.kch * MT;            // (MT, DW_DK) x at this block's rows of d
  float* gr = xr + MT * DW_DK;            // (MT, DW_DK) gy
  float* red = gr + MT * DW_DK;           // (DW_KS, NM, MT, BN) k-slice partials
  float* hb = red;                        // (3, MT, BN) hm, dzh, dzg, over them: a
                                          // thread writes only the (r, n) it has read
  int* kept = reinterpret_cast<int*>(red + DW_KS * NM * MT * BN);   // (per) m-tile kept

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  // which of this block's m-tiles does some row keep? (masks only)
  for (int i = tid; i < mt1 - mt0; i += DW_THREADS) kept[i] = 0;
  for (int e = tid; e < MT * DW_DK; e += DW_THREADS) xr[e] = gr[e] = 0.f;   // rows past d
  __syncthreads();
  bool mine = false;
  const int nmask = (mt1 - mt0) * MT * BN;
  for (int b0 = tid; b0 < nmask; b0 += DW_THREADS * 8) {
    float mv[8];                          // 8 loads in flight
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = b0 + u * DW_THREADS, r = mt0 * MT + e / BN;
      mv[u] = e < nmask && r < M ? mask_c[(size_t)r * F + f0 + e % BN] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (mv[u] != 0.f) {
        kept[(b0 + u * DW_THREADS) / (MT * BN)] = 1;
        mine = true;
      }
  }
  if (__syncthreads_or(mine)) {
    if (g.resident) dw_stage_slab<T, GATED>(slab, g.kch, wi_c, wg_c, wo_c, 0, d, f0, d, F);
    for (int mt = mt0; mt < mt1; ++mt) {
      if (!kept[mt - mt0]) continue;      // the tile reads no weight
      const int m0 = mt * MT, rows = min(MT, M - m0);
      // the tile's mask into registers; x and gy into xr/gr (this block's
      // rows of d) and, where the slab is resident, xs/gs (all of d,
      // transposed)
      float mv[DW_EPT];
#pragma unroll
      for (int i = 0; i < DW_EPT; ++i) {
        const int e = tid + i * DW_THREADS, r = e / BN;
        mv[i] = r < rows ? mask_c[(size_t)(m0 + r) * F + f0 + e % BN] : 0.f;
      }
#pragma unroll 2
      for (int e = tid; e < MT * d; e += DW_THREADS) {
        const int r = e / d, k = e % d;
        const bool in = r < rows;
        const float xv = in ? rt::to_f(x_c[(size_t)(m0 + r) * d + k]) : 0.f;
        const float gv = in ? rt::to_f(g_c[(size_t)(m0 + r) * d + k]) : 0.f;
        if (g.resident) {
          xs[k * MT + r] = xv;
          gs[k * MT + r] = gv;
        }
        if (k >= kd0 && k < kd0 + DW_DK) {
          xr[r * DW_DK + k - kd0] = xv;
          gr[r * DW_DK + k - kd0] = gv;
        }
      }
      // pre-activations: thread (n0, ks), neurons n0 and n0 + 64, all 8 rows
      float z[NM][2][MT];
#pragma unroll
      for (int a = 0; a < NM; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < MT; ++r) z[a][h][r] = 0.f;
      for (int c0 = 0; c0 < d; c0 += g.kch) {
        const int kn = min(g.kch, d - c0);
        __syncthreads();                  // the previous chunk is consumed
        if (!g.resident) {
          dw_stage_slab<T, GATED>(slab, g.kch, wi_c, wg_c, wo_c, c0, kn, f0, d, F);
          for (int e = tid; e < MT * kn; e += DW_THREADS) {
            const int r = e / kn, k = e % kn;
            const bool in = r < rows;
            const size_t at = (size_t)(m0 + r) * d + c0 + k;
            xs[k * MT + r] = in ? rt::to_f(x_c[at]) : 0.f;
            gs[k * MT + r] = in ? rt::to_f(g_c[at]) : 0.f;
          }
        }
        __syncthreads();
        const float* wi = slab;
        const float* wo = slab + g.kch * LD;
        const float* wg = slab + 2 * g.kch * LD;
        for (int s0 = 0; s0 < kn; s0 += DW_KC) {
          const int k1 = min(s0 + ks * DW_KR + DW_KR, kn);
#pragma unroll 2
          for (int k = s0 + ks * DW_KR; k < k1; ++k) {
            float xv[MT], gv[MT];
            const float4* xp = reinterpret_cast<const float4*>(xs + k * MT);
            const float4* gp = reinterpret_cast<const float4*>(gs + k * MT);
            const float4 x0 = xp[0], x1 = xp[1], g0 = gp[0], g1 = gp[1];
            xv[0] = x0.x; xv[1] = x0.y; xv[2] = x0.z; xv[3] = x0.w;
            xv[4] = x1.x; xv[5] = x1.y; xv[6] = x1.z; xv[7] = x1.w;
            gv[0] = g0.x; gv[1] = g0.y; gv[2] = g0.z; gv[3] = g0.w;
            gv[4] = g1.x; gv[5] = g1.y; gv[6] = g1.z; gv[7] = g1.w;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = n0 + 64 * h;
              const float a = wi[k * LD + n], b = wo[k * LD + n];
              const float cg = GATED ? wg[k * LD + n] : 0.f;
#pragma unroll
              for (int r = 0; r < MT; ++r) {
                z[0][h][r] = fmaf(xv[r], a, z[0][h][r]);
                z[1][h][r] = fmaf(gv[r], b, z[1][h][r]);
                if (GATED) z[NM - 1][h][r] = fmaf(xv[r], cg, z[NM - 1][h][r]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < NM; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < MT; ++r)
            red[((ks * NM + a) * MT + r) * BN + n0 + 64 * h] = z[a][h][r];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < DW_EPT; ++i) {  // k-slices in order; mask, act
        const int e = tid + i * DW_THREADS;
        float pre_a[NM];
#pragma unroll
        for (int a = 0; a < NM; ++a) {
          float v = red[a * MT * BN + e];
#pragma unroll
          for (int p = 1; p < DW_KS; ++p) v += red[(p * NM + a) * MT * BN + e];
          pre_a[a] = v;
        }
        const float rm = mv[i], zh = pre_a[0], ghm = pre_a[1] * rm;
        float hm, dzh, dzg = 0.f;
        if (GATED) {
          const float zg = pre_a[NM - 1], av = act_f(zg, act);
          hm = av * zh;
          dzh = ghm * av;
          dzg = ghm * zh * dact_f(zg, act);
        } else {
          hm = act_f(zh, act);
          dzh = ghm * dact_f(zh, act);
        }
        hb[e] = hm * rm;
        hb[MT * BN + e] = dzh;
        hb[2 * MT * BN + e] = dzg;
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {    // the tile's rows, in order, onto the partials
        float xv[DW_KA], gv[DW_KA];
#pragma unroll
        for (int v4 = 0; v4 < DW_KA / 4; ++v4) {
          const float4 a = reinterpret_cast<const float4*>(xr + r * DW_DK + DW_KA * ks)[v4];
          const float4 b = reinterpret_cast<const float4*>(gr + r * DW_DK + DW_KA * ks)[v4];
          xv[4 * v4] = a.x; xv[4 * v4 + 1] = a.y; xv[4 * v4 + 2] = a.z; xv[4 * v4 + 3] = a.w;
          gv[4 * v4] = b.x; gv[4 * v4 + 1] = b.y; gv[4 * v4 + 2] = b.z; gv[4 * v4 + 3] = b.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = r * BN + n0 + 64 * h;
          const float hm = hb[n], dzh = hb[MT * BN + n];
          const float dzg = GATED ? hb[2 * MT * BN + n] : 0.f;
#pragma unroll
          for (int kk = 0; kk < DW_KA; ++kk) {
            acc[h * DW_KA + kk] = fmaf(xv[kk], dzh, acc[h * DW_KA + kk]);
            acc[2 * DW_KA + h * DW_KA + kk] = fmaf(hm, gv[kk], acc[2 * DW_KA + h * DW_KA + kk]);
            if (GATED)
              acc[4 * DW_KA + h * DW_KA + kk] = fmaf(xv[kk], dzg, acc[4 * DW_KA + h * DW_KA + kk]);
          }
        }
      }
      __syncthreads();                    // xr, gr, hb are consumed
    }
  }

  if (g.G == 1) {
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      dw_store<T>(i * DW_THREADS + tid, acc[i], di_c, do_c, dg_c, f0, kd0, d, F);
  } else {
    float* part = scratch + (((size_t)c * gridDim.y + blockIdx.y) * g.G + q) * NACC * DW_THREADS;
#pragma unroll
    for (int i = 0; i < NACC; ++i) part[i * DW_THREADS + tid] = acc[i];
  }
}

// grid (NACC, nfb·ndk, C), DW_THREADS threads: the sum of the G partials
// of each output in block order. A programmatic dependent
// of train_dw_kernel.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
train_dw_reduce_kernel(const float* __restrict__ scratch, T* __restrict__ dw_in,
                       T* __restrict__ dw_gate, T* __restrict__ dw_out, int G, int nfb,
                       int d, int F) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int e = blockIdx.x * DW_THREADS + threadIdx.x, nout = gridDim.x * DW_THREADS;
  const float* p = scratch + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * G * nout + e;
  float v = p[0];
  for (int q = 1; q < G; ++q) v += p[(size_t)q * nout];
  const size_t dF = (size_t)d * F * blockIdx.z;          // this client's weights
  dw_store<T>(e, v, dw_in + dF, dw_out + dF, dw_gate ? dw_gate + dF : nullptr,
              (blockIdx.y % nfb) * BN, (blockIdx.y / nfb) * DW_DK, d, F);
}

template <typename T, bool GATED>
cudaError_t launch_dw(const void* gy, const void* x, const void* w_in, const void* w_gate,
                      const void* w_out, const float* mask, void* dw_in, void* dw_gate,
                      void* dw_out, float* scratch, int C, int M, int d, int F, int act,
                      int G, cudaStream_t s) {
  const DwGeom g = dw_geom(G, M, d, F, GATED);
  if (C == 0 || g.nfb == 0 || d == 0) return cudaSuccess;
  if (g.G > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = dw_smem(g, GATED);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(train_dw_kernel<T, GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  train_dw_kernel<T, GATED><<<dim3(g.G, g.nfb * g.ndk, C), DW_THREADS, smem, s>>>(
      static_cast<const T*>(gy), static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_gate), static_cast<const T*>(w_out), mask,
      static_cast<T*>(dw_in), static_cast<T*>(dw_gate), static_cast<T*>(dw_out), scratch, g,
      M, d, F, act);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.G == 1) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * DW_KA * (GATED ? 3 : 2), g.nfb * g.ndk, C);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, train_dw_reduce_kernel<T>, static_cast<const float*>(scratch),
                           static_cast<T*>(dw_in), static_cast<T*>(dw_gate),
                           static_cast<T*>(dw_out), g.G, g.nfb, d, F);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// dW of the training form. G blocks share each (client, f-block) pair's
// m-tiles and, where G > 1, sum their partials through `scratch` ((C,
// F/128·ceil(d/64), G, 32·(2 or 3)·256) fp32; may be null where G = 1).
extern "C" int masked_ffn_dw_launch(
    const void* gy, const void* x, const void* w_in, const void* w_gate,
    const void* w_out, const float* mask, void* dw_in, void* dw_gate,
    void* dw_out, float* scratch, int C, int M, int d, int F, int act,
    int dtype, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = w_gate ? launch_dw<T, true>(gy, x, w_in, w_gate, w_out, mask, dw_in, dw_gate,
                                      dw_out, scratch, C, M, d, F, act, G, s)
                 : launch_dw<T, false>(gy, x, w_in, w_gate, w_out, mask, dw_in, dw_gate,
                                       dw_out, scratch, C, M, d, F, act, G, s);
  });
  return err;
}
