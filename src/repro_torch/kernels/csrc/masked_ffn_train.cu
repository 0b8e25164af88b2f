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
// skipped when no row of the tile keeps any neuron of the block, and reads
// no weight (each block ORs the row mask itself, as _prefetch_mask :259
// does); kept tiles apply the exact per-row mask; the forward rounds the
// masked hidden activation to the input type before the down product
// (:129); the backward recomputes the pre-activations from (x, weights,
// mask) and saves no activations (_bwd_core :144); every sum is fp32.
//
// What bounds them on an H100: operations, not bytes. At femnist_attn's FFN
// (C 5 clients of M 490 rows, d 64, F 256, ungated) the forward is 0.16
// GFLOP and dx 0.24 GFLOP of fp32 FMA (2.4 and 3.6 us at 67 TFLOP/s) on ~5
// MB of inputs (1.5 us); at the fleet's M 10, F 1024 a pass is a few MB
// and a few MFLOP, so there launch latency and each block's chain of
// latencies bound it. So every kernel here keeps a (client, f-block)'s
// weight slab resident in shared memory across a group of m-tiles, staged
// once with 16-byte loads in flight, and feeds register tiles from it.
//
// Hopper has no sequential grid, so the Pallas accumulators revisited
// across the grid become:
//   forward, dx: a (client, f-block) pair's m-tiles are split over G
//     blocks; each block writes an fp32 partial of its tiles' rows for its
//     f-block, and a programmatic-dependent kernel sums the kept f-blocks'
//     partials in f order (no atomics: deterministic).
//   dW: a (client, f-block) pair's m-tiles are split over G blocks that
//     keep the f-block's weight slab in shared memory; their fp32 partials
//     are added in m-tile order through an fp32 scratch and a second
//     kernel (train_dw_kernel, below); an f-block no m-tile keeps is
//     written as exact zeros. Where d > 64 the blocks also split d, and a
//     first kernel computes each kept tile's pre-activation terms once for
//     all of them (train_dw_core_kernel).
// Masks are data: a new mask never means a new build.
#include <type_traits>

#include "common.cuh"

namespace {

using rt::act_f;
using rt::dact_f;

constexpr int BN = 128;          // neurons per f-block (BLOCK_NEURONS)
constexpr int MT = 8;            // rows per m-tile (the Pallas block_m)
constexpr int LD = BN + 1;       // padded shared-memory row of a weight slab

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
// Where d > DW_DK the recompute of a tile does not depend on the block's
// rows of d, so train_dw_core_kernel does it once a tile (the same code,
// dw_tile_core) and the dW blocks read its (hm, dzh, dzg) and no weight.
constexpr int DW_THREADS = 256;
constexpr int DW_DK = 64;         // rows of d a block's dW partial covers
constexpr int DW_CORE_GROUPS = 16;  // most blocks a pair's m-tiles split over in the core pass
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

// Which of the m-tiles [mt0, mt1) of an f-block does some row keep? Into
// kept[], from the mask alone (8 loads in flight a thread); returns whether
// any is, to every thread of the block.
__device__ __forceinline__ bool dw_kept_tiles(int* __restrict__ kept,
                                              const float* __restrict__ mask_c, int mt0,
                                              int mt1, int M, int F, int f0) {
  const int tid = threadIdx.x;
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
  return __syncthreads_or(mine);
}

// The pre-activations of a kept m-tile (rows m0 .. m0 + rows) over all of d,
// then its mask and activation: hb (3, MT, BN) = (hm, dzh, dzg). x and gy
// of the tile go to xs/gs (all of d, transposed) where the slab is
// resident, and, with xr non-null, to xr/gr (rows kd0 .. kd0 + DW_DK of d).
// Thread (n0, ks) sums 2 neurons (n0, n0 + 64) x 8 rows over rows ks·8.. of
// every 32-row chunk of d; the 4 k-slice partials (in red, under hb) are
// added in slice order. Ends with a block barrier: hb is complete.
template <typename T, bool GATED>
__device__ __forceinline__ void dw_tile_core(
    float* __restrict__ red, float* __restrict__ slab, float* __restrict__ xs,
    float* __restrict__ gs, float* __restrict__ xr, float* __restrict__ gr, const DwGeom& g,
    const float* __restrict__ mask_c, const T* __restrict__ x_c, const T* __restrict__ g_c,
    const T* __restrict__ wi_c, const T* __restrict__ wg_c, const T* __restrict__ wo_c,
    int m0, int rows, int f0, int kd0, int d, int F, int act) {
  constexpr int NM = GATED ? 3 : 2;
  const int tid = threadIdx.x, n0 = tid % 64, ks = tid / 64;
  float* hb = red;                        // hm, dzh, dzg over the partials: a
                                          // thread writes only the (r, n) it has read
  float mv[DW_EPT];
#pragma unroll
  for (int i = 0; i < DW_EPT; ++i) {
    const int e = tid + i * DW_THREADS, r = e / BN;
    mv[i] = r < rows ? mask_c[(size_t)(m0 + r) * F + f0 + e % BN] : 0.f;
  }
  if (g.resident || xr) {
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
      if (xr && k >= kd0 && k < kd0 + DW_DK) {
        xr[r * DW_DK + k - kd0] = xv;
        gr[r * DW_DK + k - kd0] = gv;
      }
    }
  }
  float z[NM][2][MT];
#pragma unroll
  for (int a = 0; a < NM; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < MT; ++r) z[a][h][r] = 0.f;
  for (int c0 = 0; c0 < d; c0 += g.kch) {
    const int kn = min(g.kch, d - c0);
    __syncthreads();                      // the previous chunk is consumed
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
  for (int i = 0; i < DW_EPT; ++i) {      // k-slices in order; mask, act
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
}

// Where d > DW_DK the dW kernel's blocks split d, and each would recompute
// its tiles' pre-activations over all of d: at d 5120, 80 times over. So
// there a first kernel computes each kept (m-tile, f-block) tile's (hm,
// dzh, dzg) once, with the same arithmetic, into an fp32 scratch `core`
// (C, nfb, m-tiles, 3, MT, BN), and the dW kernel reads them from it.
// grid (Gc, nfb, C), DW_THREADS threads; block q takes m-tiles
// [q·g.per, (q+1)·g.per).
template <typename T, bool GATED>
__global__ void __launch_bounds__(DW_THREADS, 1)
train_dw_core_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                     const T* __restrict__ w_in, const T* __restrict__ w_gate,
                     const T* __restrict__ w_out, const float* __restrict__ mask,
                     float* __restrict__ core, DwGeom g, int M, int d, int F, int act) {
  extern __shared__ __align__(16) float dsm[];
  const int q = blockIdx.x, fb = blockIdx.y, c = blockIdx.z, tid = threadIdx.x;
  const int f0 = fb * BN, nmt = (M + MT - 1) / MT;
  const int mt0 = q * g.per, mt1 = min(mt0 + g.per, nmt);
  const size_t dF = (size_t)d * F;
  const float* mask_c = mask + (size_t)c * M * F;
  float* slab = dsm;
  float* xs = dsm + g.region;
  float* gs = xs + g.kch * MT;
  float* red = gs + g.kch * MT + 2 * MT * DW_DK;
  int* kept = reinterpret_cast<int*>(red + DW_KS * (GATED ? 3 : 2) * MT * BN);
  for (int i = tid; i < mt1 - mt0; i += DW_THREADS) kept[i] = 0;
  __syncthreads();
  if (!dw_kept_tiles(kept, mask_c, mt0, mt1, M, F, f0)) return;
  const T* wi_c = w_in + c * dF;
  const T* wg_c = GATED ? w_gate + c * dF : nullptr;
  const T* wo_c = w_out + c * dF;
  if (g.resident) dw_stage_slab<T, GATED>(slab, g.kch, wi_c, wg_c, wo_c, 0, d, f0, d, F);
  for (int mt = mt0; mt < mt1; ++mt) {
    if (!kept[mt - mt0]) continue;
    const int m0 = mt * MT;
    dw_tile_core<T, GATED>(red, slab, xs, gs, nullptr, nullptr, g, mask_c,
                           x + (size_t)c * M * d, gy + (size_t)c * M * d, wi_c, wg_c, wo_c,
                           m0, min(MT, M - m0), f0, 0, d, F, act);
    float4* dst = reinterpret_cast<float4*>(
        core + (((size_t)c * g.nfb + fb) * nmt + mt) * 3 * MT * BN);
    for (int e = tid; e < 3 * MT * BN / 4; e += DW_THREADS)
      dst[e] = reinterpret_cast<const float4*>(red)[e];
    __syncthreads();                      // red is consumed
  }
}

// grid (G, nfb·ndk, C), DW_THREADS threads. scratch (G > 1): (C, nfb·ndk,
// G, 2·DW_KA·nm·DW_THREADS) fp32. With `core` (d > DW_DK) a tile's (hm,
// dzh, dzg) come from train_dw_core_kernel, and no weight is read.
template <typename T, bool GATED>
__global__ void __launch_bounds__(DW_THREADS, 1)
train_dw_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                const T* __restrict__ w_in, const T* __restrict__ w_gate,
                const T* __restrict__ w_out, const float* __restrict__ mask,
                T* __restrict__ dw_in, T* __restrict__ dw_gate,
                T* __restrict__ dw_out, float* __restrict__ scratch,
                const float* __restrict__ core, DwGeom g, int M, int d, int F, int act) {
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
  const float* hb = red;                  // (3, MT, BN) hm, dzh, dzg
  int* kept = reinterpret_cast<int*>(red + DW_KS * NM * MT * BN);   // (per) m-tile kept

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int i = tid; i < mt1 - mt0; i += DW_THREADS) kept[i] = 0;
  for (int e = tid; e < MT * DW_DK; e += DW_THREADS) xr[e] = gr[e] = 0.f;   // rows past d
  __syncthreads();
  if (dw_kept_tiles(kept, mask_c, mt0, mt1, M, F, f0)) {
    if (!core && g.resident) dw_stage_slab<T, GATED>(slab, g.kch, wi_c, wg_c, wo_c, 0, d, f0, d, F);
    for (int mt = mt0; mt < mt1; ++mt) {
      if (!kept[mt - mt0]) continue;      // the tile reads no weight
      const int m0 = mt * MT, rows = min(MT, M - m0);
      if (core) {                         // this block's rows of d of x and gy, and the tile's core
        const int kn = min(DW_DK, d - kd0);
        for (int e = tid; e < MT * kn; e += DW_THREADS) {
          const int r = e / kn, k = e % kn;
          const bool in = r < rows;
          const size_t at = (size_t)(m0 + r) * d + kd0 + k;
          xr[r * DW_DK + k] = in ? rt::to_f(x_c[at]) : 0.f;
          gr[r * DW_DK + k] = in ? rt::to_f(g_c[at]) : 0.f;
        }
        const float4* src = reinterpret_cast<const float4*>(
            core + (((size_t)c * g.nfb + fb) * nmt + mt) * 3 * MT * BN);
        for (int e = tid; e < 3 * MT * BN / 4; e += DW_THREADS)
          reinterpret_cast<float4*>(red)[e] = src[e];
        __syncthreads();
      } else {
        dw_tile_core<T, GATED>(red, slab, xs, gs, xr, gr, g, mask_c, x_c, g_c, wi_c, wg_c,
                               wo_c, m0, rows, f0, kd0, d, F, act);
      }
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
                      void* dw_out, float* scratch, float* core, int C, int M, int d, int F,
                      int act, int G, cudaStream_t s) {
  DwGeom g = dw_geom(G, M, d, F, GATED);
  if (C == 0 || g.nfb == 0 || d == 0) return cudaSuccess;
  if (g.G > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;
  if (g.ndk > 1) {                        // the tiles' (hm, dzh, dzg) once, into core
    if (core == nullptr) return cudaErrorInvalidValue;
    const int nmt = (M + MT - 1) / MT;
    const DwGeom gc = dw_geom(nmt < DW_CORE_GROUPS ? nmt : DW_CORE_GROUPS, M, d, F, GATED);
    const size_t smem_c = dw_smem(gc, GATED);
    if (smem_c > MAX_SMEM) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(train_dw_core_kernel<T, GATED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
    if (err != cudaSuccess) return err;
    train_dw_core_kernel<T, GATED><<<dim3((nmt + gc.per - 1) / gc.per, g.nfb, C), DW_THREADS,
                                     smem_c, s>>>(
        static_cast<const T*>(gy), static_cast<const T*>(x), static_cast<const T*>(w_in),
        static_cast<const T*>(w_gate), static_cast<const T*>(w_out), mask, core, gc, M, d, F,
        act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    g.region = g.kch = g.resident = 0;    // the dW kernel then reads no weight
  } else {
    core = nullptr;
  }
  const size_t smem = dw_smem(g, GATED);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(train_dw_kernel<T, GATED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  train_dw_kernel<T, GATED><<<dim3(g.G, g.nfb * g.ndk, C), DW_THREADS, smem, s>>>(
      static_cast<const T*>(gy), static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_gate), static_cast<const T*>(w_out), mask,
      static_cast<T*>(dw_in), static_cast<T*>(dw_gate), static_cast<T*>(dw_out), scratch, core,
      g, M, d, F, act);
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


// ---------------------------------------------------------------------------
// Forward and dx. A (client, f-block) pair's m-tiles are split over G
// blocks, block q taking the contiguous m-tiles [q·per, (q+1)·per) (grid
// (G, nfb, C)). A block first marks which of its m-tiles some row keeps
// (masks only, whole 128-neuron rows of the mask a warp-wide load; a block
// none of whose tiles is kept reads no weight and returns), then stages
// the f-block's slab, W_in and W_gate rows (stride LDW) and W_out rows
// (stride ldo), as they lie, and keeps it while its warps take its m-tiles.
// Where T is fp32 and d a multiple of 4 the slab lands by 16-byte cp.async
// in FD_CHUNKS pieces of rows of d (on an H100, 64 KB in ~2 k cycles by
// 16-byte copies, ~8 k by 4-byte ones), and the groups sum their first
// m-tiles' pre-activations a piece at a time as the pieces land.
// A group of FD_WT = 4 warps takes one m-tile at a time, warp s owning the
// f-block's neurons 32s .. 32s + 31, a neuron a lane. For a kept m-tile the
// group:
//   1. has x (and gy) of its 8 rows in its buffer, transposed (cp.async'd
//      there while it computed its last m-tile);
//   2. each lane sums its neuron's pre-activations for all 8 rows in
//      registers (zh, zg, and for dx gh = gy·W_outᵀ), serially over k;
//   3. applies the mask and activation (the forward rounds the hidden
//      activation to T) and writes h, or (dzh, dzg), transposed;
//   4. each warp sums the output over its 32 neurons, serially, 64 columns
//      at a time (lane l columns l and l + 32 of all 8 rows):
//        forward y  = h·W_out[f-block],   dx = dzh·W_inᵀ (+ dzg·W_gateᵀ,
//      interleaved per neuron); the group's 4 sums are added in warp order
//      (p0 + p1 + p2 + p3) and written as the f-block's fp32 partial.
// Every shared read is free of bank conflicts: W_in rows and W_out rows
// are read across lanes along a row, or as 16-byte pieces at a stride of an
// odd number of 16-byte units (LDW = 132 floats, ldo = 4 mod 8); x, h and
// dz are broadcasts. A broadcast costs a cycle a value (measured on an
// H100: a 16-byte broadcast load takes as long as four 4-byte ones), so a k
// step costs 9 shared cycles for 8 FMAs: the products are bound by shared
// memory, not by the FMA rate.
// train_fd_reduce_kernel (a programmatic dependent) then adds the kept
// f-blocks' partials in f order: out = ((0 + p0) + p1) + ... Where the slab
// does not fit (e.g. d 200, F 384, gated: 310 KB), it is restaged FD_KC rows
// of d at a time, the groups taking their m-tiles in rounds with a block
// barrier around each chunk.
constexpr int FD_THREADS = 256;
constexpr int FD_WARPS = FD_THREADS / 32;
constexpr int FD_WT = 4;                  // warps an m-tile (a group)
constexpr int FD_NG = FD_WARPS / FD_WT;   // groups a block
constexpr int FD_KC = 32;                 // rows of d of a restaged chunk
constexpr int FD_CHUNKS = 4;              // pieces a resident slab lands in
constexpr int FD_COLS = 64;               // output columns a warp sums at once
constexpr int LDW = BN + 4;               // a W_in / W_gate row in shared memory
static_assert(FD_WT * 32 == BN, "a neuron a lane");

struct FdGeom {
  int G, per;         // blocks per (client, f-block); m-tiles a block
  int nfb;            // f-blocks
  int kch;            // rows of d staged at once (d where the slab is resident)
  int resident;       // the slab is staged once per block
  int ldo;            // a W_out row in shared memory: kch rounded up, 4 mod 8
  int region;         // floats of the slab: W_in, W_out, W_gate
  int slot;           // floats of an x (and gy) slot of a group's buffer
  int gbuf;           // floats of a group's buffer
};

// A group's buffer: two slots of x (and gy) of an m-tile transposed, (kch,
// MT) each (the next m-tile's lands while the group computes this one); h
// or dzh (and dzg) transposed, (BN, MT) each; the warps' output sums
// (FD_WT, MT, FD_COLS).
FdGeom fd_geom(int G, int M, int d, int F, bool bwd, bool gated) {
  FdGeom g{};
  const int nmt = (M + MT - 1) / MT;
  g.G = G < 1 ? 1 : G;
  g.per = (nmt + g.G - 1) / g.G;
  g.nfb = F / BN;
  auto set = [&](int kch) {
    g.kch = kch;
    g.ldo = (kch + 3) / 4 * 4;
    if (g.ldo / 4 % 2 == 0) g.ldo += 4;
    g.region = (gated ? 2 : 1) * kch * LDW + BN * g.ldo;
    g.slot = ((bwd ? 2 : 1) * kch * MT + 3) / 4 * 4;
    g.gbuf = 2 * g.slot + (bwd && gated ? 2 : 1) * BN * MT + FD_WT * MT * FD_COLS;
  };
  set(d);
  g.resident = sizeof(float) * ((size_t)g.region + (size_t)FD_NG * g.gbuf) +
                   sizeof(int) * (size_t)g.per <= MAX_SMEM;
  if (!g.resident) set(FD_KC);
  return g;
}

inline size_t fd_smem(const FdGeom& g) {
  return sizeof(float) * ((size_t)g.region + (size_t)FD_NG * g.gbuf) + sizeof(int) * g.per;
}

__device__ __forceinline__ void ld8(const float* p, float (&v)[MT]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st8(float* p, const float (&v)[MT]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The four warps of group `grp` meet (named barrier grp + 1; 0 is
// __syncthreads').
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(32 * FD_WT) : "memory");
}

// cp.async into shared memory (4 or 16 bytes), and its group fences.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void cp_wait_upto3(int n) {
  static_assert(FD_CHUNKS <= 4, "the pieces of the slab a wait can leave pending");
  if (n >= 3) cp_wait<3>();
  else if (n == 2) cp_wait<2>();
  else if (n == 1) cp_wait<1>();
  else cp_wait<0>();
}

// Rows [c0, c0 + kn) of d of the f-block's W_in and W_gate into shared
// memory at rows [k0, k0 + kn) (stride LDW). fp32: 16-byte cp.async, which
// the caller commits and waits for; otherwise 16-byte loads and stores.
template <typename T, bool GATED>
__device__ __forceinline__ void fd_stage_in(float* __restrict__ slab, const FdGeom& g,
                                            const T* __restrict__ wi_c,
                                            const T* __restrict__ wg_c, int c0, int kn, int k0,
                                            int f0, int F) {
  float* wi = slab + k0 * LDW;
  float* wg = slab + g.kch * LDW + BN * g.ldo + k0 * LDW;
  if constexpr (std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < kn * (BN / 4); e += FD_THREADS) {
      const int k = e / (BN / 4), v = e % (BN / 4) * 4;
      cp_async16(wi + k * LDW + v, wi_c + (size_t)(c0 + k) * F + f0 + v);
      if (GATED) cp_async16(wg + k * LDW + v, wg_c + (size_t)(c0 + k) * F + f0 + v);
    }
    return;
  }
  // 16-byte loads (F and f0 are multiples of 128), 4 of each weight in
  // flight a thread before any is stored
  constexpr int V = rt::Vec<T>::N, RV = BN / V, U = 4;
  for (int b0 = threadIdx.x; b0 < kn * RV; b0 += FD_THREADS * U) {
    float a[U][V], q[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = b0 + u * FD_THREADS;
      if (e < kn * RV) {
        const size_t at = (size_t)(c0 + e / RV) * F + f0 + e % RV * V;
        rt::load16(wi_c + at, a[u]);
        if (GATED) rt::load16(wg_c + at, q[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = b0 + u * FD_THREADS;
      if (e < kn * RV) {
        float* di = wi + e / RV * LDW + e % RV * V;
        float* dg = wg + e / RV * LDW + e % RV * V;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          di[v] = a[u][v];
          if (GATED) dg[v] = q[u][v];
        }
      }
    }
  }
}

// Columns [c0, c0 + kn) of the f-block's 128 W_out rows into shared memory
// at columns from 0 (stride g.ldo). fp32 with d and c0 multiples of 4:
// 16-byte cp.async (the whole of d is one contiguous run of 128·d floats),
// which the caller commits and waits for; otherwise loads and stores, 16
// bytes at a time where d, c0 and kn are multiples of a 16-byte vector.
template <typename T>
__device__ __forceinline__ void fd_stage_out(float* __restrict__ slab, const FdGeom& g,
                                             const T* __restrict__ wo_c, int c0, int kn, int f0,
                                             int d) {
  float* wo = slab + g.kch * LDW;
  if constexpr (std::is_same<T, float>::value) {
    if (d % 4 == 0 && c0 % 4 == 0) {
      const int kv = kn / 4;            // kn is a multiple of 4 here
      for (int e = threadIdx.x; e < BN * kv; e += FD_THREADS) {
        const int n = e / kv, v = e % kv * 4;
        cp_async16(wo + n * g.ldo + v, wo_c + (size_t)(f0 + n) * d + c0 + v);
      }
      return;
    }
  }
  constexpr int V = rt::Vec<T>::N, U = 4;
  if (d % V == 0 && c0 % V == 0 && kn % V == 0) {   // 16-byte loads, U in flight
    const int kv = kn / V;
    for (int b0 = threadIdx.x; b0 < BN * kv; b0 += FD_THREADS * U) {
      float o[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = b0 + u * FD_THREADS;
        if (e < BN * kv) rt::load16(wo_c + (size_t)(f0 + e / kv) * d + c0 + e % kv * V, o[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = b0 + u * FD_THREADS;
        if (e < BN * kv) {
          float* dst = wo + e / kv * g.ldo + e % kv * V;
#pragma unroll
          for (int v = 0; v < V; ++v) dst[v] = o[u][v];
        }
      }
    }
    return;
  }
  for (int b0 = threadIdx.x; b0 < kn * BN; b0 += FD_THREADS * 8) {
    float o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = b0 + u * FD_THREADS;
      if (e < kn * BN) o[u] = rt::to_f(wo_c[(size_t)(f0 + e / kn) * d + c0 + e % kn]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = b0 + u * FD_THREADS;
      if (e < kn * BN) wo[e / kn * g.ldo + e % kn] = o[u];
    }
  }
}

// Rows [m0, m0 + rows) of a (·, d) matrix at columns [c0, c0 + kn) into
// buf[k][MT], transposed, rows past `rows` as zeros: by the group's 128
// threads (gt this thread's rank). fp32: 4-byte cp.async, landing by the
// cp_wait that covers the commit that follows; otherwise loads and stores.
template <typename T>
__device__ __forceinline__ void rows_t(float* __restrict__ buf, const T* __restrict__ src,
                                       int m0, int rows, int c0, int kn, int d, int gt) {
  for (int e = gt; e < MT * kn; e += 32 * FD_WT) {
    const int r = e % MT;
    const T* p = src + (size_t)(m0 + r) * d + c0 + e / MT;
    if constexpr (std::is_same<T, float>::value) {
      if (r < rows) cp_async4(buf + e, p);
      else buf[e] = 0.f;
    } else {
      buf[e] = r < rows ? rt::to_f(*p) : 0.f;
    }
  }
}

// Step 2: the lane's pre-activations (neuron n) of all 8 rows over rows
// [k0, k1) of d of the staged slab, serially: per k two 16-byte broadcasts
// of x (and of gy) and a weight feed 8 FMAs a matrix; W_out row n is read
// 4 columns at a time.
template <bool BWD, bool GATED>
__device__ __forceinline__ void warp_pre(float (&zh)[MT], float (&zg)[MT], float (&gh)[MT],
                                         const float* __restrict__ xs,
                                         const float* __restrict__ gs,
                                         const float* __restrict__ slab, const FdGeom& g, int k0,
                                         int k1, int n) {
  const float* wi = slab + n;
  const float* wo = slab + g.kch * LDW + n * g.ldo;
  const float* wg = slab + g.kch * LDW + BN * g.ldo + n;
  auto step = [&](int k, float b) {
    float xv[MT], gv[MT];
    ld8(xs + k * MT, xv);
    if (BWD) ld8(gs + k * MT, gv);
    const float a = wi[k * LDW], cg = GATED ? wg[k * LDW] : 0.f;
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      zh[r] = fmaf(xv[r], a, zh[r]);
      if (GATED) zg[r] = fmaf(xv[r], cg, zg[r]);
      if (BWD) gh[r] = fmaf(gv[r], b, gh[r]);
    }
  };
  int k = k0;
  if (BWD) {
#pragma unroll 2
    for (; k + 4 <= k1; k += 4) {
      const float4 b = lds4(wo + k);
      step(k, b.x);
      step(k + 1, b.y);
      step(k + 2, b.z);
      step(k + 3, b.w);
    }
  }
#pragma unroll 4
  for (; k < k1; ++k) step(k, BWD ? wo[k] : 0.f);
}

// Step 3: mask and activation of the lane's neuron n into hb, transposed
// (n, MT):
//   forward: h = round_T(act-and-gate(z) ⊙ mask)
//   dx:      dzh, and dzg BN·MT floats after it      (repro _bwd_core, fp32)
template <typename T, bool BWD, bool GATED>
__device__ __forceinline__ void warp_finish(float* __restrict__ hb, const float (&zh)[MT],
                                            const float (&zg)[MT], const float (&gh)[MT],
                                            const float (&rm)[MT], int n, int act) {
  float h[MT], h2[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    if (!BWD) {
      const float v = GATED ? act_f(zg[r], act) * zh[r] : act_f(zh[r], act);
      h[r] = rt::to_f(rt::from_f<T>(rm[r] != 0.f ? v * rm[r] : 0.f));
    } else if (GATED) {
      const float ghm = gh[r] * rm[r], a = act_f(zg[r], act);
      h[r] = ghm * a;
      h2[r] = ghm * zh[r] * dact_f(zg[r], act);
    } else {
      h[r] = gh[r] * rm[r] * dact_f(zh[r], act);
    }
  }
  st8(hb + n * MT, h);
  if (BWD && GATED) st8(hb + (BN + n) * MT, h2);
  __syncwarp();
}

// Step 4: columns cc + lane and cc + lane + 32 (< kn) of the staged slab,
// all 8 rows, serially over the warp's neurons [nb, nb + 32). dx reads the
// W_in (and W_gate) rows 4 neurons at a time.
template <bool BWD, bool GATED>
__device__ __forceinline__ void warp_out(float (&acc)[MT][2], const float* __restrict__ hb,
                                         const float* __restrict__ slab, const FdGeom& g,
                                         int kn, int cc, int nb) {
  const int lane = threadIdx.x & 31;
  const int c0 = min(cc + lane, kn - 1), c1 = min(cc + lane + 32, kn - 1);
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r][0] = acc[r][1] = 0.f;
  if (!BWD) {
    const float* wo = slab + g.kch * LDW;
#pragma unroll 8
    for (int n = nb; n < nb + 32; ++n) {
      float h[MT];
      ld8(hb + n * MT, h);
      const float a0 = wo[n * g.ldo + c0], a1 = wo[n * g.ldo + c1];
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        acc[r][0] = fmaf(h[r], a0, acc[r][0]);
        acc[r][1] = fmaf(h[r], a1, acc[r][1]);
      }
    }
    return;
  }
  const float* wg = slab + g.kch * LDW + BN * g.ldo;
#pragma unroll 2
  for (int n = nb; n < nb + 32; n += 4) {
    const float4 i0 = lds4(slab + c0 * LDW + n), i1 = lds4(slab + c1 * LDW + n);
    float4 q0 = i0, q1 = i1;
    if (GATED) {
      q0 = lds4(wg + c0 * LDW + n);
      q1 = lds4(wg + c1 * LDW + n);
    }
    const float a0[4] = {i0.x, i0.y, i0.z, i0.w}, a1[4] = {i1.x, i1.y, i1.z, i1.w};
    const float b0[4] = {q0.x, q0.y, q0.z, q0.w}, b1[4] = {q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float h[MT], z[MT];
      ld8(hb + (n + u) * MT, h);
      if (GATED) ld8(hb + (BN + n + u) * MT, z);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        acc[r][0] = fmaf(h[r], a0[u], acc[r][0]);
        if (GATED) acc[r][0] = fmaf(z[r], b0[u], acc[r][0]);
        acc[r][1] = fmaf(h[r], a1[u], acc[r][1]);
        if (GATED) acc[r][1] = fmaf(z[r], b1[u], acc[r][1]);
      }
    }
  }
}

// The group's output of columns [cc, cc + 64): the four warps' sums added
// in warp order through `op`; element i of group thread gt is row (gt +
// 128i) / 64, column cc + (gt + 128i) % 64. Then its rows < rows and
// columns < kn go to dst (a row-major (·, d) matrix at the tile's first
// row and the chunk's first column).
__device__ __forceinline__ void group_put(float* __restrict__ dst, const float (&acc)[MT][2],
                                          float* __restrict__ op, int grp, int s, int gt,
                                          int rows, int d, int kn, int cc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    op[(s * MT + r) * FD_COLS + lane] = acc[r][0];
    op[(s * MT + r) * FD_COLS + lane + 32] = acc[r][1];
  }
  group_sync(grp);
#pragma unroll
  for (int i = 0; i < MT * FD_COLS / (32 * FD_WT); ++i) {
    const int e = gt + i * 32 * FD_WT, r = e / FD_COLS, col = cc + e % FD_COLS;
    float v = op[e];
#pragma unroll
    for (int p = 1; p < FD_WT; ++p) v += op[p * MT * FD_COLS + e];
    if (r < rows && col < kn) dst[(size_t)r * d + col] = v;
  }
  group_sync(grp);                      // op is consumed
}

// grid (G, nfb, C), FD_THREADS threads. part: (nfb, C, M, d) fp32; keep:
// (C, m-tiles, nfb) int32, both read by the reduce.
template <typename T, bool BWD, bool GATED>
__device__ __forceinline__ void fd_body(const T* __restrict__ gy, const T* __restrict__ x,
                                        const T* __restrict__ w_in, const T* __restrict__ w_gate,
                                        const T* __restrict__ w_out,
                                        const float* __restrict__ mask, int* __restrict__ keep,
                                        float* __restrict__ part, const FdGeom& g, int M, int d,
                                        int F, int act) {
  extern __shared__ __align__(16) float dsm[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int q = blockIdx.x, fb = blockIdx.y, c = blockIdx.z, C = gridDim.z, tid = threadIdx.x;
  const int grp = tid / (32 * FD_WT), s = tid / 32 % FD_WT, gt = tid % (32 * FD_WT);
  const int nb = 32 * s, n = nb + (tid & 31);      // the warp's neurons, the lane's
  const int f0 = fb * BN;
  const int nmt = (M + MT - 1) / MT, mt0 = q * g.per, mt1 = min(mt0 + g.per, nmt);
  const int nbk = mt1 > mt0 ? mt1 - mt0 : 0;
  const size_t dF = (size_t)d * F;
  const float* mask_c = mask + (size_t)c * M * F;
  const T* x_c = x + (size_t)c * M * d;
  const T* g_c = BWD ? gy + (size_t)c * M * d : nullptr;
  const T* wi_c = w_in + c * dF;
  const T* wg_c = GATED ? w_gate + c * dF : nullptr;
  const T* wo_c = w_out + c * dF;
  float* xb = dsm + g.region + (size_t)grp * g.gbuf;   // x (and gy) slots 0 and 1
  float* hb = xb + 2 * g.slot;
  float* op = hb + (BWD && GATED ? 2 : 1) * BN * MT;
  int* kept = reinterpret_cast<int*>(dsm + g.region + (size_t)FD_NG * g.gbuf);
  float* part_c = part + ((size_t)fb * C + c) * M * d;

  // which of this block's m-tiles does some row keep? A warp reads whole
  // 128-neuron rows of the mask, 16 bytes a lane, 8 rows in flight.
  for (int i = tid; i < nbk; i += FD_THREADS) kept[i] = 0;
  __syncthreads();
  bool mine = false;
  const int rows_b = nbk ? min(nbk * MT, M - mt0 * MT) : 0;
  const float* mrow = mask_c + (size_t)mt0 * MT * F + f0 + 4 * (tid % 32);
  for (int r0 = tid / 32; r0 < rows_b; r0 += FD_WARPS * 8) {
    float4 mv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = r0 + u * FD_WARPS;
      mv[u] = r < rows_b ? __ldg(reinterpret_cast<const float4*>(mrow + (size_t)r * F))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool nz = mv[u].x != 0.f || mv[u].y != 0.f || mv[u].z != 0.f || mv[u].w != 0.f;
      if (nz) kept[(r0 + u * FD_WARPS) / MT] = 1;
      mine |= nz;
    }
  }
  const bool any = __syncthreads_or(mine);
  for (int i = tid; i < nbk; i += FD_THREADS)
    keep[((size_t)c * nmt + mt0 + i) * g.nfb + fb] = kept[i];
  if (!any) return;
  auto mask_of = [&](float (&rm)[MT], int m0, int rows) {
#pragma unroll
    for (int r = 0; r < MT; ++r) rm[r] = r < rows ? mask_c[(size_t)(m0 + r) * F + f0 + n] : 0.f;
  };

  if (g.resident) {
    // the group's kept m-tiles mt0 + grp + i·FD_NG in order, each one's x
    // (and gy) landing in the other slot while the group computes the last
    auto next = [&](int mt) {
      while (mt < mt1 && !kept[mt - mt0]) mt += FD_NG;
      return mt;
    };
    auto fetch = [&](int mt, float* b) {
      const int rows = min(MT, M - mt * MT);
      rows_t<T>(b, x_c, mt * MT, rows, 0, d, d, gt);
      if (BWD) rows_t<T>(b + d * MT, g_c, mt * MT, rows, 0, d, d, gt);
    };
    // the slab's pieces: W_in (and W_gate) rows a quarter of d each, and
    // W_out whole with the first piece (dx: needed by the pre-activations)
    // or the last (forward: needed only by the output)
    const int kc = ((d + FD_CHUNKS - 1) / FD_CHUNKS + 3) / 4 * 4;   // rows of d a piece
    int mt = next(mt0 + grp);
    if (mt < mt1) fetch(mt, xb);
    cp_commit();
#pragma unroll
    for (int i = 0; i < FD_CHUNKS; ++i) {
      const int k0 = min(d, i * kc), k1 = min(d, i * kc + kc);
      if (BWD && i == 0) fd_stage_out<T>(dsm, g, wo_c, 0, d, f0, d);
      if (k1 > k0) fd_stage_in<T, GATED>(dsm, g, wi_c, wg_c, k0, k1 - k0, k0, f0, F);
      if (!BWD && i == FD_CHUNKS - 1) fd_stage_out<T>(dsm, g, wo_c, 0, d, f0, d);
      cp_commit();
    }
    for (int t = 0; mt < mt1 || t == 0; ++t) {
      const bool have = mt < mt1;
      const int m0 = mt * MT, rows = have ? min(MT, M - m0) : 0;
      const float* xs = xb + (t & 1) * g.slot;
      float rm[MT], zh[MT] = {}, zg[MT] = {}, gh[MT] = {};
      if (have) mask_of(rm, m0, rows);
      int nxt;
      if (t == 0) {                     // every thread waits for each piece of the slab
#pragma unroll
        for (int i = 0; i < FD_CHUNKS; ++i) {
          cp_wait_upto3(FD_CHUNKS - 1 - i);
          __syncthreads();
          if (have)
            warp_pre<BWD, GATED>(zh, zg, gh, xs, xs + d * MT, dsm, g, min(d, i * kc),
                                 min(d, i * kc + kc), n);
        }
        if (!have) break;
        nxt = next(mt + FD_NG);
        if (nxt < mt1) fetch(nxt, xb + g.slot);
        cp_commit();
      } else {
        nxt = next(mt + FD_NG);
        if (nxt < mt1) fetch(nxt, xb + ((t + 1) & 1) * g.slot);
        cp_commit();
        cp_wait<1>();                   // this thread's copies of tile mt have landed,
        group_sync(grp);                // and the group's
        warp_pre<BWD, GATED>(zh, zg, gh, xs, xs + d * MT, dsm, g, 0, d, n);
      }
      warp_finish<T, BWD, GATED>(hb, zh, zg, gh, rm, n, act);
      for (int cc = 0; cc < d; cc += FD_COLS) {
        float acc[MT][2];
        warp_out<BWD, GATED>(acc, hb, dsm, g, d, cc, nb);
        group_put(part_c + (size_t)m0 * d, acc, op, grp, s, gt, rows, d, d, cc);
      }
      group_sync(grp);                  // slot t & 1 is consumed
      mt = nxt;
    }
    return;
  }

  // restaged: the groups take the block's m-tiles in rounds; each chunk of
  // the slab is staged by the whole block
  for (int base = mt0; base < mt1; base += FD_NG) {
    bool round_any = false;             // block-uniform
    for (int i = base - mt0; i < min(base + FD_NG, mt1) - mt0; ++i) round_any |= kept[i] != 0;
    if (!round_any) continue;
    const int mt = base + grp;
    const bool on = mt < mt1 && kept[mt - mt0];
    const int m0 = mt * MT, rows = on ? min(MT, M - m0) : 0;
    float rm[MT], zh[MT] = {}, zg[MT] = {}, gh[MT] = {};
    if (on) mask_of(rm, m0, rows);
    for (int c0 = 0; c0 < d; c0 += g.kch) {
      const int kn = min(g.kch, d - c0);
      __syncthreads();                  // the previous chunk is consumed
      fd_stage_in<T, GATED>(dsm, g, wi_c, wg_c, c0, kn, 0, f0, F);
      if (BWD) fd_stage_out<T>(dsm, g, wo_c, c0, kn, f0, d);
      if (on) {
        rows_t<T>(xb, x_c, m0, rows, c0, kn, d, gt);
        if (BWD) rows_t<T>(xb + g.kch * MT, g_c, m0, rows, c0, kn, d, gt);
      }
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (on) warp_pre<BWD, GATED>(zh, zg, gh, xb, xb + g.kch * MT, dsm, g, 0, kn, n);
    }
    if (on) warp_finish<T, BWD, GATED>(hb, zh, zg, gh, rm, n, act);
    for (int c0 = 0; c0 < d; c0 += g.kch) {
      const int kn = min(g.kch, d - c0);
      __syncthreads();
      if (BWD) fd_stage_in<T, GATED>(dsm, g, wi_c, wg_c, c0, kn, 0, f0, F);
      else fd_stage_out<T>(dsm, g, wo_c, c0, kn, f0, d);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (on)
        for (int cc = 0; cc < kn; cc += FD_COLS) {
          float acc[MT][2];
          warp_out<BWD, GATED>(acc, hb, dsm, g, kn, cc, nb);
          group_put(part_c + (size_t)m0 * d + c0, acc, op, grp, s, gt, rows, d, kn, cc);
        }
    }
  }
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(FD_THREADS, GATED ? 1 : 2)
train_fwd_kernel(const T* __restrict__ gy, const T* __restrict__ x, const T* __restrict__ w_in,
                 const T* __restrict__ w_gate, const T* __restrict__ w_out,
                 const float* __restrict__ mask, int* __restrict__ keep,
                 float* __restrict__ part, FdGeom g, int M, int d, int F, int act) {
  fd_body<T, false, GATED>(gy, x, w_in, w_gate, w_out, mask, keep, part, g, M, d, F, act);
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(FD_THREADS, GATED ? 1 : 2)
train_dx_kernel(const T* __restrict__ gy, const T* __restrict__ x, const T* __restrict__ w_in,
                const T* __restrict__ w_gate, const T* __restrict__ w_out,
                const float* __restrict__ mask, int* __restrict__ keep,
                float* __restrict__ part, FdGeom g, int M, int d, int F, int act) {
  fd_body<T, true, GATED>(gy, x, w_in, w_gate, w_out, mask, keep, part, g, M, d, F, act);
}

// out[c][m][k] = Σ over the kept f-blocks of part[fb][c][m][k], f in order,
// 4 consecutive elements a thread. A programmatic dependent of
// train_fwd_kernel / train_dx_kernel.
template <typename T>
__global__ void __launch_bounds__(256)
train_fd_reduce_kernel(const float* __restrict__ part, const int* __restrict__ keep,
                       T* __restrict__ out, int C, int M, int d, int nfb) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t total = (size_t)C * M * d;
  const size_t e0 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e0 >= total) return;
  const int nmt = (M + MT - 1) / MT;
  if (d % 4 == 0) {                     // the 4 elements lie in one row
    const int c = (int)(e0 / ((size_t)M * d)), m = (int)(e0 / d % M);
    const int* kp = keep + ((size_t)c * nmt + m / MT) * nfb;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int fb = 0; fb < nfb; ++fb)
      if (kp[fb]) {
        const float4 p = *reinterpret_cast<const float4*>(part + fb * total + e0);
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
    out[e0] = rt::from_f<T>(acc.x);
    out[e0 + 1] = rt::from_f<T>(acc.y);
    out[e0 + 2] = rt::from_f<T>(acc.z);
    out[e0 + 3] = rt::from_f<T>(acc.w);
    return;
  }
  for (size_t e = e0; e < e0 + 4 && e < total; ++e) {
    const int c = (int)(e / ((size_t)M * d)), m = (int)(e / d % M);
    const int* kp = keep + ((size_t)c * nmt + m / MT) * nfb;
    float acc = 0.f;
    for (int fb = 0; fb < nfb; ++fb)
      if (kp[fb]) acc += part[fb * total + e];
    out[e] = rt::from_f<T>(acc);
  }
}

template <typename T, bool BWD, bool GATED>
cudaError_t launch_fd(const void* gy, const void* x, const void* w_in, const void* w_gate,
                      const void* w_out, const float* mask, int* keep, float* part, void* out,
                      int C, int M, int d, int F, int act, int G, cudaStream_t s) {
  const FdGeom g = fd_geom(G, M, d, F, BWD, GATED);
  if (C == 0 || M == 0 || d == 0) return cudaSuccess;
  if (g.nfb == 0 || keep == nullptr || part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = fd_smem(g);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = BWD ? train_dx_kernel<T, GATED> : train_fwd_kernel<T, GATED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(g.G, g.nfb, C), FD_THREADS, smem, s>>>(
      static_cast<const T*>(gy), static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_gate), static_cast<const T*>(w_out), mask, keep, part, g, M, d, F,
      act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)C * M * d;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + 1023) / 1024));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, train_fd_reduce_kernel<T>, static_cast<const float*>(part),
                           static_cast<const int*>(keep), static_cast<T*>(out), C, M, d, g.nfb);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t dispatch_fd(const void* gy, const void* x, const void* w_in, const void* w_gate,
                        const void* w_out, const float* mask, int* keep, float* part, void* out,
                        int C, int M, int d, int F, int act, int G, cudaStream_t s) {
  return w_gate ? launch_fd<T, BWD, true>(gy, x, w_in, w_gate, w_out, mask, keep, part, out, C,
                                          M, d, F, act, G, s)
                : launch_fd<T, BWD, false>(gy, x, w_in, w_gate, w_out, mask, keep, part, out, C,
                                           M, d, F, act, G, s);
}

}  // namespace

// All pointers are device pointers of row-major arrays; x, gy, the weights
// and the outputs are of type `dtype` (16-byte aligned), mask is fp32;
// w_gate (and dw_gate) may be null (ungated). F % 128 == 0. Each returns
// cudaGetLastError() after its launches; none allocates or synchronises.
//
// Forward and dx: G blocks share each (client, f-block) pair's m-tiles; the
// f-blocks' fp32 partials go through keep (C, ceil(M/8), F/128) int32 and
// part (F/128, C, M, d) fp32 to the reduce.
extern "C" int masked_ffn_train_fwd_launch(
    const void* x, const void* w_in, const void* w_gate, const void* w_out,
    const float* mask, int* keep, float* part, void* y,
    int C, int M, int d, int F, int act, int dtype, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = dispatch_fd<T, false>(nullptr, x, w_in, w_gate, w_out, mask, keep, part, y, C, M, d,
                                F, act, G, s);
  });
  return rt::cleared(err);
}

extern "C" int masked_ffn_dx_launch(
    const void* gy, const void* x, const void* w_in, const void* w_gate,
    const void* w_out, const float* mask, int* keep, float* part, void* dx,
    int C, int M, int d, int F, int act, int dtype, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = dispatch_fd<T, true>(gy, x, w_in, w_gate, w_out, mask, keep, part, dx, C, M, d, F,
                               act, G, s);
  });
  return rt::cleared(err);
}

// Whether the forward (bwd = 0) or dx (bwd = 1) keeps the whole f-block
// slab resident in shared memory at this shape and split (1), or restages
// it a chunk of rows of d at a time (0).
extern "C" int masked_ffn_fd_resident(int M, int d, int F, int gated, int bwd, int G) {
  return fd_geom(G, M, d, F, bwd != 0, gated != 0).resident;
}

// dW of the training form. G blocks share each (client, f-block) pair's
// m-tiles and, where G > 1, sum their partials through `scratch` ((C,
// F/128·ceil(d/64), G, 32·(2 or 3)·256) fp32; may be null where G = 1).
// Where d > 64, `core` ((C, F/128, ceil(M/8), 3, 8, 128) fp32; may be null
// where d <= 64) takes each kept tile's (hm, dzh, dzg) from a first kernel.
extern "C" int masked_ffn_dw_launch(
    const void* gy, const void* x, const void* w_in, const void* w_gate,
    const void* w_out, const float* mask, void* dw_in, void* dw_gate,
    void* dw_out, float* scratch, float* core, int C, int M, int d, int F, int act,
    int dtype, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = w_gate ? launch_dw<T, true>(gy, x, w_in, w_gate, w_out, mask, dw_in, dw_gate,
                                      dw_out, scratch, core, C, M, d, F, act, G, s)
                 : launch_dw<T, false>(gy, x, w_in, w_gate, w_out, mask, dw_in, dw_gate,
                                       dw_out, scratch, core, C, M, d, F, act, G, s);
  });
  return rt::cleared(err);
}
