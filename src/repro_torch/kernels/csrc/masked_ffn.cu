// Per-row-masked FFN forward for Hopper (sm_90a):
//   y = ((act(x·W_gate) ⊙ x·W_in) ⊙ row_mask) · W_out      (gated)
//   y = (act(x·W_in) ⊙ row_mask) · W_out                     (ungated)
//
// Replaces the Pallas kernel repro/kernels/masked_ffn.py::_fwd_kernel in
// its per-row form (entry point masked_ffn_batch). The semantics are the
// Pallas kernel's: a (8-row m-tile, 128-neuron f-block) tile is skipped
// when no row of the tile keeps any neuron of the block, and none of its
// W_in, W_gate or W_out bytes is read; kept tiles apply the exact per-row
// mask; the masked hidden activation is rounded to the input type before
// the down product; all sums are fp32, in a fixed order (no atomics, so
// two calls give the same bits). Masks are data: a new mask never means a
// new build or template instance. A row whose mask is all zero comes out
// exactly 0.
//
// What bounds it on an H100: at decode M <= 16 rows, so this is a batched
// GEMV that reads each kept weight byte once and does ~M FLOPs per
// weight, far below the ~295 FLOP/byte ridge. Bytes bound it:
// 3·d·F·2 B = 424.7 MB at d=5120, F=13824 in bf16, >= 127 us at 3.35 TB/s
// with every block kept.
//
// bf16 (the serve): two launches on the tensor cores, each a thread-block
// cluster that sums its blocks' fp32 partials in rank order through
// distributed shared memory, so no partial goes through device memory.
//   1. up:   a cluster of KS blocks per (f-block, m-tile), block q taking
//            the q-th KS-th of d. It ORs the row mask over its tile itself
//            (rank 0 records it in `keep`); a dropped tile returns before
//            any weight load. A kept tile streams 64-row stages of W_in and
//            W_gate (256 B a row, swizzled) and the x rows through a
//            cp.async ring, and each warp runs mma.sync m16n8k16 with the
//            operands swapped: a 16x16 piece of the weight (ldmatrix.trans)
//            times the m-tile's 8 rows (n = 8). After a cluster barrier,
//            block q sums its slice of neurons over the KS partials in rank
//            order, applies act, gate and the exact row mask, and writes
//            the hidden activation in bf16 (M, F): the only scratch.
//   2. down: a cluster of FS blocks per (128-column block of d, m-tile).
//            Each block lists the kept f-blocks of its m-tile from `keep`,
//            takes the q-th FS-th of that list, streams those W_out rows
//            and the hidden rows the same way, and after a cluster barrier
//            block q writes its slice of columns of y, summed in rank order.
//   KS and FS come from the caller, picked from the card's SM count so
//   each grid covers the SMs. The ring has NS = 3 stages of 64 rows (34 KB
//   a stage in the up pass, so two blocks fit an SM with ~130 KB in flight).
// fp32 (tests, the fp32 smoke model): FFMA in three launches, none of
// which allocates:
//   1. up:     one block per (f-block, d-split, m-tile). It ORs the row mask
//              over its tile and records it in `keep`; a dropped tile returns
//              without touching W_in/W_gate. A kept tile reduces its
//              KSPLIT-th of d for x·W_in and x·W_gate (separate threads for
//              the two matrices) and writes fp32 partial sums.
//   2. down:   each block first builds the masked hidden activation of its
//              group of FG f-blocks in shared memory (sum of the d-split
//              partials, act, gate, exact row mask, rounded to the input
//              type), then each warp streams 16-byte column slices of the
//              kept W_out rows and writes fp32 partial sums per group.
//   3. reduce: sums the group partials in fp32 and writes y.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int BN = 128;          // neurons per f-block (BLOCK_NEURONS)
constexpr int MT = 8;            // rows per m-tile (the Pallas block_m)
constexpr int KSPLIT = 4;        // d-splits of the up pass
constexpr int PD = 4;            // weight rows in flight per up-pass thread
constexpr int UP_THREADS = 256;
constexpr int KCH = 512;         // d-chunk of x staged in shared memory
constexpr int RB = 4;            // rows per round of the k-lane reduction
constexpr int FG = 2;            // f-blocks per down-kernel group
constexpr int DN_WARPS = 4;
constexpr int SMEM_FLOATS = 8192;

using rt::act_f;

// Row k of a weight column slice, or zeros past the end of the chunk.
template <typename T>
__device__ __forceinline__ uint4 load_row(const T* base, int k, int kn, int F) {
  return k < kn ? __ldg(reinterpret_cast<const uint4*>(base + (size_t)k * F))
                : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// part_up layout: (KSPLIT, 2, M, F) fp32 — [split][matrix: 0 W_in, 1 W_gate]
template <typename T>
__global__ void __launch_bounds__(UP_THREADS)
ffn_up_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
              const T* __restrict__ w_gate, const float* __restrict__ mask,
              float* __restrict__ part_up, int* __restrict__ keep,
              int M, int d, int F) {
  constexpr int V = rt::Vec<T>::N;
  constexpr int NCG = BN / V;              // column groups across the f-block
  __shared__ float smem[SMEM_FLOATS];      // x chunk, then reduction buffer

  const int fb = blockIdx.x, split = blockIdx.y, mt = blockIdx.z;
  const int nfb = F / BN;
  const int f0 = fb * BN, m0 = mt * MT;
  const int rows = min(MT, M - m0);
  const int tid = threadIdx.x;

  // 1. tile skip: OR of the row mask over rows x 128 neurons (float4 loads)
  bool any = false;
  for (int e = tid; e < rows * BN / 4; e += UP_THREADS) {
    const float4 mv = __ldg(reinterpret_cast<const float4*>(
        mask + (size_t)(m0 + e / (BN / 4)) * F + f0) + e % (BN / 4));
    any |= (mv.x != 0.f) | (mv.y != 0.f) | (mv.z != 0.f) | (mv.w != 0.f);
  }
  any = __syncthreads_or(any);
  if (tid == 0 && split == 0) keep[mt * nfb + fb] = any ? 1 : 0;
  if (!any) return;

  // 2. this split's share of x·W for one of the matrices
  const bool gated = w_gate != nullptr;
  const int nmat = gated ? 2 : 1;
  const int tpm = UP_THREADS / nmat;       // threads per matrix
  const int KL = tpm / NCG;                // k-lanes per matrix
  const int mat = tid / tpm, lt = tid % tpm;
  const int cg = lt % NCG, kl = lt / NCG;
  const T* wcol = (mat == 0 ? w_in : w_gate) + f0 + cg * V;
  // a multiple of 8 elements, so x chunks stay 16-byte aligned
  const int kspan = ((d + KSPLIT - 1) / KSPLIT + 7) / 8 * 8;
  const int kbeg = split * kspan, kend = min(d, kbeg + kspan);

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[m][i] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += KCH) {
    const int kn = min(KCH, kend - k0);
    __syncthreads();                        // previous chunk consumed
#pragma unroll 2
    for (int e = tid; e < MT * KCH / V; e += UP_THREADS) {   // 16-byte loads
      const int m = e / (KCH / V), k = e % (KCH / V) * V;
      float xv[V];
      if (m < rows && k < kn) {
        rt::load16(x + (size_t)(m0 + m) * d + k0 + k, xv);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) smem[m * KCH + k + i] = xv[i];
    }
    __syncthreads();
    // software pipeline: a ring of PD rows' 16-byte loads stays in flight
    // while the FMAs of the oldest one run
    const T* wk = wcol + (size_t)k0 * F;
    uint4 ring[PD];
#pragma unroll
    for (int p = 0; p < PD; ++p) ring[p] = load_row(wk, kl + p * KL, kn, F);
    for (int k = kl; k < kn; k += PD * KL) {
#pragma unroll
      for (int p = 0; p < PD; ++p) {
        const int kk = k + p * KL;
        if (kk >= kn) break;
        const uint4 cur = ring[p];
        ring[p] = load_row(wk, kk + PD * KL, kn, F);
        const T* e = reinterpret_cast<const T*>(&cur);
        float w[V];
#pragma unroll
        for (int i = 0; i < V; ++i) w[i] = rt::to_f(e[i]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = smem[m * KCH + kk];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[m][i] = fmaf(xv, w[i], acc[m][i]);
        }
      }
    }
  }

  // 3. sum the KL k-lanes of each matrix, RB rows a round, into part_up
  float* dst = part_up + (size_t)split * 2 * M * F;
#pragma unroll
  for (int r0 = 0; r0 < MT; r0 += RB) {
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int i = 0; i < V; ++i)
        smem[((mat * KL + kl) * RB + rr) * BN + cg * V + i] = acc[r0 + rr][i];
    __syncthreads();
    for (int e = tid; e < nmat * RB * BN; e += UP_THREADS) {
      const int q = e / (RB * BN), rr = (e / BN) % RB, n = e % BN;
      if (r0 + rr >= rows) continue;
      float s = 0.f;
      for (int l = 0; l < KL; ++l) s += smem[((q * KL + l) * RB + rr) * BN + n];
      dst[((size_t)q * M + m0 + r0 + rr) * F + f0 + n] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(DN_WARPS * 32)
ffn_down_kernel(const float* __restrict__ part_up,
                const float* __restrict__ mask, const T* __restrict__ w_out,
                const int* __restrict__ keep, float* __restrict__ part,
                int M, int d, int F, int gated, int act) {
  constexpr int V = rt::Vec<T>::N;
  __shared__ float hs[MT][FG * BN];

  const int grp = blockIdx.y, mt = blockIdx.z;
  const int nfb = F / BN;
  const int m0 = mt * MT, rows = min(MT, M - m0);
  const int fb0 = grp * FG, nb = min(FG, nfb - fb0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = (blockIdx.x * DN_WARPS + warp) * 32 * V + lane * V;
  const size_t MF = (size_t)M * F;

  // masked hidden activation of this group, rounded to T as _fwd_kernel
  // does; four neurons per thread, every partial read as one float4
  for (int e = threadIdx.x; e < MT * FG * BN / 4; e += blockDim.x) {
    const int m = e / (FG * BN / 4), n = e % (FG * BN / 4) * 4, b = n / BN;
    float val[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < rows && b < nb && keep[mt * nfb + fb0 + b]) {
      const size_t at = (size_t)(m0 + m) * F + fb0 * BN + n;
      float4 hp[KSPLIT], gp[KSPLIT];
#pragma unroll
      for (int s = 0; s < KSPLIT; ++s) {
        hp[s] = ld4(part_up + 2 * s * MF + at);
        gp[s] = gated ? ld4(part_up + (2 * s + 1) * MF + at) : make_float4(0, 0, 0, 0);
      }
      const float4 mk4 = ld4(mask + at);
      const float mk[4] = {mk4.x, mk4.y, mk4.z, mk4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float h = 0.f, g = 0.f;
#pragma unroll
        for (int s = 0; s < KSPLIT; ++s) {
          h += (&hp[s].x)[i];
          g += (&gp[s].x)[i];
        }
        const float v = gated ? act_f(g, act) * h : act_f(h, act);
        val[i] = rt::to_f(rt::from_f<T>(mk[i] != 0.f ? v * mk[i] : 0.f));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) hs[m][n + i] = val[i];
  }
  __syncthreads();
  if (c0 >= d) return;

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[m][i] = 0.f;

  for (int b = 0; b < nb; ++b) {
    if (!keep[mt * nfb + fb0 + b]) continue;       // dropped by every row
    const T* wrow = w_out + (size_t)(fb0 + b) * BN * d + c0;
#pragma unroll 8
    for (int r = 0; r < BN; ++r) {
      float w[V];
      rt::load16(wrow + (size_t)r * d, w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float hv = hs[m][b * BN + r];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[m][i] = fmaf(hv, w[i], acc[m][i]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < rows) {
      float* dst = part + ((size_t)grp * M + m0 + m) * d + c0;
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = acc[m][i];
    }
  }
}

template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ part,
                                  T* __restrict__ y, int n, int ngrp) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int g = 0; g < ngrp; ++g) s += part[(size_t)g * n + e];
  y[e] = rt::from_f<T>(s);
}

int groups(int F) { return (F / BN + FG - 1) / FG; }

// ---------------------------------------------------------------------------
// bf16 path: mma.sync on streamed weight tiles, cluster sums

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 256;          // 8 warps, one 16-wide output tile each
constexpr int KC = 64;                   // reduction rows a stage
constexpr int ROW_B = BN * 2;            // bytes of a 128-wide weight row
constexpr int AROW_B = (KC + 8) * 2;     // bytes of a padded activation row
constexpr int NS = 3;                    // stages of the cp.async ring
constexpr int MAX_CLUSTER = 8;           // portable cluster size
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !full (nothing is read then).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d += a·b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// KC rows of a 128-column weight slice into a stage: row r's 16-byte chunk
// c lands at chunk c ^ (r & 7), so the 8 rows an ldmatrix reads fall in 8
// different bank groups. Rows >= rows_ok and chunks >= chunks_ok are zeros.
__device__ __forceinline__ void stage_weights(char* dst, const bf16* src, size_t ld,
                                              int rows_ok, int chunks_ok, int tid) {
#pragma unroll 4
  for (int e = tid; e < KC * 16; e += TC_THREADS) {
    const int r = e >> 4, c = e & 15;
    const bool ok = r < rows_ok && c < chunks_ok;
    cp16(dst + r * ROW_B + ((c ^ (r & 7)) << 4), ok ? src + r * ld + c * 8 : src, ok);
  }
}

// An m-tile's 8 activation rows, KC wide, into a stage (rows >= rows_ok and
// columns >= cols_ok are zeros; cols_ok is a multiple of 8).
__device__ __forceinline__ void stage_act(char* dst, const bf16* src, size_t ld,
                                          int rows_ok, int cols_ok, int tid) {
  if (tid < 8 * (KC / 8)) {
    const int r = tid / (KC / 8), c = tid % (KC / 8);
    const bool ok = r < rows_ok && c * 8 < cols_ok;
    cp16(dst + r * AROW_B + c * 16, ok ? src + r * ld + c * 8 : src, ok);
  }
}

// acc (16 outputs x 8 rows) += the stage's weight columns [16·ot, 16·ot + 16)
// transposed, times its activation tile transposed, over the KC rows.
__device__ __forceinline__ void mma_stage(float (&acc)[4], const char* wt, const char* at,
                                          int ot, int lane) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    unsigned b[2], a[4];
    ldsm_x2(b, smem_addr(at + (lane & 7) * AROW_B + (kk * 16 + ((lane >> 3) & 1) * 8) * 2));
    const int mi = lane >> 3, r = kk * 16 + (lane & 7) + (mi >> 1) * 8;
    const int c = ot * 2 + (mi & 1);
    ldsm_x4_trans(a, smem_addr(wt + r * ROW_B + ((c ^ (r & 7)) << 4)));
    mma_bf16(acc, a, b);
  }
}

// The warp's accumulator into part[m][o] (8 x 128 fp32) for output tile ot.
__device__ __forceinline__ void store_part(float* part, const float (&acc)[4], int ot,
                                           int lane) {
  const int o = ot * 16 + (lane >> 2), m = 2 * (lane & 3);
  part[m * BN + o] = acc[0];
  part[(m + 1) * BN + o] = acc[1];
  part[m * BN + o + 8] = acc[2];
  part[(m + 1) * BN + o + 8] = acc[3];
}

// bytes of a ring stage: the weight tile(s), then the activation rows
__host__ __device__ constexpr size_t up_stage_bytes(bool gated) {
  return (size_t)(gated ? 2 : 1) * KC * ROW_B + 8 * AROW_B;
}
__host__ __device__ constexpr size_t dn_stage_bytes() { return (size_t)KC * ROW_B + 8 * AROW_B; }

// grid (KS, F/128, m-tiles), clusters (KS, 1, 1). hbuf (M, F) bf16.
__global__ void __launch_bounds__(TC_THREADS)
ffn_up_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
                 const bf16* __restrict__ w_gate, const float* __restrict__ mask,
                 bf16* __restrict__ hbuf, int* __restrict__ keep, int M, int d, int F,
                 int act) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) char smem[];
  const int ks = gridDim.x, q = blockIdx.x, fb = blockIdx.y, mt = blockIdx.z;
  const int nfb = F / BN, f0 = fb * BN, m0 = mt * MT, rows = min(MT, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // tile skip, the same in every block of the cluster: no barrier is passed
  bool any = false;
  for (int e = tid; e < rows * BN / 4; e += TC_THREADS) {
    const float4 mv = __ldg(reinterpret_cast<const float4*>(
        mask + (size_t)(m0 + e / (BN / 4)) * F + f0) + e % (BN / 4));
    any |= (mv.x != 0.f) | (mv.y != 0.f) | (mv.z != 0.f) | (mv.w != 0.f);
  }
  any = __syncthreads_or(any);
  if (q == 0 && tid == 0) keep[mt * nfb + fb] = any ? 1 : 0;
  if (!any) return;

  const bool gated = w_gate != nullptr;
  const int nmat = gated ? 2 : 1;
  const size_t sb = up_stage_bytes(gated);
  const int nch = (d + KC - 1) / KC;
  const int c_beg = q * nch / ks, n = (q + 1) * nch / ks - c_beg;
  const bf16* xr = x + (size_t)m0 * d;

  auto issue = [&](int i) {
    char* st = smem + (size_t)(i % NS) * sb;
    const int k0 = (c_beg + i) * KC;
    stage_weights(st, w_in + (size_t)k0 * F + f0, F, d - k0, 16, tid);
    if (gated) stage_weights(st + KC * ROW_B, w_gate + (size_t)k0 * F + f0, F, d - k0, 16, tid);
    stage_act(st + nmat * KC * ROW_B, xr + k0, d, rows, d - k0, tid);
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n) issue(i);
    commit_group();                       // empty groups too: the count stays fixed
  }
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int i = 0; i < n; ++i) {
    wait_groups<NS - 2>();
    __syncthreads();                      // stage i landed; stage i - 1 consumed
    if (i + NS - 1 < n) issue(i + NS - 1);
    commit_group();
    const char* st = smem + (size_t)(i % NS) * sb;
    const char* at = st + nmat * KC * ROW_B;
    mma_stage(acc[0], st, at, warp, lane);
    if (gated) mma_stage(acc[1], st + KC * ROW_B, at, warp, lane);
  }
  wait_groups<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);           // (nmat, 8, 128)
  store_part(part, acc[0], warp, lane);
  if (gated) store_part(part + MT * BN, acc[1], warp, lane);
  cluster.sync();

  // block q: neurons [fs, fe) of the tile, partials summed in rank order
  const int fs = q * BN / ks, nf = (q + 1) * BN / ks - fs;
  for (int e = tid; e < rows * nf; e += TC_THREADS) {
    const int m = e / nf, f = fs + e % nf;
    float h = 0.f, g = 0.f;
    for (int p = 0; p < ks; ++p) {
      const float* pp = cluster.map_shared_rank(part, p);
      h += pp[m * BN + f];
      if (gated) g += pp[MT * BN + m * BN + f];
    }
    const size_t at = (size_t)(m0 + m) * F + f0 + f;
    const float mk = mask[at];
    const float v = gated ? act_f(g, act) * h : act_f(h, act);
    hbuf[at] = __float2bfloat16(mk != 0.f ? v * mk : 0.f);
  }
  cluster.sync();                         // peers keep their partials until read
}

// grid (FS, ⌈d/128⌉, m-tiles), clusters (FS, 1, 1).
__global__ void __launch_bounds__(TC_THREADS)
ffn_down_tc_kernel(const bf16* __restrict__ hbuf, const bf16* __restrict__ w_out,
                   const int* __restrict__ keep, bf16* __restrict__ y, int M, int d,
                   int F) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) char smem[];
  __shared__ int s_nk;
  const int fs = gridDim.x, q = blockIdx.x, c0 = blockIdx.y * BN, mt = blockIdx.z;
  const int nfb = F / BN, m0 = mt * MT, rows = min(MT, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t sb = dn_stage_bytes();
  int* list = reinterpret_cast<int*>(smem + NS * sb);     // kept f-blocks, in order

  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < nfb; base += 32) {
      const int fb = base + lane;
      const bool k = fb < nfb && keep[mt * nfb + fb] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, k);
      if (k) list[cnt + __popc(bal & ((1u << lane) - 1u))] = fb;
      cnt += __popc(bal);
    }
    if (lane == 0) s_nk = cnt;
  }
  __syncthreads();
  constexpr int SUB = BN / KC;                            // stages of an f-block
  const int lo = q * s_nk / fs, n = ((q + 1) * s_nk / fs - lo) * SUB;
  const int chunks_ok = min(16, (d - c0) / 8);
  const bf16* hr = hbuf + (size_t)m0 * F;

  auto issue = [&](int i) {
    char* st = smem + (size_t)(i % NS) * sb;
    const int r0 = list[lo + i / SUB] * BN + (i % SUB) * KC;
    stage_weights(st, w_out + (size_t)r0 * d + c0, d, KC, chunks_ok, tid);
    stage_act(st + KC * ROW_B, hr + r0, F, rows, KC, tid);
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n) issue(i);
    commit_group();
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n; ++i) {
    wait_groups<NS - 2>();
    __syncthreads();
    if (i + NS - 1 < n) issue(i + NS - 1);
    commit_group();
    const char* st = smem + (size_t)(i % NS) * sb;
    mma_stage(acc, st, st + KC * ROW_B, warp, lane);
  }
  wait_groups<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);           // (8, 128)
  store_part(part, acc, warp, lane);
  cluster.sync();

  // block q: columns [cs, ce) of the 128, partials summed in rank order
  const int cs = q * BN / fs, nc = (q + 1) * BN / fs - cs;
  for (int e = tid; e < rows * nc; e += TC_THREADS) {
    const int m = e / nc, c = cs + e % nc;
    if (c0 + c >= d) continue;
    float sum = 0.f;
    for (int p = 0; p < fs; ++p) sum += cluster.map_shared_rank(part, p)[m * BN + c];
    y[(size_t)(m0 + m) * d + c0 + c] = __float2bfloat16(sum);
  }
  cluster.sync();
}

// Lets `kern` take `bytes` of dynamic shared memory; `allowed` remembers
// the most set so far for that kernel.
template <typename Kern>
cudaError_t allow_smem(Kern* kern, size_t bytes, size_t& allowed) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern* kern, dim3 grid, size_t smem, cudaStream_t s,
                           Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_tc(const bf16* x, const bf16* w_in, const bf16* w_gate,
                      const bf16* w_out, const float* mask, int* keep, bf16* hbuf,
                      bf16* y, int M, int d, int F, int act, int ks, int fs,
                      cudaStream_t s) {
  const int nfb = F / BN, nmt = (M + MT - 1) / MT;
  const size_t up_smem = NS * up_stage_bytes(w_gate != nullptr);
  const size_t dn_smem = NS * dn_stage_bytes() + (size_t)nfb * sizeof(int);
  static size_t up_allowed = 0, dn_allowed = 0;
  cudaError_t err = allow_smem(ffn_up_tc_kernel, up_smem, up_allowed);
  if (err == cudaSuccess) err = allow_smem(ffn_down_tc_kernel, dn_smem, dn_allowed);
  if (err == cudaSuccess)
    err = launch_cluster(ffn_up_tc_kernel, dim3(ks, nfb, nmt), up_smem, s, x, w_in,
                         w_gate, mask, hbuf, keep, M, d, F, act);
  if (err == cudaSuccess)
    err = launch_cluster(ffn_down_tc_kernel, dim3(fs, (d + BN - 1) / BN, nmt),
                         dn_smem, s, static_cast<const bf16*>(hbuf), w_out,
                         static_cast<const int*>(keep), y, M, d, F);
  return err;
}

}  // namespace

// fp32 scratch the caller allocates. fp32: the up pass's (KSPLIT, 2, M, F)
// partials followed by the down pass's (groups, M, d) partials; bf16: the
// hidden activation, (M, F) bf16.
extern "C" long long masked_ffn_scratch_floats(int M, int d, int F, int dtype) {
  if (dtype == rt::kBF16) return ((long long)M * F + 1) / 2;
  return (long long)KSPLIT * 2 * M * F + (long long)groups(F) * M * d;
}

// x (M,d), w_in/w_gate (d,F), w_out (F,d), y (M,d): type `dtype`, row-major,
// 16-byte aligned; w_gate may be null (ungated). mask (M,F) fp32. Scratch
// from the caller: keep (ceil(M/8), F/128) int32 and
// masked_ffn_scratch_floats(M, d, F, dtype) fp32. Requires F % 128 == 0 and
// d % (16 / sizeof(dtype)) == 0. bf16 takes the clusters' sizes ks and fs
// (1..8); fp32 ignores them.
// Returns the first nonzero error of the launches.
extern "C" int masked_ffn_batch_launch(
    const void* x, const void* w_in, const void* w_gate, const void* w_out,
    const float* mask, int* keep, float* scratch, void* y,
    int M, int d, int F, int act, int dtype, int ks, int fs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16) {
    if (ks < 1 || ks > MAX_CLUSTER || fs < 1 || fs > MAX_CLUSTER) return cudaErrorInvalidValue;
    auto* hbuf = reinterpret_cast<bf16*>(scratch);
    const auto* bx = static_cast<const bf16*>(x);
    const auto* bi = static_cast<const bf16*>(w_in);
    const auto* bg = static_cast<const bf16*>(w_gate);
    const auto* bo = static_cast<const bf16*>(w_out);
    auto* by = static_cast<bf16*>(y);
    return rt::cleared(launch_tc(bx, bi, bg, bo, mask, keep, hbuf, by, M, d, F, act, ks, fs, s));
  }
  if (dtype != rt::kF32) return cudaErrorInvalidValue;
  using T = float;
  const int nfb = F / BN, nmt = (M + MT - 1) / MT, ngrp = groups(F);
  float* part_up = scratch;
  float* part_dn = scratch + (size_t)KSPLIT * 2 * M * F;
  constexpr int V = rt::Vec<T>::N;
  ffn_up_kernel<T><<<dim3(nfb, KSPLIT, nmt), UP_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_gate), mask, part_up, keep, M, d, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = DN_WARPS * 32 * V;
  ffn_down_kernel<T><<<dim3((d + cols - 1) / cols, ngrp, nmt), DN_WARPS * 32, 0, s>>>(
      part_up, mask, static_cast<const T*>(w_out), keep, part_dn, M, d, F,
      w_gate != nullptr, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = M * d;
  ffn_reduce_kernel<T><<<(n + 255) / 256, 256, 0, s>>>(part_dn, static_cast<T*>(y), n, ngrp);
  return cudaGetLastError();
}
