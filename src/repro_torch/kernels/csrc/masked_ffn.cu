// Per-row-masked FFN forward for Hopper (sm_90a):
//   y = ((act(x·W_gate) ⊙ x·W_in) ⊙ row_mask) · W_out      (gated)
//   y = (act(x·W_in) ⊙ row_mask) · W_out                     (ungated)
//
// Replaces the Pallas kernel repro/kernels/masked_ffn.py::_fwd_kernel in
// its per-row form (entry point masked_ffn_batch). The semantics are the
// Pallas kernel's: a (8-row m-tile, 128-neuron f-block) tile is skipped
// when no row of the tile keeps any neuron of the block; kept tiles apply
// the exact per-row mask; the masked hidden activation is rounded to the
// input type before the down product; all sums are fp32.
//
// What bounds it on an H100: at decode M <= 16 rows, so this is a batched
// GEMV that reads each kept weight byte once and does ~M FLOPs per
// weight — far below the ~295 FLOP/byte ridge. Bytes bound it:
// 3·d·F·2 B = 424.7 MB at d=5120, F=13824 in bf16, >= 127 us at 3.35 TB/s
// with every block kept. What the design does about it: stream only the
// kept weight tiles, with 16-byte loads, and keep enough loads in flight on
// every SM to cover the memory latency (many resident warps, each keeping
// PD rows' loads in flight).
//
// Hopper has no sequential grid, so the Pallas kernel's fp32 accumulator
// revisited across f-blocks does not carry over. The work splits into
// three launches on the caller's stream, none of which allocates:
//   1. up:     one block per (f-block, d-split, m-tile). It ORs the row mask
//              over its tile itself (no scalar prefetch) and records it in
//              `keep`; a dropped tile returns without touching W_in/W_gate.
//              A kept tile reduces its KSPLIT-th of d for x·W_in and x·W_gate
//              (separate threads for the two matrices) and writes fp32
//              partial sums.
//   2. down:   each block first builds the masked hidden activation of its
//              group of FG f-blocks in shared memory (sum of the d-split
//              partials, act, gate, exact row mask, rounded to the input
//              type), then each warp streams 16-byte column slices of the
//              kept W_out rows and writes fp32 partial sums per group.
//   3. reduce: sums the group partials in fp32 and writes y in the input
//              type. No atomics anywhere: the result is deterministic.
// Masks are data: a new mask never means a new build or template instance.
// A row whose mask is all zero comes out exactly 0.
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

}  // namespace

// fp32 scratch the caller allocates: the up pass's (KSPLIT, 2, M, F)
// partials followed by the down pass's (groups, M, d) partials.
extern "C" long long masked_ffn_scratch_floats(int M, int d, int F) {
  return (long long)KSPLIT * 2 * M * F + (long long)groups(F) * M * d;
}

// x (M,d), w_in/w_gate (d,F), w_out (F,d), y (M,d): type `dtype`, row-major,
// 16-byte aligned; w_gate may be null (ungated). mask (M,F) fp32. Scratch
// from the caller: keep (ceil(M/8), F/128) int32 and
// masked_ffn_scratch_floats(M, d, F) fp32. Requires F % 128 == 0 and
// d % (16 / sizeof(dtype)) == 0. Returns cudaGetLastError() of the launches.
extern "C" int masked_ffn_batch_launch(
    const void* x, const void* w_in, const void* w_gate, const void* w_out,
    const float* mask, int* keep, float* scratch, void* y,
    int M, int d, int F, int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nfb = F / BN, nmt = (M + MT - 1) / MT, ngrp = groups(F);
  float* part_up = scratch;
  float* part_dn = scratch + (size_t)KSPLIT * 2 * M * F;
  RT_DISPATCH(dtype, T, {
    constexpr int V = rt::Vec<T>::N;
    ffn_up_kernel<T><<<dim3(nfb, KSPLIT, nmt), UP_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w_in),
        static_cast<const T*>(w_gate), mask, part_up, keep, M, d, F);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int cols = DN_WARPS * 32 * V;
    ffn_down_kernel<T><<<dim3((d + cols - 1) / cols, ngrp, nmt),
                         DN_WARPS * 32, 0, s>>>(
        part_up, mask, static_cast<const T*>(w_out), keep, part_dn, M, d, F,
        w_gate != nullptr, act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n = M * d;
    ffn_reduce_kernel<T><<<(n + 255) / 256, 256, 0, s>>>(
        part_dn, static_cast<T*>(y), n, ngrp);
  });
  return cudaGetLastError();
}
