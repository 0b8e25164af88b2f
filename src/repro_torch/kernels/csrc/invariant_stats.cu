// Per-neuron relative-update statistic of invariant dropout, for Hopper
// (sm_90a). Replaces the Pallas kernel
// repro/kernels/invariant_stats.py::_kernel (invariant_stats :50):
//
//   stat[j] = ||W1[:, j] - W0[:, j]||_2 / (||W0[:, j]||_2 + 1e-8)
//
// for W0, W1 (d_in, n) row-major, fp32 or bf16, sums in fp32.
//
// What bounds it on an H100: each weight is read once and used for three
// flops, so bytes do: 2·d_in·n·elem bytes (8.4 MB, >= 2.5 us, at 1024 x
// 1024 fp32; 91.8 MB, >= 27 us, at a 2560 x 8960 bf16 channel-mix w_in).
//
// Design: threads map to columns and walk down rows, so a warp's loads of
// one row are coalesced. One column strip alone gives few blocks (8 at n
// 1024), so d_in is cut into slabs of SLAB rows, one block per (column
// strip, slab): the first kernel writes each slab's fp32 partial Σ(ΔW)²
// and ΣW0², the second sums them in slab order and finishes with the
// square roots and the eps after them. Deterministic, no atomics. Ragged
// n and d_in are guarded, not padded. The partials (2 · slabs · n fp32)
// come from the caller.
#include "common.cuh"

namespace {

constexpr int COLS = 128;               // columns (threads) per block
constexpr int SLAB = 32;                // rows per slab
constexpr float EPS = 1e-8f;

template <typename T>
__global__ void __launch_bounds__(COLS)
stats_partial_kernel(const T* __restrict__ w0, const T* __restrict__ w1,
                     float* __restrict__ pnum, float* __restrict__ pden,
                     int d_in, int n) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  if (col >= n) return;
  const int r0 = blockIdx.y * SLAB, r1 = min(r0 + SLAB, d_in);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const float a = rt::to_f(w0[(size_t)r * n + col]);
    const float d = rt::to_f(w1[(size_t)r * n + col]) - a;
    num = fmaf(d, d, num);
    den = fmaf(a, a, den);
  }
  pnum[(size_t)blockIdx.y * n + col] = num;
  pden[(size_t)blockIdx.y * n + col] = den;
}

__global__ void __launch_bounds__(COLS)
stats_final_kernel(const float* __restrict__ pnum, const float* __restrict__ pden,
                   float* __restrict__ out, int slabs, int n) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  if (col >= n) return;
  float num = 0.f, den = 0.f;
  for (int s = 0; s < slabs; ++s) {
    num += pnum[(size_t)s * n + col];
    den += pden[(size_t)s * n + col];
  }
  out[col] = sqrtf(num) / (sqrtf(den) + EPS);
}

template <typename T>
cudaError_t launch(const void* w0, const void* w1, float* partials, float* out,
                   int d_in, int n, cudaStream_t s) {
  const int strips = (n + COLS - 1) / COLS, slabs = (d_in + SLAB - 1) / SLAB;
  float* pnum = partials;
  float* pden = partials + (size_t)slabs * n;
  stats_partial_kernel<T><<<dim3(strips, slabs), COLS, 0, s>>>(
      static_cast<const T*>(w0), static_cast<const T*>(w1), pnum, pden, d_in, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_final_kernel<<<strips, COLS, 0, s>>>(pnum, pden, out, slabs, n);
  return cudaGetLastError();
}

}  // namespace

// w0, w1 (d_in, n) of type `dtype`, contiguous; partials (2, slabs, n) with
// slabs = ceil(d_in / 32) (kernels/invariant_stats.py SLAB_ROWS) and out
// (n,) fp32. Requires d_in, n >= 1. Returns cudaGetLastError() of the
// second launch (or of the first, if it failed).
extern "C" int invariant_stats_launch(const void* w0, const void* w1, float* partials,
                                      float* out, int d_in, int n, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_in < 1 || n < 1) return cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, { return launch<T>(w0, w1, partials, out, d_in, n, s); });
  return cudaGetLastError();
}
