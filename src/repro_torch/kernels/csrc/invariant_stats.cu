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
// Design: one launch. A row group of LPR lanes reads LPR·VB bytes of a row,
// VB bytes a lane (16 where the row's bytes allow, else 8, 4 or 2: rows need
// not be 16-byte aligned); the columns are cut into strips of that width
// and d_in into cs slabs. A thread-block cluster of cs blocks takes a strip,
// block q of it the slab of rows [q·rpb, (q+1)·rpb); a block's 256 threads
// are THREADS / LPR row groups, each walking rows g, g + GROUPS, ... with
// UNROLL rows' loads in flight (kept packed until they are summed). LPR is
// 32 (512-byte runs of a row, which DRAM serves best) where that still gives
// every SM a block, else 16 or 8 (launch_geometry). A thread sums its rows in
// order; the block adds its row groups' fp32 partials in group order and
// stores them into block 0's shared memory (distributed shared memory);
// after one cluster barrier block 0 adds the blocks' partials in rank order
// and writes the square roots and the eps after them. Deterministic, no
// atomics, no scratch. Ragged n and d_in are guarded, not padded.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int UNROLL = 4;               // rows a thread has in flight
constexpr int MAX_CLUSTER = 8;          // portable cluster size
constexpr float EPS = 1e-8f;

// VB bytes of raw elements, and their fp32 values
template <int VB>
using Raw = typename std::conditional<VB == 16, uint4, typename std::conditional<
    VB == 8, uint2, typename std::conditional<VB == 4, unsigned, unsigned short>::type>::type>::type;

template <typename T, int VB>
__device__ __forceinline__ void to_f(const Raw<VB>& raw, float (&o)[VB / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(VB / sizeof(T)); ++i) o[i] = rt::to_f(e[i]);
}

// grid (cs, strips), clusters (cs, 1, 1); rpb rows a block.
template <typename T, int VB, int LPR>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ w0, const T* __restrict__ w1, float* __restrict__ out,
             int d_in, int n, int rpb) {
  constexpr int VEC = VB / (int)sizeof(T), GROUPS = THREADS / LPR, COLS = LPR * VEC;
  __shared__ __align__(16) float part[2][GROUPS][COLS];          // a row group's sums
  __shared__ __align__(16) float slot[MAX_CLUSTER][2][COLS];     // block 0's: the blocks'
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank(), cs = (int)gridDim.x;
  const int lane = threadIdx.x % LPR, g = threadIdx.x / LPR;
  const int col = blockIdx.y * COLS + lane * VEC;   // n % VEC == 0: a vector is all in or out
  const int r0 = q * rpb, r1 = min(d_in, r0 + rpb);
  float num[VEC], den[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) num[e] = den[e] = 0.f;
  if (col < n) {
    const Raw<VB>* p0 = reinterpret_cast<const Raw<VB>*>(w0 + col);
    const Raw<VB>* p1 = reinterpret_cast<const Raw<VB>*>(w1 + col);
    const size_t ld = (size_t)n / VEC;             // a row, in Raw units
    for (int r = r0 + g; r < r1; r += GROUPS * UNROLL) {
      Raw<VB> a[UNROLL], b[UNROLL];
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        const int row = r + x * GROUPS;
        a[x] = row < r1 ? __ldg(p0 + row * ld) : Raw<VB>{};   // zeros add exact zeros
        b[x] = row < r1 ? __ldg(p1 + row * ld) : Raw<VB>{};
      }
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        float fa[VEC], fb[VEC];
        to_f<T, VB>(a[x], fa);
        to_f<T, VB>(b[x], fb);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = fb[e] - fa[e];
          num[e] = fmaf(d, d, num[e]);
          den[e] = fmaf(fa[e], fa[e], den[e]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    part[0][g][lane * VEC + e] = num[e];
    part[1][g][lane * VEC + e] = den[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * COLS; i += THREADS) {   // the row groups, in order
    const int w = i / COLS, cc = i % COLS;
    float acc = 0.f;
#pragma unroll 8
    for (int gg = 0; gg < GROUPS; ++gg) acc += part[w][gg][cc];
    *cluster.map_shared_rank(&slot[q][w][cc], 0) = acc;
  }
  cluster.sync();                        // every block's sums are in block 0
  if (q == 0) {
    for (int cc = threadIdx.x; cc < COLS; cc += THREADS) {   // the blocks, in rank order
      float sn = 0.f, sd = 0.f;
      for (int k = 0; k < cs; ++k) {
        sn += slot[k][0][cc];
        sd += slot[k][1][cc];
      }
      const int j = blockIdx.y * COLS + cc;
      if (j < n) out[j] = sqrtf(sn) / (sqrtf(sd) + EPS);
    }
  }
}

template <typename T, int VB, int LPR>
cudaError_t launch(const void* w0, const void* w1, float* out, int d_in, int n, int cs,
                   cudaStream_t s) {
  constexpr int COLS = LPR * VB / (int)sizeof(T);
  const int strips = (n + COLS - 1) / COLS, rpb = (d_in + cs - 1) / cs;
  if (strips > 65535) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, strips);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return rt::cleared(cudaLaunchKernelEx(&cfg, stats_kernel<T, VB, LPR>,
                                        static_cast<const T*>(w0), static_cast<const T*>(w1),
                                        out, d_in, n, rpb));
}

template <typename T, int VB>
cudaError_t launch_lpr(const void* w0, const void* w1, float* out, int d_in, int n, int lpr,
                       int cs, cudaStream_t s) {
  switch (lpr) {
    case 8: return launch<T, VB, 8>(w0, w1, out, d_in, n, cs, s);
    case 16: return launch<T, VB, 16>(w0, w1, out, d_in, n, cs, s);
    case 32: return launch<T, VB, 32>(w0, w1, out, d_in, n, cs, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_vb(const void* w0, const void* w1, float* out, int d_in, int n, int vb,
                      int lpr, int cs, cudaStream_t s) {
  if ((size_t)n * sizeof(T) % vb || vb < (int)sizeof(T)) return cudaErrorInvalidValue;
  switch (vb) {
    case 16: return launch_lpr<T, 16>(w0, w1, out, d_in, n, lpr, cs, s);
    case 8: return launch_lpr<T, 8>(w0, w1, out, d_in, n, lpr, cs, s);
    case 4: return launch_lpr<T, 4>(w0, w1, out, d_in, n, lpr, cs, s);
    case 2:
      if constexpr (sizeof(T) == 2) return launch_lpr<T, 2>(w0, w1, out, d_in, n, lpr, cs, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// w0, w1 (d_in, n) of type `dtype`, contiguous, 16-byte aligned; out (n,)
// fp32. vb: bytes a lane loads (16, 8, 4 or 2; it divides n·elem); lpr:
// lanes a row group (8, 16 or 32); cs: blocks of a cluster (1..8). Requires
// d_in, n >= 1. Returns the launch's error.
extern "C" int invariant_stats_launch(const void* w0, const void* w1, float* out, int d_in,
                                      int n, int dtype, int vb, int lpr, int cs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_in < 1 || n < 1 || cs < 1 || cs > MAX_CLUSTER) return cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, { return launch_vb<T>(w0, w1, out, d_in, n, vb, lpr, cs, s); });
  return cudaGetLastError();
}
