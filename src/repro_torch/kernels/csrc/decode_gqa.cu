// Single-token grouped-query attention over a ragged KV cache, for Hopper
// (sm_90a). Replaces the Pallas kernel repro/kernels/decode_gqa.py::_kernel.
//
//   out[b, h] = softmax(q[b, h] · k[b, :len_b, h / G]ᵀ / sqrt(hd)) · v[b, :len_b, h / G]
//
// with the Pallas kernel's arithmetic: fp32 scores, a running max, sum and
// accumulator per head (online softmax over cache tiles), and
// out = acc / max(l, 1e-30) in the query's type.
//
// What bounds it on an H100: each K/V row of the valid prefix is read once
// and used by G query heads, so the kernel moves 2·len_b·KV·hd·2 B per batch
// row in bf16 and does ~4·G FLOPs per cached element — bytes bound it
// (18.9 MB, >= 5.6 us, at B=8, KV=8, hd=128, C=576 with full lengths).
//
// Design: one block per (kv head, batch row); the block owns the G query
// heads that share that K/V head, so each K/V row is read once. The
// Pallas grid's sequential C axis becomes a loop inside the block over
// tiles of TC positions up to len_b (positions past len_b are never read,
// where the TPU kernel masks them with -1e30). Groups of hd/8 lanes each
// load one 16-byte slice of a K row, reduce the dot products with warp
// shuffles, and later accumulate p·V for their own positions; the groups'
// partial accumulators are summed through shared memory at the end. Each
// group keeps UN positions' loads in flight, which hides the memory latency
// that otherwise bounds a block walking a long prefix.
// With B·KV = 64 blocks the card's 132 SMs are not all busy: splitting the
// cache axis across blocks is the next step. Nothing is allocated here.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TC = 128;            // cache positions per tile
constexpr float NEG = -1e30f;
constexpr int UN = 4;              // cache positions loaded ahead per group

// This lane's 16 bytes of cache position t0 + j, or zeros past the tile.
template <typename T>
__device__ __forceinline__ uint4 load_pos(const T* base, int t0, int j, int n,
                                          size_t stride) {
  return j < n ? __ldg(reinterpret_cast<const uint4*>(base + (size_t)(t0 + j) * stride))
               : make_uint4(0, 0, 0, 0);
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ out, int C, int KV, int hd, float scale) {
  constexpr int V = rt::Vec<T>::N;
  __shared__ float s_p[G][TC];               // scores, then probabilities
  __shared__ float s_m[G], s_l[G], s_corr[G];
  __shared__ float s_red[THREADS * G * V];   // (groups, G, hd) partials

  const int kh = blockIdx.x, b = blockIdx.y;
  const int H = KV * G;
  const int lpg = hd / V;                    // lanes per group: power of 2, <= 32
  const int ng = THREADS / lpg;              // groups in the block
  const int tid = threadIdx.x, grp = tid / lpg, lig = tid % lpg;
  const int len = min(lengths[b], C);

  float qv[G][V], acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    rt::load16(q + ((size_t)b * H + kh * G + g) * hd + lig * V, qv[g]);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[g][i] = 0.f;
  }
  if (tid < G) { s_m[tid] = NEG; s_l[tid] = 0.f; }
  __syncthreads();

  const size_t pos_stride = (size_t)KV * hd;
  const T* kb = k + ((size_t)b * C * KV + kh) * hd + lig * V;
  const T* vb = v + ((size_t)b * C * KV + kh) * hd + lig * V;

  for (int t0 = 0; t0 < len; t0 += TC) {
    const int n = min(TC, len - t0);
    // scores: every lane runs the same trip count so the shuffles converge;
    // UN positions' K rows are loaded before any of them is used
    for (int j0 = 0; j0 < n; j0 += UN * ng) {
      uint4 raw[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u)
        raw[u] = load_pos(kb, t0, j0 + u * ng + grp, n, pos_stride);
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int j = j0 + u * ng + grp;
        const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) s = fmaf(qv[g][i], rt::to_f(e[i]), s);
          for (int off = lpg / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lig == 0 && j < n) s_p[g][j] = s * scale;
        }
      }
    }
    __syncthreads();
    if (tid < 32) {            // warp 0: the tile's online-softmax statistics
      for (int g = 0; g < G; ++g) {
        float mx = NEG;
        for (int j = tid; j < n; j += 32) mx = fmaxf(mx, s_p[g][j]);
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = s_m[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = tid; j < n; j += 32) {
          const float p = expf(s_p[g][j] - m_new);
          s_p[g][j] = p;
          sum += p;
        }
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tid == 0) {
          const float corr = expf(m_old - m_new);
          s_corr[g] = corr;
          s_l[g] = s_l[g] * corr + sum;
          s_m[g] = m_new;
        }
        __syncwarp();
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = s_corr[g];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[g][i] *= corr;
    }
    for (int j0 = grp; j0 < n; j0 += UN * ng) {
      uint4 raw[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) raw[u] = load_pos(vb, t0, j0 + u * ng, n, pos_stride);
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int j = j0 + u * ng;
        if (j >= n) break;
        const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = s_p[g][j];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[g][i] = fmaf(p, rt::to_f(e[i]), acc[g][i]);
        }
      }
    }
    __syncthreads();           // s_p is rewritten by the next tile
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < V; ++i)
      s_red[(grp * G + g) * hd + lig * V + i] = acc[g][i];
  __syncthreads();
  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd, dd = e % hd;
    float s = 0.f;
    for (int r = 0; r < ng; ++r) s += s_red[(r * G + g) * hd + dd];
    out[((size_t)b * H + kh * G + g) * hd + dd] =
        rt::from_f<T>(s / fmaxf(s_l[g], 1e-30f));
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int KV, int C,
                   int hd, float scale, cudaStream_t s) {
  decode_gqa_kernel<T, G><<<dim3(KV, B), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), C, KV, hd,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,hd), k/v (B,C,KV,hd), out (B,H,hd): type `dtype`, contiguous,
// 16-byte aligned; lengths (B,) int32 in [1, C]. Requires H = KV·G with
// G in {1, 2, 4, 8}, and hd / (16 / sizeof(dtype)) a power of two <= 32.
// Returns cudaGetLastError() of the launch.
extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const int* lengths, void* out, int B, int H,
                                 int KV, int C, int hd, float scale,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  RT_DISPATCH(dtype, T, {
    switch (G) {
      case 1: return launch<T, 1>(q, k, v, lengths, out, B, KV, C, hd, scale, s);
      case 2: return launch<T, 2>(q, k, v, lengths, out, B, KV, C, hd, scale, s);
      case 4: return launch<T, 4>(q, k, v, lengths, out, B, KV, C, hd, scale, s);
      case 8: return launch<T, 8>(q, k, v, lengths, out, B, KV, C, hd, scale, s);
      default: return cudaErrorInvalidValue;
    }
  });
  return cudaGetLastError();
}
