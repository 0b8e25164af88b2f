// Head-masked attention projections for training on Hopper (sm_90a): the
// forward and backward of the Q/K/V projection y = x·W and the O merge
// y = a·W_o, where a client's dropped heads are skipped, for C clients at
// once, each with its own weights and (C, H) 0/1 head mask. Heads are
// contiguous in the head-partitioned axis, head-dim fastest (hd columns or
// rows per head).
//
// Replaces the Pallas kernels of repro/kernels/masked_attn.py as the fleet
// runs them under jax.vmap (one grid axis more per client). Three kernel
// bodies cover the six functions, one launch each:
//   head_slab_kernel  per-head output slab, zero if dropped
//     masked_head_proj_launch      <- _proj_kernel     (:54, via _proj_vjp._impl :153)
//     masked_head_merge_da_launch  <- _merge_da_kernel (:120, via _merge_vjp._da :242)
//   head_sum_kernel   sum over the kept heads into one output, head order
//     masked_head_proj_dx_launch   <- _proj_dx_kernel  (:68, via _proj_vjp._dx :171)
//     masked_head_merge_launch     <- _merge_kernel    (:103, via _merge_vjp._impl :224)
//   head_dw_kernel    per-head dW slab over 128-row m-tiles in order
//     masked_head_proj_dw_launch   <- _proj_dw_kernel  (:85, via _proj_vjp._dw :189)
//     masked_head_merge_dw_launch  <- _proj_dw_kernel  (:85, via _merge_vjp._dw :260)
//
// What bounds it on an H100: at the femnist_attn widths (M 490 rows a
// client, d 64, H 4 heads of hd 16, fp32) a client's call moves about
// 0.27 MB for 4 MFLOP, 15 FLOP per byte, and a whole call at C 5 is a
// fraction of a microsecond of memory time: launch latency and the serial
// dot products bound it. The design stages a row tile's operands and the
// client's whole weight (16 KB) in shared memory once, with padded rows so
// the reads are bank-conflict free, and loops over the kept heads inside
// the block (several heads per program: hd 16 is far below a tile).
// fp32 FFMA throughout, so the sums are the plain version's up to order.
//
// Hopper has no sequential grid, so the Pallas accumulators revisited
// across the grid become loops inside one block: the sum kernel adds each
// kept head's dot product to its fp32 total in head order; the dW kernel
// owns a (client, head) slab and walks the 128-row m-tiles in order,
// adding each tile's dot product to its total. No atomics: every sum's
// order is fixed. A dropped head's outputs are written as explicit zeros
// (outputs come from torch.empty), and its products are skipped. The mask
// is data read on the device: a new keep-map never builds a new kernel.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 32;          // rows of a tile in the slab and sum kernels
constexpr int MT = 128;         // rows of an m-tile of the dW sums (Pallas block_m)
constexpr int RC = 32;          // rows staged at a time inside an m-tile
constexpr int OPT = 4;          // dW outputs per thread
constexpr int SLAB_OUT = THREADS * OPT;   // dW outputs per block
constexpr size_t STATIC_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

enum Body : int { kSlab = 0, kSum = 1, kDw = 2 };

// Shared memory of each body, in bytes. kSlab: (K in width, N out width);
// kSum: (N in width, K out width); kDw: (I, J) of the output slab.
size_t smem_bytes(int body, int w1, int w2) {
  if (body == kDw) return sizeof(float) * (size_t)RC * (w1 + 1 + w2 + 1);
  return sizeof(float) * ((size_t)TM * (w1 + 1) + (size_t)w1 * (w2 + 1));
}

template <typename Kern>
cudaError_t allow_smem(Kern* kern, size_t bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// out[c][m][j] = Σ_k in[c][m][k]·B(k, j) for the columns j of kept heads,
// 0 for the columns of dropped heads; j < N = H·hd.
//   TRANS = false: B(k, j) = w[c][k][j], w (C, K, N)    (proj)
//   TRANS = true:  B(k, j) = w[c][j][k], w (C, N, K)    (merge da)
// grid (row tiles of TM, C). Shared: the row tile [TM][K+1] and the kept
// heads' columns of B [K][N+1].
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
head_slab_kernel(const T* __restrict__ in, const T* __restrict__ w,
                 const float* __restrict__ mask, T* __restrict__ out, int M,
                 int K, int H, int hd) {
  extern __shared__ float sm[];
  const int N = H * hd, c = blockIdx.y, m0 = blockIdx.x * TM;
  const int rows = min(TM, M - m0), ldi = K + 1, ldw = N + 1, tid = threadIdx.x;
  float* is = sm;
  float* ws = sm + TM * ldi;
  const float* mk = mask + (size_t)c * H;
  const T* in_c = in + ((size_t)c * M + m0) * K;
  const T* w_c = w + (size_t)c * K * N;
  T* out_c = out + ((size_t)c * M + m0) * N;

  for (int e = tid; e < rows * K; e += THREADS)
    is[(e / K) * ldi + e % K] = rt::to_f(in_c[e]);
  for (int e = tid; e < K * N; e += THREADS) {      // coalesced along w's rows
    const int k = TRANS ? e % K : e / N, j = TRANS ? e / K : e % N;
    if (mk[j / hd] != 0.f) ws[k * ldw + j] = rt::to_f(w_c[e]);
  }
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    const bool kept = mk[h] != 0.f;                  // block-uniform
    for (int o = tid; o < rows * hd; o += THREADS) {
      const int r = o / hd, j = h * hd + o % hd;
      float acc = 0.f;
      if (kept) {
        const float* ir = is + r * ldi;
#pragma unroll 8
        for (int k = 0; k < K; ++k) acc = fmaf(ir[k], ws[k * ldw + j], acc);
      }
      out_c[(size_t)r * N + j] = rt::from_f<T>(acc);
    }
  }
}

// out[c][m][k] = Σ over kept heads h, in order, of
//                Σ_e in[c][m][h·hd + e]·B(h·hd + e, k);   k < K.
//   TRANS = false: B(j, k) = w[c][j][k], w (C, N, K)    (merge)
//   TRANS = true:  B(j, k) = w[c][k][j], w (C, K, N)    (proj dx)
// grid (row tiles of TM, C). Shared: the row tile [TM][N+1] and the kept
// heads' rows of B [N][K+1].
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
head_sum_kernel(const T* __restrict__ in, const T* __restrict__ w,
                const float* __restrict__ mask, T* __restrict__ out, int M,
                int K, int H, int hd) {
  extern __shared__ float sm[];
  const int N = H * hd, c = blockIdx.y, m0 = blockIdx.x * TM;
  const int rows = min(TM, M - m0), ldi = N + 1, ldw = K + 1, tid = threadIdx.x;
  float* is = sm;
  float* ws = sm + TM * ldi;
  const float* mk = mask + (size_t)c * H;
  const T* in_c = in + ((size_t)c * M + m0) * N;
  const T* w_c = w + (size_t)c * K * N;
  T* out_c = out + ((size_t)c * M + m0) * K;

  for (int e = tid; e < rows * N; e += THREADS) {
    const int j = e % N;
    if (mk[j / hd] != 0.f) is[(e / N) * ldi + j] = rt::to_f(in_c[e]);
  }
  for (int e = tid; e < K * N; e += THREADS) {      // coalesced along w's rows
    const int j = TRANS ? e % N : e / K, k = TRANS ? e / N : e % K;
    if (mk[j / hd] != 0.f) ws[j * ldw + k] = rt::to_f(w_c[e]);
  }
  __syncthreads();

  for (int o = tid; o < rows * K; o += THREADS) {
    const int r = o / K, k = o % K;
    const float* ir = is + r * ldi;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) {
      if (mk[h] == 0.f) continue;                    // block-uniform
      float part = 0.f;
      for (int e = h * hd; e < (h + 1) * hd; ++e)
        part = fmaf(ir[e], ws[e * ldw + k], part);
      acc += part;
    }
    out_c[(size_t)r * K + k] = rt::from_f<T>(acc);
  }
}

// One (client, head) dW slab: out[i][j] = Σ over 128-row m-tiles, in
// order, of Σ_{m in tile} L[m][i]·R[m][j]; i < I, j < J. L and R are row
// tiles of two (C, M, ·) operands, one of them cut to the head's columns:
//   proj dW:  L = x (width K = I),       R = gy[:, head] (J = hd),
//             out = dW[c][:, head]  (dW (C, K, N), row stride N)
//   merge dW: L = a[:, head] (I = hd),   R = gy (width d = J),
//             out = dW_o[c][head, :] (dW_o (C, N, d), row stride d)
struct DwArgs {
  const void* L;
  const void* R;
  void* out;
  int ldl, hl;        // L's row stride; column offset per head (0 or hd)
  int ldr, hr;        // R's row stride; column offset per head
  int I, J;           // the slab's shape
  int ldo;            // out's row stride
  long long ho;       // out's offset per head
  long long oc;       // out's elements per client
};

// grid (H, slab chunks of SLAB_OUT outputs, C). Shared: RC staged rows of
// L [RC][I+1] and of R [RC][J+1].
template <typename T>
__global__ void __launch_bounds__(THREADS)
head_dw_kernel(DwArgs a, const float* __restrict__ mask, int M, int H) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, c = blockIdx.z, tid = threadIdx.x;
  const int I = a.I, J = a.J, ldl_s = I + 1, ldr_s = J + 1;
  const int o0 = blockIdx.y * SLAB_OUT, o1 = min(I * J, o0 + SLAB_OUT);
  T* out = static_cast<T*>(a.out) + c * a.oc + h * a.ho;

  if (mask[(size_t)c * H + h] == 0.f) {              // dropped: exact zeros
    for (int o = o0 + tid; o < o1; o += THREADS)
      out[(size_t)(o / J) * a.ldo + o % J] = rt::from_f<T>(0.f);
    return;
  }
  float* ls = sm;
  float* rs = sm + RC * ldl_s;
  const T* L = static_cast<const T*>(a.L) + (size_t)c * M * a.ldl + h * a.hl;
  const T* R = static_cast<const T*>(a.R) + (size_t)c * M * a.ldr + h * a.hr;

  float acc[OPT];
#pragma unroll
  for (int p = 0; p < OPT; ++p) acc[p] = 0.f;
  for (int t0 = 0; t0 < M; t0 += MT) {
    const int t1 = min(M, t0 + MT);
    float part[OPT];
#pragma unroll
    for (int p = 0; p < OPT; ++p) part[p] = 0.f;
    for (int r0 = t0; r0 < t1; r0 += RC) {
      const int rn = min(RC, t1 - r0);
      __syncthreads();                               // previous rows consumed
      for (int e = tid; e < rn * I; e += THREADS)
        ls[(e / I) * ldl_s + e % I] = rt::to_f(L[(size_t)(r0 + e / I) * a.ldl + e % I]);
      for (int e = tid; e < rn * J; e += THREADS)
        rs[(e / J) * ldr_s + e % J] = rt::to_f(R[(size_t)(r0 + e / J) * a.ldr + e % J]);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < OPT; ++p) {
        const int o = o0 + tid + p * THREADS;
        if (o < o1) {
          const int i = o / J, j = o % J;
          for (int r = 0; r < rn; ++r)
            part[p] = fmaf(ls[r * ldl_s + i], rs[r * ldr_s + j], part[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < OPT; ++p) acc[p] += part[p];
  }
#pragma unroll
  for (int p = 0; p < OPT; ++p) {
    const int o = o0 + tid + p * THREADS;
    if (o < o1) out[(size_t)(o / J) * a.ldo + o % J] = rt::from_f<T>(acc[p]);
  }
}

template <typename T, bool TRANS>
cudaError_t launch_slab(const void* in, const void* w, const float* mask,
                        void* out, int C, int M, int K, int H, int hd,
                        cudaStream_t s) {
  if (C == 0 || M == 0) return cudaSuccess;
  const size_t smem = smem_bytes(kSlab, K, H * hd);
  cudaError_t err = allow_smem(head_slab_kernel<T, TRANS>, smem);
  if (err != cudaSuccess) return err;
  head_slab_kernel<T, TRANS><<<dim3((M + TM - 1) / TM, C), THREADS, smem, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(w), mask,
      static_cast<T*>(out), M, K, H, hd);
  return cudaGetLastError();
}

template <typename T, bool TRANS>
cudaError_t launch_sum(const void* in, const void* w, const float* mask,
                       void* out, int C, int M, int K, int H, int hd,
                       cudaStream_t s) {
  if (C == 0 || M == 0) return cudaSuccess;
  const size_t smem = smem_bytes(kSum, H * hd, K);
  cudaError_t err = allow_smem(head_sum_kernel<T, TRANS>, smem);
  if (err != cudaSuccess) return err;
  head_sum_kernel<T, TRANS><<<dim3((M + TM - 1) / TM, C), THREADS, smem, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(w), mask,
      static_cast<T*>(out), M, K, H, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const DwArgs& a, const float* mask, int C, int M, int H,
                      cudaStream_t s) {
  if (C == 0) return cudaSuccess;
  const size_t smem = smem_bytes(kDw, a.I, a.J);
  cudaError_t err = allow_smem(head_dw_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (a.I * a.J + SLAB_OUT - 1) / SLAB_OUT;
  head_dw_kernel<T><<<dim3(H, chunks, C), THREADS, smem, s>>>(a, mask, M, H);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers of row-major arrays of type `dtype`
// (mask: (C, H) fp32). M rows per client; `width` is the non-head width
// (din for the projection, d for the merge); N = H·hd. Each returns
// cudaGetLastError() after its one launch; none allocates or synchronises.
extern "C" long long masked_attn_smem_bytes(int body, int w1, int w2) {
  return (long long)smem_bytes(body, w1, w2);
}

// y (C, M, N) = x (C, M, din) · w (C, din, N), dropped heads' columns 0.
extern "C" int masked_head_proj_launch(const void* x, const void* w,
                                       const float* mask, void* y, int C, int M,
                                       int din, int H, int hd, int dtype,
                                       void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_slab<T, false>(x, w, mask, y, C, M, din, H, hd,
                                 static_cast<cudaStream_t>(stream));
  });
  return err;
}

// dx (C, M, din) = Σ_kept h gy[:, h] (C, M, N) · w[:, h]ᵀ, w (C, din, N).
extern "C" int masked_head_proj_dx_launch(const void* gy, const void* w,
                                          const float* mask, void* dx, int C,
                                          int M, int din, int H, int hd,
                                          int dtype, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_sum<T, true>(gy, w, mask, dx, C, M, din, H, hd,
                               static_cast<cudaStream_t>(stream));
  });
  return err;
}

// dw (C, din, N): dw[:, h] = Σ_tiles x_tᵀ · gy_t[:, h]; gy (C, M, N),
// x (C, M, din); dropped heads' columns 0.
extern "C" int masked_head_proj_dw_launch(const void* gy, const void* x,
                                          const float* mask, void* dw, int C,
                                          int M, int din, int H, int hd,
                                          int dtype, void* stream) {
  const int N = H * hd;
  DwArgs a{x, gy, dw, din, 0, N, hd, din, hd, N, hd, (long long)din * N};
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_dw<T>(a, mask, C, M, H, static_cast<cudaStream_t>(stream));
  });
  return err;
}

// y (C, M, d) = Σ_kept h a[:, h] (C, M, N) · w[h, :], w (C, N, d).
extern "C" int masked_head_merge_launch(const void* a, const void* w,
                                        const float* mask, void* y, int C,
                                        int M, int d, int H, int hd, int dtype,
                                        void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_sum<T, false>(a, w, mask, y, C, M, d, H, hd,
                                static_cast<cudaStream_t>(stream));
  });
  return err;
}

// da (C, M, N): da[:, h] = gy (C, M, d) · w[h, :]ᵀ, w (C, N, d); dropped
// heads' columns 0.
extern "C" int masked_head_merge_da_launch(const void* gy, const void* w,
                                           const float* mask, void* da, int C,
                                           int M, int d, int H, int hd,
                                           int dtype, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_slab<T, true>(gy, w, mask, da, C, M, d, H, hd,
                                static_cast<cudaStream_t>(stream));
  });
  return err;
}

// dw (C, N, d): dw[h, :] = Σ_tiles a_t[:, h]ᵀ · gy_t; gy (C, M, d),
// a (C, M, N); dropped heads' rows 0.
extern "C" int masked_head_merge_dw_launch(const void* gy, const void* a,
                                           const float* mask, void* dw, int C,
                                           int M, int d, int H, int hd,
                                           int dtype, void* stream) {
  const int N = H * hd;
  DwArgs args{a, gy, dw, N, hd, d, 0, hd, d, d, (long long)hd * d,
              (long long)N * d};
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_dw<T>(args, mask, C, M, H, static_cast<cudaStream_t>(stream));
  });
  return err;
}
