// AdamW's update of one leaf in place, for Hopper (sm_90a): params p (fp32
// or bf16), grads g (fp32 or bf16), moments m and v (fp32), every operand
// contiguous, n elements.
//
// It replaces no Pallas kernel: the JAX package's AdamW
// (repro/optim/optim.py) is plain jnp, which XLA fuses into one pass over
// the leaf. The port's eager PyTorch chain (kernels/adamw.py::adamw_plain)
// takes about 13 elementwise kernels a leaf, ~128 bytes of HBM traffic a
// parameter and a temporary the size of the leaf.
//
// What bounds it on an H100: bytes. Each parameter is read as p, g, m, v
// and written as p, m, v once, for ~20 flops: 28 B a parameter in fp32
// (8.7 ms per 10^9 parameters at 3.35 TB/s). The design answers with one
// pass and no temporaries: a grid-stride loop over groups of 4 elements,
// 16-byte loads and stores of each fp32 operand (8 bytes of a bf16 one)
// with the streaming (.cs) cache hint, since nothing is read twice; the
// last n % 4 elements one a thread. Enough blocks to fill every SM.
//
// Arithmetic: the chain's, operation for operation, each rounded as
// PyTorch's own kernel rounds it (explicit _rn intrinsics, so nvcc's FMA
// contraction cannot merge two of them):
//
//   m = m·b1 + g·c1                       c1 = (float)(1 - b1)
//   v = v·b2 + (g·g)·c2                   c2 = (float)(1 - b2)
//   s = (m / bc1) / (sqrt(v / bc2) + eps)
//   s = s + p·wd                          (only where weight decay is set)
//   p = p - s·lr                          bf16 p: s·lr rounded to bf16, the
//                                         difference in fp32, rounded to bf16
//
// b1, b2, c1, c2, eps, wd and lr arrive as the fp32 values PyTorch's scalar
// operands take ((float) of the double); bc1 and bc2 are the device scalars
// the optimizer computes, read here by pointer (no host sync).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Hyper {
  float b1, b2, c1, c2, eps, wd, lr;
  int has_wd;
};

// 4 elements of T from/to a 16-byte (fp32) or 8-byte (bf16) slot, streamed
template <typename T> struct Four;

template <> struct Four<float> {
  static __device__ __forceinline__ void load(const float* p, size_t i, float (&o)[4]) {
    const float4 r = __ldcs(reinterpret_cast<const float4*>(p) + i);
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, size_t i, const float (&o)[4]) {
    __stcs(reinterpret_cast<float4*>(p) + i, make_float4(o[0], o[1], o[2], o[3]));
  }
};

template <> struct Four<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, size_t i, float (&o)[4]) {
    const uint2 r = __ldcs(reinterpret_cast<const uint2*>(p) + i);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = __bfloat162float(e[k]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, const float (&o)[4]) {
    uint2 r;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __float2bfloat16_rn(o[k]);   // exact: o is a bf16 value
    __stcs(reinterpret_cast<uint2*>(p) + i, r);
  }
};

__device__ __forceinline__ float load1(const float* p, size_t i) { return __ldcs(p + i); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, size_t i, float x) { __stcs(p + i, x); }
__device__ __forceinline__ void store1(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// p - s, as p.sub_(s.to(p.dtype)) rounds it: fp32 at once; bf16 with s
// rounded to bf16 first and the difference taken in fp32, then rounded
template <typename P> __device__ __forceinline__ float sub_step(float p, float s);
template <> __device__ __forceinline__ float sub_step<float>(float p, float s) {
  return __fsub_rn(p, s);
}
template <> __device__ __forceinline__ float sub_step<__nv_bfloat16>(float p, float s) {
  const float sb = __bfloat162float(__float2bfloat16_rn(s));
  return __bfloat162float(__float2bfloat16_rn(__fsub_rn(p, sb)));
}

// one element: m, v updated in place, the new p returned (a P value, in fp32)
template <typename P>
__device__ __forceinline__ float update(float p, float g, float& m, float& v, const Hyper& h,
                                        float bc1, float bc2) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.c1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.c2));
  float s = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  if (h.has_wd) s = __fadd_rn(s, __fmul_rn(p, h.wd));
  return sub_step<P>(p, __fmul_rn(s, h.lr));
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS)
adamw_update_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                    float* __restrict__ v, const float* __restrict__ bc1p,
                    const float* __restrict__ bc2p, size_t n, Hyper h) {
  const float bc1 = __ldg(bc1p), bc2 = __ldg(bc2p);
  const size_t n4 = n / 4;
  const size_t first = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t i = first; i < n4; i += stride) {
    float pf[4], gf[4], mf[4], vf[4];
    Four<P>::load(p, i, pf);
    Four<G>::load(g, i, gf);
    Four<float>::load(m, i, mf);
    Four<float>::load(v, i, vf);
#pragma unroll
    for (int k = 0; k < 4; ++k) pf[k] = update<P>(pf[k], gf[k], mf[k], vf[k], h, bc1, bc2);
    Four<P>::store(p, i, pf);
    Four<float>::store(m, i, mf);
    Four<float>::store(v, i, vf);
  }
  const size_t j = 4 * n4 + first;       // the last n % 4 elements, one a thread
  if (j < n) {
    float mj = load1(m, j), vj = load1(v, j);
    const float pj = update<P>(load1(p, j), load1(g, j), mj, vj, h, bc1, bc2);
    store1(p, j, pj);
    store1(m, j, mj);
    store1(v, j, vj);
  }
}

template <typename P, typename G>
cudaError_t launch(void* p, const void* g, float* m, float* v, const float* bc1,
                   const float* bc2, long long n, const Hyper& h, int n_sm,
                   cudaStream_t stream) {
  static int per_sm = 0;                 // resident blocks an SM, asked once
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_update_kernel<P, G>, THREADS, 0);
    if (err != cudaSuccess) return rt::cleared(err);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const long long groups = (n / 4 > 0 ? n / 4 : 1);
  const long long want = (groups + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (long long)n_sm * per_sm ? want : (long long)n_sm * per_sm);
  adamw_update_kernel<P, G><<<blocks, THREADS, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, bc1, bc2, (size_t)n, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" int adamw_launch(void* p, const void* g, float* m, float* v, const float* bc1,
                            const float* bc2, long long n, int p_dtype, int g_dtype, float b1,
                            float b2, float c1, float c2, float eps, float wd, int has_wd,
                            float lr, int n_sm, void* stream) {
  const Hyper h{b1, b2, c1, c2, eps, wd, lr, has_wd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(p_dtype, P, RT_DISPATCH(g_dtype, G,
      return launch<P, G>(p, g, m, v, bc1, bc2, n, h, n_sm, s)))
  return cudaErrorInvalidValue;
}
