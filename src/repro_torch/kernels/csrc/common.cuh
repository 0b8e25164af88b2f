// Shared helpers for the repro_torch CUDA kernels: element types, 16-byte
// vector loads, conversions. Every kernel computes in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes passed from Python (kernels/_build.py DTYPE_CODE)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// Load 16 bytes at p (must be 16-byte aligned) as fp32 values.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&out)[Vec<T>::N]) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

// Dispatch a templated launcher on the dtype code.
#define RT_DISPATCH(dtype, T, ...)                                   \
  switch (dtype) {                                                   \
    case rt::kF32: { using T = float; __VA_ARGS__; break; }          \
    case rt::kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    default: return cudaErrorInvalidValue;                           \
  }

}  // namespace rt
