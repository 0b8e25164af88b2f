// Shared helpers for the repro_torch CUDA kernels: element types, 16-byte
// vector loads, conversions, activations and their derivatives. Every
// kernel computes in fp32.
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

// Activation codes passed from Python (kernels/masked_ffn.py _ACT_CODE).
enum Act : int { kRelu = 0, kRelu2 = 1, kGelu = 2, kSilu = 3 };

__device__ __forceinline__ float act_f(float z, int act) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.f);
    case kRelu2: { const float r = fmaxf(z, 0.f); return r * r; }
    case kGelu: {   // tanh form, as jax.nn.gelu
      const float c = 0.7978845608028654f;
      return 0.5f * z * (1.f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    default: return z / (1.f + expf(-z));   // silu
  }
}

// d act / dz, as repro/kernels/masked_ffn.py _DACTS (gelu: _dgelu, silu: _dsilu).
__device__ __forceinline__ float dact_f(float z, int act) {
  switch (act) {
    case kRelu: return z > 0.f ? 1.f : 0.f;
    case kRelu2: return 2.f * fmaxf(z, 0.f);
    case kGelu: {
      const float c = 0.7978845608028654f;
      const float t = tanhf(c * (z + 0.044715f * z * z * z));
      const float du = c * (1.f + 3.f * 0.044715f * z * z);
      return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
    }
    default: {
      const float s = 1.f / (1.f + expf(-z));
      return s * (1.f + z * (1.f - s));
    }
  }
}

// The error a launch entry returns, with the thread's last error cleared:
// a failed cudaFuncSetAttribute or cudaLaunchKernelEx leaves it set, and
// the library's next cudaGetLastError() would report it against a launch
// that did not fail.
inline cudaError_t cleared(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Dispatch a templated launcher on the dtype code.
#define RT_DISPATCH(dtype, T, ...)                                   \
  switch (dtype) {                                                   \
    case rt::kF32: { using T = float; __VA_ARGS__; break; }          \
    case rt::kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    default: return cudaErrorInvalidValue;                           \
  }

}  // namespace rt
