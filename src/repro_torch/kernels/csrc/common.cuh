// Shared helpers for the port's kernels: f32 <-> storage type conversion.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp.astype
}

// dtype codes (kernels/_build.py DTYPE_*)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

}  // namespace repro
