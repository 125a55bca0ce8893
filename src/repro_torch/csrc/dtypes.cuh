// Element types the embedding kernels take, and their f32 conversions.
// Type codes match repro_torch/kernels/_build.py: 0 = f32, 1 = f16, 2 = bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round to nearest even, as torch's Tensor.to(dtype) rounds.
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
