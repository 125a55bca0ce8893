// The flash backward's first pass, shared by its f32 route
// (flash_attention_bwd.cu) and its f16/bf16 route (flash_attention_bwd_tc.cu).
#pragma once

#include <cstdint>

#include "dtypes.cuh"

// In an anonymous namespace, as the kernels of each source are, so that
// profiles name it as they name them.
namespace {

// delta[b, h, i] = sum_d do[b, i, h, d] * o[b, i, h, d] in f32, one warp per
// (b, i, h) row, lanes over d, a fixed shuffle tree; o and do are
// contiguous (B, Sq, Hq, D), delta is (B, Hq, Sq).
template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows, int Sq, int Hq) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                 // whole warps leave together
  const T* po = o + row * D;
  const T* pd = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(pd[d]), to_f32(po[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const int64_t bi = row / Hq;           // b * Sq + i
    const int64_t b = bi / Sq;
    const int i = static_cast<int>(bi - b * Sq);
    delta[(b * Hq + h) * Sq + i] = s;
  }
}

// Launches delta_kernel over all B * Sq * Hq rows; returns -3 if the grid
// would be too large, else 0 (the caller checks the launch).
template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int B, int Sq,
                 int Hq, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  const int64_t blocks = (rows * 32 + 255) / 256;
  if (blocks > 0x7fffffff) return -3;
  delta_kernel<T, D><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq, Hq);
  return 0;
}

}  // namespace
