// Sparse row update in place: table[idx[i]] = round(f32(table[idx[i]]) + delta[i]).
//
// Replaces scatter_update_pallas (src/repro/kernels/scatter_update.py:24).
// The Pallas kernel visits the unique rows one grid step at a time, and
// the caller pads its static-shape index list with row 0 and a zero delta,
// which is harmless when the steps run in order. Hopper runs blocks in
// parallel: a padded slot that read row 0 could write it back after the
// real update of row 0 and lose it. So pads carry index -1 and are skipped,
// and each real row has one owner (one warp per slot, lanes strided over D).
//
// The arithmetic is the trainer's, round(f32(t) + f32(u)) with round to
// nearest even (src/repro/core/relaxed.py:91), not the Pallas kernel's
// cast of delta to the table type before the add; the two agree for f32
// tables.
//
// Bound: bytes. A slot reads its index, its delta row (f32) and its table
// row, and writes the table row back: one add per element.
//
// idx must hold each real row at most once (the caller combines duplicates).

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
update_kernel(T* __restrict__ table, const int32_t* __restrict__ idx,
              const float* __restrict__ delta, int n, int dim) {
  const int slot = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n) return;
  const int row = idx[slot];
  if (row < 0) return;  // pad slot
  T* dst = table + static_cast<int64_t>(row) * dim;
  const float* src = delta + static_cast<int64_t>(slot) * dim;
  for (int d = lane; d < dim; d += 32) {
    dst[d] = from_f32<T>(to_f32(dst[d]) + src[d]);
  }
}

template <typename T>
int launch(void* table, const int32_t* idx, const float* delta, int n,
           int dim, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  update_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<T*>(table), idx, delta, n, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, else the CUDA error code of the launch (or -1 for
// an unknown type code).
extern "C" int scatter_update_launch(void* table, int dtype, const int32_t* idx,
                                     const float* delta, int n, int dim,
                                     void* stream) {
  if (n == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(table, idx, delta, n, dim, s);
    case 1: return launch<__half>(table, idx, delta, n, dim, s);
    case 2: return launch<__nv_bfloat16>(table, idx, delta, n, dim, s);
    default: return -1;
  }
}
