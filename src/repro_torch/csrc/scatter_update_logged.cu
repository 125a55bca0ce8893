// Sparse row update in place with undo capture (paper Fig. 7): for each slot
// i, old[i] = table[idx[i]], then table[idx[i]] = round(f32(table[idx[i]]) +
// delta[i]).
//
// Replaces scatter_update_logged_pallas (src/repro/kernels/scatter_update.py:56).
// The Pallas kernel copies each row into the undo buffer, then adds, one grid
// step per slot; its caller pads the static-shape index list with row 0 and
// logs row 0's content in those slots. Hopper runs blocks in parallel, so as
// in scatter_update.cu pads carry index -1: their slot of the undo buffer is
// written +0 and the table is not touched. Each real row has one owner (one
// warp per slot, lanes strided over D), so there are no atomics and no race,
// and every element of `old` is written, so the wrapper's torch.empty needs
// no memset launch.
//
// The arithmetic is the trainer's and scatter_update.cu's, round(f32(t) +
// f32(u)) with round to nearest even, not the Pallas kernel's cast of delta
// to the table type before the add; the two agree for f32 tables. The undo
// image is the row's bits, copied before the add.
//
// Bound: bytes. A real slot reads its index, its delta row (f32) and its
// table row, and writes the table row and its undo image; a pad slot reads
// its index and writes a zero row. One add per element of a real row.
//
// idx must hold each real row at most once (the caller combines duplicates).

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
update_logged_kernel(T* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ delta, T* __restrict__ old,
                     int n, int dim) {
  const int slot = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n) return;
  const int row = idx[slot];
  T* undo = old + static_cast<int64_t>(slot) * dim;
  if (row < 0) {  // pad slot: a zero undo row, the table untouched
    const T zero = from_f32<T>(0.0f);
    for (int d = lane; d < dim; d += 32) undo[d] = zero;
    return;
  }
  T* dst = table + static_cast<int64_t>(row) * dim;
  const float* src = delta + static_cast<int64_t>(slot) * dim;
  // kUnroll elements per lane per pass, all their loads before any store:
  // the compiler does not move a load of the next element above the undo
  // store of this one, so one element at a time leaves a single round trip
  // to memory in flight per lane, which long rows (an LM's d 2,048) feel
  for (int d0 = lane; d0 < dim; d0 += 32 * kUnroll) {
    T v[kUnroll];
    float u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int d = d0 + 32 * k;
      if (d < dim) {
        v[k] = dst[d];
        u[k] = src[d];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int d = d0 + 32 * k;
      if (d < dim) {
        undo[d] = v[k];
        dst[d] = from_f32<T>(to_f32(v[k]) + u[k]);
      }
    }
  }
}

template <typename T>
int launch(void* table, const int32_t* idx, const float* delta, void* old,
           int n, int dim, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  update_logged_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<T*>(table), idx, delta, static_cast<T*>(old), n, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, else the CUDA error code of the launch (or -1 for
// an unknown type code).
extern "C" int scatter_update_logged_launch(void* table, int dtype,
                                            const int32_t* idx,
                                            const float* delta, void* old,
                                            int n, int dim, void* stream) {
  if (n == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(table, idx, delta, old, n, dim, s);
    case 1: return launch<__half>(table, idx, delta, old, n, dim, s);
    case 2: return launch<__nv_bfloat16>(table, idx, delta, old, n, dim, s);
    default: return -1;
  }
}
