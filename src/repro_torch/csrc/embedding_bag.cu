// Embedding bag: out[b] = sum over items i of bag b of table[idx[i]], in f32.
//
// Replaces embedding_bag_pallas (src/repro/kernels/embedding_bag.py:40). The
// Pallas kernel walks a sequential grid, one item per step, and carries each
// bag's sum in a VMEM output block, with a zeroing prologue for empty bags.
// Blocks on Hopper run in parallel and in no order, so a bag here has one
// owner: one warp per bag, lanes strided over D, each lane summing its
// column in f32 in item order. No atomics, so the result is the same on
// every run, and every bag (an empty one too) is written, so the output
// needs no zeroing pass.
//
// Bound: bytes. Each item reads one row (D elements) and one index; the
// work is a few adds per byte, far below the card's operations per byte.
// Rows are gathered at random, so the rate is set by how many row reads
// are in flight; the inner loop is unrolled to keep several of them going.
//
// Bags are given as CSR offsets (num_bags + 1 of them); the wrapper derives
// them from the non-decreasing segment ids the callers build.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
           const int32_t* __restrict__ offsets, float* __restrict__ out,
           int num_bags, int dim) {
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bag >= num_bags) return;
  const int begin = offsets[bag];
  const int end = offsets[bag + 1];
  for (int d = lane; d < dim; d += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int j = begin; j < end; ++j) {
      acc += to_f32(table[static_cast<int64_t>(idx[j]) * dim + d]);
    }
    out[static_cast<int64_t>(bag) * dim + d] = acc;
  }
}

template <typename T>
int launch(const void* table, const int32_t* idx, const int32_t* offsets,
           float* out, int num_bags, int dim, cudaStream_t stream) {
  const int blocks = (num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bag_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(table), idx, offsets, out, num_bags, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, else the CUDA error code of the launch (or -1 for
// an unknown type code).
extern "C" int embedding_bag_launch(const void* table, int dtype,
                                    const int32_t* idx, const int32_t* offsets,
                                    float* out, int num_bags, int dim,
                                    void* stream) {
  if (num_bags == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(table, idx, offsets, out, num_bags, dim, s);
    case 1: return launch<__half>(table, idx, offsets, out, num_bags, dim, s);
    case 2: return launch<__nv_bfloat16>(table, idx, offsets, out, num_bags, dim, s);
    default: return -1;
  }
}
