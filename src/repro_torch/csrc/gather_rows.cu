// Row gather: out[i] = table[idx[i]], bit for bit.
//
// Replaces gather_rows_pallas (src/repro/kernels/embedding_bag.py:73). The
// Pallas kernel walks a sequential grid, one row per step, with the row
// chosen by a scalar-prefetched index; each step copies one (1, D) block.
// Here the copy is flattened: thread g of the grid moves the g-th 16-byte
// chunk of the output, chunk v of row i = g / chunks_per_row, read from
// row idx[i] of the table. A 64-byte row (bf16 x 32, the DLRM tables) is 4
// chunks, so one warp moves 8 rows with 16-byte loads and stores, and
// neighbouring lanes touch neighbouring addresses within each row.
//
// The kernel copies bytes, not values: it takes any element type, and the
// result equals index_select bitwise. The chunk width is the largest of 16,
// 8, 4, 2 and 1 bytes that divides the row and both base addresses.
//
// Bound: bytes. Each output row reads one index and one table row and
// writes one row; there is no arithmetic. The rows are read at random, so
// the rate is set by how many row reads are in flight: one per thread,
// hundreds of thousands in the DLRM call.
//
// idx must hold values in [0, num_rows): the kernel does not check them, as
// the Pallas kernel does not (the caller passes ids it built itself).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ table, const int32_t* __restrict__ idx,
              V* __restrict__ out, int64_t total, int64_t chunks_per_row) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < total; g += stride) {
    const int64_t i = g / chunks_per_row;
    const int64_t v = g - i * chunks_per_row;
    out[g] = table[static_cast<int64_t>(idx[i]) * chunks_per_row + v];
  }
}

template <typename V>
int launch(const void* table, const int32_t* idx, void* out, int64_t n,
           int64_t row_bytes, cudaStream_t stream) {
  const int64_t chunks_per_row = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t total = n * chunks_per_row;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;   // grid-stride covers the rest
  gather_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), total,
      chunks_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, else the CUDA error code of the launch.
extern "C" int gather_rows_launch(const void* table, const int32_t* idx,
                                  void* out, int64_t n, int64_t row_bytes,
                                  void* stream) {
  if (n == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t align = reinterpret_cast<uintptr_t>(table)
                         | reinterpret_cast<uintptr_t>(out)
                         | static_cast<uint64_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(table, idx, out, n, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(table, idx, out, n, row_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(table, idx, out, n, row_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(table, idx, out, n, row_bytes, s);
  return launch<uint8_t>(table, idx, out, n, row_bytes, s);
}
