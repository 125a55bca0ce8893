// Sparse row update in place: table[idx[i]] = round(f32(table[idx[i]]) + delta[i]).
//
// Replaces scatter_update_pallas (src/repro/kernels/scatter_update.py:24).
// The Pallas kernel visits the unique rows one grid step at a time, and
// the caller pads its static-shape index list with row 0 and a zero delta,
// which is harmless when the steps run in order. Hopper runs blocks in
// parallel: a padded slot that read row 0 could write it back after the
// real update of row 0 and lose it. So pads carry index -1 and are skipped,
// and each real row has one owner: one thread owns each chunk of it, and
// no two threads touch the same bytes, so there are no atomics.
//
// The arithmetic is the trainer's, round(f32(t) + f32(u)) with round to
// nearest even (src/repro/core/relaxed.py:91), not the Pallas kernel's
// cast of delta to the table type before the add; the two agree for f32
// tables.
//
// Bound: bytes. A slot reads its index; a real one also its delta row
// (f32) and its table row, and writes the table row back: one add per
// element. The table rows lie at random, so the rate is set by the bytes
// in flight, and the main paths' calls are small (1,539 rows of an LM's
// table, or 91,583 rows of 64 bytes at rm1).
//
// Design: a persistent grid (at most the blocks that fit on the card at
// once) whose blocks own granules of slots block-cyclically: block b of G
// takes granules b, b + G, b + 2G, ..., so the rows spread evenly over
// every SM wherever the pads lie (the callers put them last; an LM's 1,539
// rows among 4,096 slots reach all 132 SMs, where one warp a slot gave
// 11.7 working warps an SM). A granule is one slot for rows of 256 chunks
// or more and up to 32 slots for shorter rows, so that a warp reads 32
// consecutive indices in one load (rm1's 64-byte rows). A block stages up
// to 1,024 slots a round: it loads their indices once, all before any is
// used (this takes the place of the Pallas kernel's scalar prefetch), and
// drops the pads with a warp ballot and a prefix over the warps' counts,
// leaving the real slots and their rows in shared memory, so a pad costs
// one index read and no thread. The staged rows are flattened into chunks
// of V elements, 16 bytes of the table (8 bf16 or 4 f32) and the matching
// 32 or 16 bytes of delta where the row's bytes and both bases allow it,
// else fewer (the wrapper picks V, scatter_update.chunk_elems; the C
// entry only refuses a V that the row or a base does not hold whole);
// neighbouring threads take
// neighbouring chunks, and each thread issues the loads of four chunks
// before any store. idx and delta are read once, without allocating in
// L1; the table row is read and written back by the same thread with the
// default policy. The parts of this layout that scatter_update_logged.cu
// shares (the plan, the staging, the chunk types) are in row_update.cuh.
//
// idx must hold each real row at most once (the caller combines duplicates).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "dtypes.cuh"
#include "row_update.cuh"

namespace {

using namespace row_update;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
update_kernel(T* __restrict__ table, const int32_t* __restrict__ idx,
              const float* __restrict__ delta, int n, int dim, Plan plan) {
  using Chunk = typename Bits<V * sizeof(T)>::type;
  __shared__ Stage<false> s;
  for (int round = 0; has_round(n, plan, round); ++round) {
    const int work = stage(idx, n, plan, round, s).real * plan.cpr;
    for (int base = threadIdx.x; base < work; base += kThreads * kUnroll) {
      Chunk t[kUnroll];
      Chunk* dst[kUnroll];
      float u[kUnroll][V];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {   // every load before any store
        const int g = base + k * kThreads;
        if (g < work) {
          int r, c;
          split(g, plan, r, c);
          dst[k] = reinterpret_cast<Chunk*>(table + static_cast<int64_t>(s.row[r]) * dim) + c;
          t[k] = *dst[k];
          load_delta<V>(delta + static_cast<int64_t>(s.slot[r]) * dim + c * V, u[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (base + k * kThreads < work) {
          T e[V];
          memcpy(e, &t[k], sizeof(Chunk));
#pragma unroll
          for (int v = 0; v < V; ++v) e[v] = from_f32<T>(to_f32(e[v]) + u[k][v]);
          memcpy(&t[k], e, sizeof(Chunk));
          *dst[k] = t[k];
        }
      }
    }
  }
}

template <typename T, int V>
int launch(void* table, const int32_t* idx, const float* delta, int n, int dim,
           cudaStream_t stream) {
  static const int per_sm = blocks_per_sm(update_kernel<T, V>);
  int grid = 0;
  const Plan plan = plan_for(n, dim / V, per_sm, grid);
  update_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(table), idx, delta, n, dim, plan);
  return static_cast<int>(cudaGetLastError());
}

// V elements a chunk, for a table of element type T
template <typename T>
int launch_v(void* table, const int32_t* idx, const float* delta, int n, int dim,
             int vec, cudaStream_t s) {
  if (!chunk_fits<T>(vec, dim, table, delta)) return -2;
  if (vec == 1) return launch<T, 1>(table, idx, delta, n, dim, s);
  if (vec == 2) return launch<T, 2>(table, idx, delta, n, dim, s);
  if (vec == 4) return launch<T, 4>(table, idx, delta, n, dim, s);
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) return launch<T, 8>(table, idx, delta, n, dim, s);
  }
  return -2;
}

}  // namespace

// vec: elements a thread moves as one chunk (1, 2, 4, or 8 for 16-bit
// types), picked by the wrapper. Returns 0 on success, else the CUDA error
// code of the launch, -1 for an unknown type code, -2 for a chunk the row
// or a base does not allow.
extern "C" int scatter_update_launch(void* table, int dtype, const int32_t* idx,
                                     const float* delta, int n, int dim, int vec,
                                     void* stream) {
  if (n == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_v<float>(table, idx, delta, n, dim, vec, s);
    case 1: return launch_v<__half>(table, idx, delta, n, dim, vec, s);
    case 2: return launch_v<__nv_bfloat16>(table, idx, delta, n, dim, vec, s);
    default: return -1;
  }
}
