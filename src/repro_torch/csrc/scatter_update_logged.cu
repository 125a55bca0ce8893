// Sparse row update in place with undo capture (paper Fig. 7): for each slot
// i, old[i] = table[idx[i]], then table[idx[i]] = round(f32(table[idx[i]]) +
// delta[i]).
//
// Replaces scatter_update_logged_pallas (src/repro/kernels/scatter_update.py:56).
// The Pallas kernel copies each row into the undo buffer, then adds, one grid
// step per slot; its caller pads the static-shape index list with row 0 and
// logs row 0's content in those slots. Hopper runs blocks in parallel, so as
// in scatter_update.cu pads carry index -1: their slot of the undo buffer is
// written +0 (all bits zero) and the table is not touched. Each chunk of a
// real row has one owner thread, so there are no atomics and no race, and
// every element of `old` is written, so the wrapper's torch.empty needs no
// memset launch.
//
// The arithmetic is the trainer's and scatter_update.cu's, round(f32(t) +
// f32(u)) with round to nearest even, not the Pallas kernel's cast of delta
// to the table type before the add; the two agree for f32 tables. The undo
// image is the row's bits: the loaded chunk itself is stored, before the
// add, never a value converted through f32 (which could alter a NaN).
//
// Bound: bytes. A real slot reads its index, its delta row (f32) and its
// table row, and writes the table row and its undo image; a pad slot reads
// its index and writes a zero row, which at an LM's 4,096 slots is 10.5 of
// the call's 42.0 MB. One add per element of a real row.
//
// Design: scatter_update.cu's layout, from row_update.cuh: a persistent
// grid whose blocks own slot granules block-cyclically, indices staged once
// a round, all loads before any use. The same warp ballot that lists the
// real slots lists the pads, by its complement, after them; both lists are
// flattened into chunks of V elements (16 bytes of the table where the row
// and the bases of the table, the delta and the undo buffer allow it, else
// fewer: the wrapper picks V, scatter_update.chunk_elems). A real chunk
// loads its table chunk and delta chunk, stores the table chunk unchanged
// into `old`, then the sum into the table; a pad chunk is one zero store
// into `old`. Neighbouring threads take neighbouring chunks, and each
// thread issues the loads of four chunks before any store. idx and delta
// are read once, without allocating in L1.
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
update_logged_kernel(T* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ delta, T* __restrict__ old,
                     int n, int dim, Plan plan) {
  using Chunk = typename Bits<V * sizeof(T)>::type;
  __shared__ Stage<true> s;
  for (int round = 0; has_round(n, plan, round); ++round) {
    const Staged st = stage(idx, n, plan, round, s);
    const int real = st.real * plan.cpr;               // chunks of the real rows
    const int work = real + st.pads * plan.cpr;        // then of the pads
    for (int base = threadIdx.x; base < work; base += kThreads * kUnroll) {
      Chunk t[kUnroll];
      Chunk* dst[kUnroll];
      Chunk* undo[kUnroll];
      float u[kUnroll][V];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {   // every load before any store
        const int g = base + k * kThreads;
        if (g < work) {
          int r, c;
          split(g, plan, r, c);
          const int64_t sl = s.slot[r];
          undo[k] = reinterpret_cast<Chunk*>(old + sl * dim) + c;
          if (g < real) {
            dst[k] = reinterpret_cast<Chunk*>(table + static_cast<int64_t>(s.row[r]) * dim) + c;
            t[k] = *dst[k];
            load_delta<V>(delta + sl * dim + c * V, u[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int g = base + k * kThreads;
        if (g < real) {
          *undo[k] = t[k];   // the row's bits, before the add
          T e[V];
          memcpy(e, &t[k], sizeof(Chunk));
#pragma unroll
          for (int v = 0; v < V; ++v) e[v] = from_f32<T>(to_f32(e[v]) + u[k][v]);
          memcpy(&t[k], e, sizeof(Chunk));
          *dst[k] = t[k];
        } else if (g < work) {
          *undo[k] = Chunk{};   // a pad: +0
        }
      }
    }
  }
}

template <typename T, int V>
int launch(void* table, const int32_t* idx, const float* delta, void* old,
           int n, int dim, cudaStream_t stream) {
  static const int per_sm = blocks_per_sm(update_logged_kernel<T, V>);
  int grid = 0;
  const Plan plan = plan_for(n, dim / V, per_sm, grid);
  update_logged_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(table), idx, delta, static_cast<T*>(old), n, dim, plan);
  return static_cast<int>(cudaGetLastError());
}

// V elements a chunk, for a table of element type T
template <typename T>
int launch_v(void* table, const int32_t* idx, const float* delta, void* old,
             int n, int dim, int vec, cudaStream_t s) {
  if (!chunk_fits<T>(vec, dim, table, delta)
      || reinterpret_cast<uintptr_t>(old) % (vec * sizeof(T)) != 0) {
    return -2;
  }
  if (vec == 1) return launch<T, 1>(table, idx, delta, old, n, dim, s);
  if (vec == 2) return launch<T, 2>(table, idx, delta, old, n, dim, s);
  if (vec == 4) return launch<T, 4>(table, idx, delta, old, n, dim, s);
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) return launch<T, 8>(table, idx, delta, old, n, dim, s);
  }
  return -2;
}

}  // namespace

// vec: elements a thread moves as one chunk (1, 2, 4, or 8 for 16-bit
// types), picked by the wrapper. Returns 0 on success, else the CUDA error
// code of the launch, -1 for an unknown type code, -2 for a chunk the row
// or a base (table, delta or old) does not allow.
extern "C" int scatter_update_logged_launch(void* table, int dtype,
                                            const int32_t* idx,
                                            const float* delta, void* old,
                                            int n, int dim, int vec, void* stream) {
  if (n == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_v<float>(table, idx, delta, old, n, dim, vec, s);
    case 1: return launch_v<__half>(table, idx, delta, old, n, dim, vec, s);
    case 2: return launch_v<__nv_bfloat16>(table, idx, delta, old, n, dim, vec, s);
    default: return -1;
  }
}
