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
// default policy.
//
// idx must hold each real row at most once (the caller combines duplicates).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                    // slots staged a round, at most
constexpr int kPerThread = kTile / kThreads;   // index loads a thread, a round
constexpr int kUnroll = 4;                     // chunks in flight a thread

// The launch's layout, the same for every block.
struct Plan {
  int gshift;      // a granule is 2^gshift slots
  int tshift;      // a round stages 2^tshift slots (at least one granule)
  int cpr;         // chunks in a row
  int cpr_shift;   // log2(cpr) when cpr is a power of two, else -1
};

struct Stage {
  int row[kTile];                 // the table row of each staged slot
  int slot[kTile];                // the slot itself
  int count[kPerThread][kWarps];  // real slots of each warp's load
};

// An index, read once: no room taken in L1
__device__ __forceinline__ int ld_once(const int32_t* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ bool has_round(int n, const Plan& p, int round) {
  const int64_t granules = ((static_cast<int64_t>(n) - 1) >> p.gshift) + 1;
  const int64_t first = blockIdx.x + static_cast<int64_t>(round)
      * (1 << (p.tshift - p.gshift)) * gridDim.x;
  return first < granules;
}

// Stages this block's slots of the round; returns how many are real
// (the same in every thread). Stage::row/slot[0, count) hold them.
__device__ __forceinline__ int stage(const int32_t* __restrict__ idx, int n,
                                     const Plan& p, int round, Stage& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per_round = 1 << (p.tshift - p.gshift);   // granules
  int row[kPerThread], slot[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {   // every load before any use
    const int at = threadIdx.x + j * kThreads;
    const int64_t granule = blockIdx.x
        + (round * per_round + (at >> p.gshift)) * gridDim.x;
    const int64_t sl = (granule << p.gshift) + (at & ((1 << p.gshift) - 1));
    row[j] = -1;
    slot[j] = 0;
    if (at < (1 << p.tshift) && sl < n) {
      slot[j] = static_cast<int>(sl);
      row[j] = ld_once(idx + sl);
    }
  }
  unsigned mask[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    mask[j] = __ballot_sync(0xffffffffu, row[j] >= 0);
    if (lane == 0) s.count[j][warp] = __popc(mask[j]);
  }
  __syncthreads();
  int total = 0, before[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) before[j] = total;
      total += s.count[j][w];
    }
  }
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (row[j] >= 0) {
      const int at = before[j] + __popc(mask[j] & lower);
      s.row[at] = row[j];
      s.slot[at] = slot[j];
    }
  }
  __syncthreads();
  // The next round's first writes to Stage::row come after its barrier
  // above, which every thread reaches only once done with this round's rows.
  return total;
}

// The row and chunk of flattened chunk g of the staged rows
__device__ __forceinline__ void split(int g, const Plan& p, int& r, int& c) {
  r = p.cpr_shift >= 0 ? g >> p.cpr_shift : g / p.cpr;
  c = g - r * p.cpr;
}

int log2_exact(int64_t v) {   // -1 unless a power of two
  if (v <= 0 || (v & (v - 1)) != 0) return -1;
  int s = 0;
  while ((int64_t{1} << s) < v) ++s;
  return s;
}

// The plan and the grid for n slots of rows of cpr chunks; the grid is at
// most what fits on the card at once (`per_sm` blocks of the kernel an SM).
Plan plan_for(int n, int cpr, int per_sm, int& grid) {
  Plan p;
  p.cpr = cpr;
  p.cpr_shift = log2_exact(cpr);
  // a round's chunks stay below 2^31: at most kTile slots, fewer for rows
  // of over 2^21 chunks
  p.tshift = 10;
  while (p.tshift > 0 && (int64_t{cpr} << p.tshift) >= (int64_t{1} << 31)) --p.tshift;
  // a granule of about one pass of the block's threads, 1 to 32 slots
  p.gshift = 0;
  while (p.gshift < 5 && p.gshift < p.tshift
         && (int64_t{cpr} << (p.gshift + 1)) <= kThreads) {
    ++p.gshift;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t granules = ((static_cast<int64_t>(n) - 1) >> p.gshift) + 1;
  const int64_t most = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  grid = static_cast<int>(granules < most ? granules : most);
  return p;
}

// Blocks of `kernel` that fit on an SM, asked once per kernel
template <typename K>
int blocks_per_sm(K kernel) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return blocks;
}

template <int B> struct Bits;   // B bytes as one load
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<4> { using type = uint32_t; };
template <> struct Bits<2> { using type = uint16_t; };

// V floats of delta, read once
template <int V> __device__ __forceinline__ void load_delta(const float* p, float* u);

template <> __device__ __forceinline__ void load_delta<1>(const float* p, float* u) {
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(u[0]) : "l"(p));
}

template <> __device__ __forceinline__ void load_delta<2>(const float* p, float* u) {
  asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];"
      : "=f"(u[0]), "=f"(u[1]) : "l"(p));
}

template <> __device__ __forceinline__ void load_delta<4>(const float* p, float* u) {
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(u[0]), "=f"(u[1]), "=f"(u[2]), "=f"(u[3]) : "l"(p));
}

template <> __device__ __forceinline__ void load_delta<8>(const float* p, float* u) {
  load_delta<4>(p, u);
  load_delta<4>(p + 4, u + 4);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
update_kernel(T* __restrict__ table, const int32_t* __restrict__ idx,
              const float* __restrict__ delta, int n, int dim, Plan plan) {
  using Chunk = typename Bits<V * sizeof(T)>::type;
  __shared__ Stage s;
  for (int round = 0; has_round(n, plan, round); ++round) {
    const int work = stage(idx, n, plan, round, s) * plan.cpr;
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
  // refuse a chunk that does not divide the row or that a base does not
  // hold whole
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t d = reinterpret_cast<uintptr_t>(delta);
  const int delta_align = 4 * (vec < 4 ? vec : 4);
  if (vec * sizeof(T) > 16 || dim % vec != 0 || t % (vec * sizeof(T)) != 0
      || d % delta_align != 0) {
    return -2;
  }
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
