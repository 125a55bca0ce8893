// The layout the two sparse row updates share (scatter_update.cu and
// scatter_update_logged.cu): a persistent grid whose blocks own granules of
// slots block-cyclically, indices staged once a round with the pads
// dropped (or, for the logged update, listed apart) by warp ballot, and the
// staged rows flattened into chunks of V elements. Each kernel's header
// says why; this file holds the parts that are the same in both.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace row_update {

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

// A round's staged slots. With kPads, the pad slots follow the real ones
// in `slot` (their `row` is not written).
template <bool kPads>
struct Stage {
  int row[kTile];                            // the table row of each real slot
  int slot[kTile];                           // the slot itself
  int count[1 + kPads][kPerThread][kWarps];  // real (and pad) slots of each warp's load
};

struct Staged {
  int real;   // real slots staged, Stage::row/slot[0, real)
  int pads;   // pad slots after them, Stage::slot[real, real + pads) (0 without kPads)
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

// Stages this block's slots of the round; the counts are the same in
// every thread.
template <bool kPads>
__device__ __forceinline__ Staged stage(const int32_t* __restrict__ idx, int n,
                                        const Plan& p, int round, Stage<kPads>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per_round = 1 << (p.tshift - p.gshift);   // granules
  int row[kPerThread], slot[kPerThread];
  bool live[kPerThread];   // a slot of the call, real or pad
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {   // every load before any use
    const int at = threadIdx.x + j * kThreads;
    const int64_t granule = blockIdx.x
        + (round * per_round + (at >> p.gshift)) * gridDim.x;
    const int64_t sl = (granule << p.gshift) + (at & ((1 << p.gshift) - 1));
    row[j] = -1;
    slot[j] = 0;
    live[j] = at < (1 << p.tshift) && sl < n;
    if (live[j]) {
      slot[j] = static_cast<int>(sl);
      row[j] = ld_once(idx + sl);
    }
  }
  unsigned mask[kPerThread], pad_mask[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    mask[j] = __ballot_sync(0xffffffffu, row[j] >= 0);
    if constexpr (kPads) pad_mask[j] = __ballot_sync(0xffffffffu, live[j]) & ~mask[j];
    if (lane == 0) {
      s.count[0][j][warp] = __popc(mask[j]);
      if constexpr (kPads) s.count[kPads][j][warp] = __popc(pad_mask[j]);
    }
  }
  __syncthreads();
  int total = 0, pads = 0, before[kPerThread], pads_before[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) {
        before[j] = total;
        pads_before[j] = pads;
      }
      total += s.count[0][j][w];
      if constexpr (kPads) pads += s.count[kPads][j][w];
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
    if constexpr (kPads) {
      if ((pad_mask[j] >> lane) & 1u) {
        s.slot[total + pads_before[j] + __popc(pad_mask[j] & lower)] = slot[j];
      }
    }
  }
  __syncthreads();
  // The next round's first writes to Stage::row/slot come after its barrier
  // above, which every thread reaches only once done with this round's rows.
  return {total, pads};
}

// The row and chunk of flattened chunk g of the staged rows
__device__ __forceinline__ void split(int g, const Plan& p, int& r, int& c) {
  r = p.cpr_shift >= 0 ? g >> p.cpr_shift : g / p.cpr;
  c = g - r * p.cpr;
}

inline int log2_exact(int64_t v) {   // -1 unless a power of two
  if (v <= 0 || (v & (v - 1)) != 0) return -1;
  int s = 0;
  while ((int64_t{1} << s) < v) ++s;
  return s;
}

// The plan and the grid for n slots of rows of cpr chunks; the grid is at
// most what fits on the card at once (`per_sm` blocks of the kernel an SM).
inline Plan plan_for(int n, int cpr, int per_sm, int& grid) {
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

// Whether a chunk of `vec` elements of T divides the row and the bases of
// the table and of the f32 delta (up to 16 bytes a load) hold it whole
template <typename T>
bool chunk_fits(int vec, int dim, const void* table, const float* delta) {
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t d = reinterpret_cast<uintptr_t>(delta);
  const int delta_align = 4 * (vec < 4 ? vec : 4);
  return vec > 0 && vec * sizeof(T) <= 16 && dim % vec == 0 && t % (vec * sizeof(T)) == 0
      && d % delta_align == 0;
}

}  // namespace row_update
