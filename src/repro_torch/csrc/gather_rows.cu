// Row gather: out[i] = table[idx[i]], bit for bit.
//
// Replaces gather_rows_pallas (src/repro/kernels/embedding_bag.py:73). The
// Pallas kernel walks a sequential grid, one row per step, with the row
// chosen by a scalar-prefetched index; each step copies one (1, D) block.
//
// The kernel copies bytes, not values: it takes any element type, and the
// result equals index_select bitwise. It moves each row in chunks of 16,
// 8, 4, 2 or 1 bytes, as the wrapper picks (gather_rows.chunk_bytes); the
// C entry only refuses a chunk that the row or a base does not hold whole.
//
// Bound: bytes. Each output row reads one index and one table row and
// writes one row; there is no arithmetic. The rows are read at random, so
// the rate is set by the bytes in flight: rm1's checkpoint reads 91,583
// rows of 64 bytes, an LM's prefill 4,096 rows of 4 KB (1,539 distinct,
// the zipf duplicates hitting in L2), a decode step 4 rows.
//
// Design: the unit of work is a warp's. A row of 32 chunks or more is cut
// into a power of two of segments, as few as keep about 16 warps an SM
// busy, each of at most 256 chunks: a prefill's 4 KB row is one segment,
// a decode step's four rows are eight segments each, so they spread over
// 32 SMs. A row of fewer chunks goes to a group of lanes (a 64-byte rm1
// row to 4), and a warp takes a granule of 32 consecutive slots. Either way a
// warp reads each of its indices once (one load for a segment; one
// coalesced load for a granule, handed to the lanes through shared memory,
// which measured faster than shuffles), and each lane issues up to eight
// loads before any store: 128 bytes in flight with 16-byte chunks. No
// block barrier: warps run free of each other, so reads and writes
// overlap across the card. Units go to warps round-robin over the blocks
// first (unit u to warp u / G of block u % G, then the next G * 8), so a
// small call spreads over the SMs, and the grid is persistent: at most the
// blocks that fit on the card at once. Row and chunk come from shifts.
// Indices are read without allocating in L1; table rows go through the
// caches, where a prefill's duplicates hit; the output is stored with the
// default policy, since the next kernel reads it (the first layer's norm,
// the checkpoint's widening copy).
//
// idx must hold values in [0, num_rows): the kernel does not check them, as
// the Pallas kernel does not (the caller passes ids it built itself).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;            // chunks a lane loads before it stores
constexpr int kWarpsPerSm = 16;       // what the segments aim to keep busy

struct Plan {
  int cpr;          // chunks a row
  int shift;        // segments: log2(segments a row); else log2(lanes a row)
  int seg;          // segments: chunks a segment
  int64_t units;
};

// an index, read once: no room taken in L1
__device__ __forceinline__ int ld_once(const int32_t* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Two kernels, one for each kind of unit (kSegments: row segments; else
// lane groups over granules), so that neither pays for the other's
// registers (one kernel holding both took 138 and fit one block an SM).
template <typename V, bool kSegments>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ table, const int32_t* __restrict__ idx,
              V* __restrict__ out, int n, Plan p) {
  __shared__ int granule_rows[kSegments ? 1 : kWarps][32];   // a warp's indices
  int* rows = granule_rows[kSegments ? 0 : threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t u = static_cast<int64_t>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       u < p.units; u += stride) {
    if constexpr (kSegments) {   // a segment of one row
      const int slot = static_cast<int>(u >> p.shift);
      const int first = static_cast<int>(u & ((1 << p.shift) - 1)) * p.seg;
      const int end = min(first + p.seg, p.cpr);
      const V* src = table + static_cast<int64_t>(ld_once(idx + slot)) * p.cpr;
      V* dst = out + static_cast<int64_t>(slot) * p.cpr;
      for (int c0 = first + lane; c0 < end; c0 += 32 * kUnroll) {
        V v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {   // every load before any store
          if (c0 + 32 * k < end) v[k] = __ldg(src + c0 + 32 * k);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (c0 + 32 * k < end) dst[c0 + 32 * k] = v[k];
        }
      }
    } else {        // the rows of 32 slots, 2^shift >= cpr lanes a row
      const int64_t base = u * 32;
      const int count = static_cast<int>(min(static_cast<int64_t>(32), n - base));
      if (lane < count) rows[lane] = ld_once(idx + base + lane);
      __syncwarp();
      const int groups = 32 >> p.shift, group = lane >> p.shift;
      const int c = lane & ((1 << p.shift) - 1);   // the lane's chunk of its rows
      const int most = (count + groups - 1) >> (5 - p.shift);   // rows a group
      for (int k0 = 0; k0 < most; k0 += kUnroll) {
        V v[kUnroll];
        V* dst[kUnroll];
        bool live[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {   // every load before any store
          const int i = group + (k0 + k) * groups;   // the granule's slot
          live[k] = i < count && c < p.cpr;
          if (live[k]) {
            v[k] = __ldg(table + static_cast<int64_t>(rows[i]) * p.cpr + c);
            dst[k] = out + (base + i) * p.cpr + c;
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (live[k]) *dst[k] = v[k];
        }
      }
      __syncwarp();   // rows[] is written again for the next granule
    }
  }
}

int pow2_at_least(int64_t v) {   // log2 of the least power of two >= v
  int s = 0;
  while ((int64_t{1} << s) < v) ++s;
  return s;
}

template <typename K>
int blocks_per_sm(K kernel) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return blocks > 0 ? blocks : 1;
}

template <typename V>
int launch(const void* table, const int32_t* idx, void* out, int n,
           int64_t row_bytes, cudaStream_t stream) {
  static const int per_sm_segments = blocks_per_sm(gather_kernel<V, true>);
  static const int per_sm_groups = blocks_per_sm(gather_kernel<V, false>);
  const int64_t cpr = row_bytes / static_cast<int64_t>(sizeof(V));
  if (cpr >= (int64_t{1} << 31)) return -2;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  sms = sms > 0 ? sms : 1;
  Plan p;
  p.cpr = static_cast<int>(cpr);
  const bool segments = cpr >= 32;
  if (segments) {
    // segments of 32 to 32 * kUnroll chunks, as many as keep the card busy
    int64_t want = (static_cast<int64_t>(n) * cpr + int64_t{sms} * kWarpsPerSm - 1)
                   / (int64_t{sms} * kWarpsPerSm);
    want = want < 32 ? 32 : (want > 32 * kUnroll ? 32 * kUnroll : want);
    p.shift = pow2_at_least((cpr + want - 1) / want);
    p.seg = static_cast<int>((cpr + (int64_t{1} << p.shift) - 1) >> p.shift);
    p.units = static_cast<int64_t>(n) << p.shift;
  } else {
    p.shift = pow2_at_least(cpr);
    p.seg = 0;
    p.units = (static_cast<int64_t>(n) + 31) / 32;
  }
  const int64_t most = int64_t{sms} * (segments ? per_sm_segments : per_sm_groups);
  const int grid = static_cast<int>(p.units < most ? p.units : most);
  auto kernel = segments ? gather_kernel<V, true> : gather_kernel<V, false>;
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const V*>(table), idx,
                                        static_cast<V*>(out), n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chunk: bytes a thread moves at once (16, 8, 4, 2 or 1), picked by the
// wrapper. Returns 0 on success, else the CUDA error code of the launch, or
// -2 for a chunk that the row or a base does not allow.
extern "C" int gather_rows_launch(const void* table, const int32_t* idx,
                                  void* out, int n, int64_t row_bytes, int chunk,
                                  void* stream) {
  if (n == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t align = reinterpret_cast<uintptr_t>(table)
                         | reinterpret_cast<uintptr_t>(out)
                         | static_cast<uint64_t>(row_bytes);
  if (chunk <= 0 || align % static_cast<uint64_t>(chunk) != 0) return -2;
  switch (chunk) {
    case 16: return launch<uint4>(table, idx, out, n, row_bytes, s);
    case 8: return launch<uint2>(table, idx, out, n, row_bytes, s);
    case 4: return launch<uint32_t>(table, idx, out, n, row_bytes, s);
    case 2: return launch<uint16_t>(table, idx, out, n, row_bytes, s);
    case 1: return launch<uint8_t>(table, idx, out, n, row_bytes, s);
    default: return -2;
  }
}
