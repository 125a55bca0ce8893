// Embedding bag: out[b] = sum over items i of bag b of table[idx[i]], in f32.
//
// Replaces embedding_bag_pallas (src/repro/kernels/embedding_bag.py:40). The
// Pallas kernel walks a sequential grid, one item per step, and carries each
// bag's sum in a VMEM output block, with a zeroing prologue for empty bags.
// Blocks on Hopper run in parallel and in no order, so every output element
// here has one owner that sums in a fixed order: no atomics, and two calls
// give the same bits (the checkpoint drills and relaxed == strict compare
// runs bit for bit).
//
// Bound: bytes. Each item reads one row (D elements), its index and its bag
// id; the work is one add per element read, far below the card's operations
// per byte. Rows are gathered at random, so the rate is set by how many row
// reads are in flight and on how many SMs.
//
// Layout, for a row of D elements:
//  * A thread owns VEC adjacent columns, read with one 16-byte load: 4 f32
//    or 8 f16/bf16. Where that leaves fewer than 32,768 threads (few bags
//    of narrow rows: dlrm-rm1's forward bag and its correction) it reads
//    two elements, for 2 (f32) or 4 (f16/bf16) times the row reads in
//    flight; where D is odd, or the table is misaligned, one. A group of
//    TPR threads, the next power of two above D / VEC but at most a block,
//    spans the row; a block of NT threads holds NT / TPR groups. At d 2,048
//    bf16 a group is a whole block of 256 threads; at d 32 bf16 it is 16
//    threads and a block serves many bags. Columns are independent, so each
//    column's sum runs in item order.
//  * Each thread starts the loads of kUnroll items before it adds them, in
//    item order, so several row reads are in flight per thread.
//  * A bag of at most kWhole items is summed by one group in item order:
//    the order, and so the bits, of the one-warp-per-bag kernel this
//    replaces. kWhole = 80 keeps dlrm-rm1's 80-item lookup bags (its 80
//    lookups per table and sample) whole, so the DLRM forward and its
//    relaxed correction keep their bits.
//  * A longer bag (zipf token streams put hundreds of items in the hottest
//    token's bag: 476 of 4,096 at the LM step) is cut into runs of kRun = 32
//    items from its first item. Each run is summed in item order into an f32
//    scratch row by its own block, and a second pass adds the runs in run
//    order. The order depends only on the bag's item count. One group
//    walking 476 items left the card idle (4.1 ms at the LM step, 31x
//    F.embedding_bag); in runs of 32 the hot bag is 15 chains of four
//    rounds of loads.
//
// Runs are found by item windows of kRun items: window w holds items
// [w kRun, (w + 1) kRun). A long bag's run starts lie kRun apart, so a
// window holds at most one run start of the bag that covers its first item
// (slot 0) and one of a long bag that starts inside it (slot 1; a long bag
// outlasts the window, so two cannot start in one). Run j of a long bag
// starting in window w starts in window w + j, in slot 0 except for j = 0
// when the bag starts after the window's first item.
//
// Pass 0 (one launch): blocks [0, n_bag_blocks) take one bag per group: the
// group finds the bag's first and last item by binary search over the
// non-decreasing bag ids `seg` (so no offsets array is built; one warp a
// search, 32 probes a round, where the block has a warp for each), writes the
// sum of a short bag (+0 for an empty one) and leaves a long bag alone.
// Blocks past them take one item window each: they sum the window's runs of
// long bags into scratch rows 2w and 2w + 1 and record the long bag that
// starts in the window, if any, in desc[w] = (bag, first item, item count).
// Pass 1 (one launch, a block per 8 windows): each window with a long bag
// adds that bag's runs in run order and writes its row.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kWhole = 80;
constexpr int kRun = 32;
constexpr int kUnroll = 8;
constexpr int kMaxThreads = 256;
constexpr int kFinishWindows = 8;   // windows a block of pass 1 looks at
constexpr int64_t kMinThreads = 32768;

// VEC elements of a row, read with one load.
template <typename T, int VEC> struct Raw { T v; };
template <> struct Raw<float, 4> { float4 v; };
template <> struct Raw<__half, 8> { uint4 v; };
template <> struct Raw<__nv_bfloat16, 8> { uint4 v; };
template <> struct Raw<float, 2> { float2 v; };
template <> struct Raw<__half, 2> { uint32_t v; };
template <> struct Raw<__nv_bfloat16, 2> { uint32_t v; };

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p) {
  Raw<T, VEC> r;
  r.v = *reinterpret_cast<const decltype(r.v)*>(p);
  return r;
}

template <typename T>
__device__ __forceinline__ void add(float (&acc)[1], const Raw<T, 1>& r) {
  acc[0] += to_f32(r.v);
}

__device__ __forceinline__ void add(float (&acc)[4], const Raw<float, 4>& r) {
  acc[0] += r.v.x;
  acc[1] += r.v.y;
  acc[2] += r.v.z;
  acc[3] += r.v.w;
}

template <typename H2>
__device__ __forceinline__ float2 widen2(uint32_t u);
template <>
__device__ __forceinline__ float2 widen2<__half2>(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
template <>
__device__ __forceinline__ float2 widen2<__nv_bfloat162>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

template <typename H2>
__device__ __forceinline__ void add8(float (&acc)[8], const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = widen2<H2>(w[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

template <typename H2>
__device__ __forceinline__ void add2(float (&acc)[2], uint32_t u) {
  const float2 f = widen2<H2>(u);
  acc[0] += f.x;
  acc[1] += f.y;
}

__device__ __forceinline__ void add(float (&acc)[2], const Raw<float, 2>& r) {
  acc[0] += r.v.x;
  acc[1] += r.v.y;
}

__device__ __forceinline__ void add(float (&acc)[2], const Raw<__half, 2>& r) {
  add2<__half2>(acc, r.v);
}

__device__ __forceinline__ void add(float (&acc)[2], const Raw<__nv_bfloat16, 2>& r) {
  add2<__nv_bfloat162>(acc, r.v);
}

__device__ __forceinline__ void add(float (&acc)[8], const Raw<__half, 8>& r) {
  add8<__half2>(acc, r.v);
}

__device__ __forceinline__ void add(float (&acc)[8], const Raw<__nv_bfloat16, 8>& r) {
  add8<__nv_bfloat162>(acc, r.v);
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&acc)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = acc[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
}

// First i in [0, n) with seg[i] >= v, else n.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ seg,
                                           int n, int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same by one whole warp: 32 probes split the range into 33 parts a
// round, so a search takes log33(n) + 1 dependent loads where a thread alone
// takes log2(n). Every lane returns the answer.
__device__ __forceinline__ int lower_bound_warp(const int32_t* __restrict__ seg,
                                                int n, int64_t v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {
    // probes at non-decreasing positions in [lo, hi): the lanes that see an
    // id below v are a prefix
    const int q = lo + static_cast<int>(static_cast<int64_t>(hi - lo) * (lane + 1) / 33);
    const unsigned below = __ballot_sync(0xffffffffu, seg[q] < v);
    const int c = __popc(below);
    const int q_last = __shfl_sync(0xffffffffu, q, max(c - 1, 0));
    const int q_next = __shfl_sync(0xffffffffu, q, min(c, 31));
    if (c > 0) lo = q_last + 1;
    if (c < 32) hi = q_next;
  }
  return lo;
}

// bounds[t] = lower_bound(seg, n, value(t)) for t = 0 .. count - 1: one warp
// a search where the block has enough warps, else one thread each
template <typename Value>
__device__ __forceinline__ void find_bounds(const int32_t* __restrict__ seg, int n,
                                            int count, Value value, int* bounds) {
  const int warps = blockDim.x >> 5;
  if (count <= warps) {
    const int wp = threadIdx.x >> 5;
    if (wp < count) {
      const int r = lower_bound_warp(seg, n, value(wp));
      if ((threadIdx.x & 31) == 0) bounds[wp] = r;
    }
  } else {
    for (int t = threadIdx.x; t < count; t += blockDim.x)
      bounds[t] = lower_bound(seg, n, value(t));
  }
}

// dst[0 .. dim) = sum of the rows idx[lo .. hi) in item order, by the group's
// `tpr` threads (this one is `lane`), VEC columns a thread at a time.
template <typename T, int VEC>
__device__ __forceinline__ void sum_items(const T* __restrict__ table,
                                          const int32_t* __restrict__ idx,
                                          int lo, int hi, int dim, int lane,
                                          int tpr, float* __restrict__ dst) {
  const int nvec = dim / VEC;
  for (int c = lane; c < nvec; c += tpr) {
    const T* col = table + c * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    int j = lo;
    for (; j + kUnroll <= hi; j += kUnroll) {
      int64_t r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = idx[j + u];
      Raw<T, VEC> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = load_raw<T, VEC>(col + r[u] * dim);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(acc, x[u]);
    }
    for (; j < hi; ++j)
      add(acc, load_raw<T, VEC>(col + static_cast<int64_t>(idx[j]) * dim));
    store<VEC>(dst + c * VEC, acc);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
           const int32_t* __restrict__ seg, float* __restrict__ out,
           float* __restrict__ partial, int32_t* __restrict__ desc, int n,
           int num_bags, int dim, int tpr, int n_bag_blocks) {
  __shared__ int bounds[kMaxThreads + 1];
  const int groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr;
  const int lane = threadIdx.x - g * tpr;

  if (static_cast<int>(blockIdx.x) < n_bag_blocks) {
    // bags first .. first + groups - 1: their bounds in parallel
    const int64_t first = static_cast<int64_t>(blockIdx.x) * groups;
    find_bounds(seg, n, groups + 1, [&](int t) { return first + t; }, bounds);
    __syncthreads();
    const int64_t bag = first + g;
    const int lo = bounds[g], hi = bounds[g + 1];
    if (bag < num_bags && hi - lo <= kWhole)
      sum_items<T, VEC>(table, idx, lo, hi, dim, lane, tpr, out + bag * dim);
    return;
  }

  // an item window: the bag of its first item (a) and of its last (z)
  const int w = blockIdx.x - n_bag_blocks;
  const int w0 = w * kRun;
  const int w1 = min(w0 + kRun, n);
  const int a = seg[w0], z = seg[w1 - 1];
  find_bounds(seg, n, 4, [&](int t) { return static_cast<int64_t>(t < 2 ? a : z) + (t & 1); },
              bounds);
  __syncthreads();
  const int a_lo = bounds[0], a_hi = bounds[1], z_lo = bounds[2], z_hi = bounds[3];
  // slot 0: the run of bag a that starts in the window, if a is long
  int run_lo[2] = {-1, -1};
  if (a_hi - a_lo > kWhole) {
    const int p = a_lo + (w0 - a_lo + kRun - 1) / kRun * kRun;
    if (p < min(a_hi, w1)) run_lo[0] = p;
  }
  // slot 1: the first run of a long bag z that starts after w0
  const bool z_long = z_lo > w0 && z_hi - z_lo > kWhole;
  if (z_long) run_lo[1] = z_lo;
  for (int s = g; s < 2; s += groups) {
    if (run_lo[s] < 0) continue;
    const int hi = min(run_lo[s] + kRun, s == 0 ? a_hi : z_hi);
    sum_items<T, VEC>(table, idx, run_lo[s], hi, dim, lane, tpr,
                      partial + (2 * static_cast<int64_t>(w) + s) * dim);
  }
  if (threadIdx.x == 0) {
    int32_t* d = desc + 3 * static_cast<int64_t>(w);
    if (a_lo == w0 && a_hi - a_lo > kWhole) {
      d[0] = seg[w0]; d[1] = a_lo; d[2] = a_hi - a_lo;
    } else if (z_long) {
      d[0] = seg[z_lo]; d[1] = z_lo; d[2] = z_hi - z_lo;
    } else {
      d[0] = -1;
    }
  }
}

// Pass 1: a block looks at kFinishWindows windows, lists those where a long
// bag starts (in window order), and writes each such bag as the sum of its
// runs in run order, the loads of kUnroll runs started before their adds.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
finish_kernel(const float* __restrict__ partial, const int32_t* __restrict__ desc,
              float* __restrict__ out, int dim, int n_win) {
  __shared__ int list[kFinishWindows];
  __shared__ int total;
  if (threadIdx.x < 32) {
    const int w = blockIdx.x * kFinishWindows + threadIdx.x;
    const bool has = threadIdx.x < kFinishWindows && w < n_win
                     && desc[3 * static_cast<int64_t>(w)] >= 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, has);
    if (has) list[__popc(ballot & ((1u << threadIdx.x) - 1))] = w;
    if (threadIdx.x == 0) total = __popc(ballot);
  }
  __syncthreads();

  const int nvec = dim / VEC;
  for (int k = 0; k < total; ++k) {
    const int win = list[k];
    const int32_t* d = desc + 3 * static_cast<int64_t>(win);
    const int bag = d[0];
    const int first_slot = 2 * win + (d[1] > win * kRun);
    const int runs = (d[2] + kRun - 1) / kRun;
    // run j's partial row: slot first_slot for j = 0, else 2 (win + j)
    auto row = [&](int j) {
      return partial + static_cast<int64_t>(j == 0 ? first_slot : 2 * (win + j)) * dim;
    };
    for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      int j = 0;
      for (; j + kUnroll <= runs; j += kUnroll) {
        Raw<float, VEC> x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x[u] = load_raw<float, VEC>(row(j + u) + c * VEC);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add(acc, x[u]);
      }
      for (; j < runs; ++j) add(acc, load_raw<float, VEC>(row(j) + c * VEC));
      store<VEC>(out + static_cast<int64_t>(bag) * dim + c * VEC, acc);
    }
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T, int VEC>
int launch(int pass, const void* table, const int32_t* idx, const int32_t* seg,
           float* out, float* partial, int32_t* desc, int n, int num_bags,
           int dim, cudaStream_t stream) {
  const int n_win = (n + kRun - 1) / kRun;
  if (pass == 1) {
    if (n_win == 0) return 0;
    finish_kernel<(VEC >= 4 ? 4 : 1)><<<(n_win + kFinishWindows - 1) / kFinishWindows,
                                       kMaxThreads, 0, stream>>>(
        partial, desc, out, dim, n_win);
    return static_cast<int>(cudaGetLastError());
  }
  const int tpr = min(pow2_at_least(dim / VEC), kMaxThreads);
  // smaller blocks while there are too few to spread over the card's SMs
  // (dlrm-rm1's 2,560 bags of d 32 bf16 would fill 40 blocks of 256)
  int nt = kMaxThreads;
  auto bag_blocks = [&](int threads) {
    const int groups = threads / tpr;
    return (static_cast<int64_t>(num_bags) + groups - 1) / groups;
  };
  while (nt > tpr && nt > 32 && bag_blocks(nt) < 2 * 132) nt >>= 1;
  const int64_t blocks = bag_blocks(nt) + n_win;
  if (blocks > 0x7fffffff) return -3;
  bag_kernel<T, VEC><<<static_cast<unsigned>(blocks), nt, 0, stream>>>(
      static_cast<const T*>(table), idx, seg, out, partial, desc, n, num_bags,
      dim, tpr, static_cast<int>(bag_blocks(nt)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int pass, const void* table, const int32_t* idx, const int32_t* seg,
             float* out, float* partial, int32_t* desc, int n, int num_bags,
             int dim, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte loads, unless they leave fewer than kMinThreads threads, too few
  // row reads in flight (dlrm-rm1's 2,560 bags of d 32 bf16 would run on
  // 10,240 threads): then two elements a load, 4 or 2 times the threads
  const int64_t threads16 = static_cast<int64_t>(num_bags) * ((dim + kVec - 1) / kVec);
  const uintptr_t at = reinterpret_cast<uintptr_t>(table);
  if (dim % kVec == 0 && at % 16 == 0 && threads16 >= kMinThreads)
    return launch<T, kVec>(pass, table, idx, seg, out, partial, desc, n,
                           num_bags, dim, s);
  if (dim % 2 == 0 && at % (2 * sizeof(T)) == 0)
    return launch<T, 2>(pass, table, idx, seg, out, partial, desc, n, num_bags,
                        dim, s);
  return launch<T, 1>(pass, table, idx, seg, out, partial, desc, n, num_bags,
                      dim, s);
}

}  // namespace

// Runs pass `pass` (0: bags and runs, 1: long bags' runs summed) of the bag;
// the two must run in that order on one stream. idx, seg: (n,) int32, seg
// non-decreasing in [0, num_bags); out: (num_bags, dim) f32; partial:
// (2 ceil(n / 32), dim) f32 and desc: (ceil(n / 32), 3) int32 scratch.
// Returns 0 on success, else the
// CUDA error code of the launch, -1 for an unknown type code, -3 for a grid
// too large, -4 for an unknown pass.
extern "C" int embedding_bag_launch(int pass, const void* table, int dtype,
                                    const int32_t* idx, const int32_t* seg,
                                    float* out, float* partial, int32_t* desc,
                                    int n, int num_bags, int dim, void* stream) {
  if (num_bags == 0 || dim == 0) return 0;
  if (pass != 0 && pass != 1) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(pass, table, idx, seg, out, partial, desc, n,
                                   num_bags, dim, s);
    case 1: return dispatch<__half>(pass, table, idx, seg, out, partial, desc, n,
                                    num_bags, dim, s);
    case 2: return dispatch<__nv_bfloat16>(pass, table, idx, seg, out, partial,
                                           desc, n, num_bags, dim, s);
    default: return -1;
  }
}
