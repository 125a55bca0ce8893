// Flash attention, backward: dq, dk and dv of o = softmax(q k^T / sqrt(D)
// [causal]) v, from q, k, v, the forward's output o and row log-sum-exp
// lse, and the output's gradient do. All arithmetic in f32. This is the
// route for f32 inputs; f16 and bf16 inputs take the tensor-core kernel of
// flash_attention_bwd_tc.cu.
//
// flash_attention_pallas (src/repro/kernels/flash_attention.py:62) is
// forward only; the JAX model gets attention's gradient by autodiff of
// chunked_attention, recomputing each query block's scores in the backward
// (@jax.checkpoint, src/repro/models/layers.py:141). This kernel computes
// that gradient as ref.flash_attention_bwd_ref writes it out, with the
// scores S = q k^T / sqrt(D) masked as in the forward:
//   P = exp(S - lse)   dV = P^T dO   dP = dO V^T   Delta = rowsum(dO * O)
//   dS = P * (dP - Delta)   dQ = dS K / sqrt(D)   dK = dS^T Q / sqrt(D)
// dK and dV of a kv head sum the G = Hq / Hkv q heads that read it. P is
// rebuilt from lse, so nothing of the forward's scores is kept. The sums run
// in another order than the plain version's, so the result is not bitwise
// its.
//
// Deterministic: no atomics. Every output element has one owner that sums
// in a fixed order, so two calls give the same bits (the checkpoint drills
// and relaxed == strict compare training runs bit for bit). Three passes,
// each its own launch (the `pass` argument of the entry point):
//   0. delta: Delta for each (batch, q head, row), one warp per row, into
//      an f32 (B, Hq, Sq) scratch. Both later passes read it.
//   1. dk, dv: one block per (batch, kv head, 64-key tile) holds its K and
//      V tiles in shared memory and walks the G q heads and, in each, the
//      query tiles from the first that sees a key of the tile (causal) to
//      the last, in that order. For each query tile it recomputes P^T and
//      dS^T for the (key, query) tile pair and accumulates dK and dV in
//      registers.
//   2. dq: one block per (batch, q head, 64-row query tile), laid out as the
//      forward: it walks the key tiles up to the causal limit, recomputes P
//      and dS, and accumulates dQ in registers.
// So S and dP are computed twice: 7 products of 64 x 64 x D per tile pair
// where a dQ summed with atomics needs 5. That is the price of determinism
// without a reduction buffer. Masked pairs get P = 0 and dS = 0 exactly,
// so tiles wholly above the causal diagonal are skipped without changing
// any sum.
//
// Threads: groups of 16 lanes. In pass 1 group r owns key rows r, r + R,
// ... of the tile (R groups), lane c owns query columns c, c + 16, c + 32,
// c + 48 of the score tile and head columns c, c + 16, ... of dK and dV.
// Pass 2 mirrors it with query rows and key columns. D = 128 runs 256
// threads, so that dK and dV (2 x 64 x 128 f32) fit in registers at 64 a
// thread; D = 16 and 64 run 128. P^T and dS^T (P and dS in pass 2) go
// through shared memory between the products. Tiles are staged as f32 with
// rows padded by 4 floats (conflict-free 16-byte reads), as in the forward.
// Shared memory: 4 tiles of 64 x (D + 4) f32 and two 64 x 80 score tiles,
// 176,640 bytes at D = 128 (one block per SM), 111,104 at D = 64.
//
// Layout: q, o, do, dq (B, Sq, Hq, D) and k, v, dk, dv (B, Sk, Hkv, D), all
// contiguous f32; lse and Delta (B, Hq, Sq) f32. Query
// row i sits at position q_offset + i and key j at j, as in the forward;
// rows past Sq and keys past Sk are neither read nor written.
//
// Bound: operations. The five products the backward needs (P, dV, dP, dQ,
// dK) are 5/2 of the forward's, 43 GFLOP at full tinyllama-1.1b's training
// shape (B 4, S 1024, Hq 32, D 64, causal); that is 0.0435 ms at the bf16
// tensor-core rate and 0.64 ms at the f32 CUDA-core rate this first version
// multiplies at. Pass 1's blocks are uneven under a causal mask (key tile 0
// walks every query tile, the last one a single tile), and it does 7
// products, not 5. The 16-bit route (flash_attention_bwd_tc.cu) runs the
// products on tensor cores with a balanced dk/dv split.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"
#include "flash_bwd_delta.cuh"

namespace {

constexpr int kB = 64;          // rows per tile, queries and keys alike
constexpr int kLdP = kB + 16;   // row stride of the score tiles: the rows of
                                // neighbouring groups land 16 banks apart

template <int D>
constexpr int threads_for() { return D == 128 ? 256 : 128; }

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float))
         * (4 * kB * (D + 4) + 2 * kB * kLdP + 2 * kB);
}

// Rows r0 .. r0 + 63 of one head (row r at base + r * stride) into dst as
// f32, row stride D + 4; rows at or past n are zero.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t stride, int r0, int n,
                                          float* __restrict__ dst) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kB * kVecs; e += NT) {
    const int r = e / kVecs;
    const int c = (e - r * kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(base + static_cast<int64_t>(r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// out[i][j] = row (r + R i) of a . row (c + 16 j) of b, over D; a and b are
// tiles of row stride D + 4.
template <int D, int kRows>
__device__ __forceinline__ void tile_dots(const float* __restrict__ a,
                                          const float* __restrict__ b, int r,
                                          int c, float (&out)[kRows][4]) {
  constexpr int kLd = D + 4;
  constexpr int R = kB / kRows;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = load4(b + (c + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 av = load4(a + (r + R * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = dot4(av, bv[j], out[i][j]);
    }
  }
}

// acc[i][j] += sum_x w[r + R i][x] * m[x][c + 16 j] over the 64 columns of
// the score tile w (row stride kLdP) and the rows of m (row stride D + 4).
template <int D, int kRows>
__device__ __forceinline__ void tile_accumulate(const float* __restrict__ w,
                                                const float* __restrict__ m,
                                                int r, int c,
                                                float (&acc)[kRows][D / 16]) {
  constexpr int kLd = D + 4;
  constexpr int R = kB / kRows;
  constexpr int kDCols = D / 16;
#pragma unroll 2
  for (int x = 0; x < kB; x += 4) {
    float mv[4][kDCols];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < kDCols; ++j) mv[u][j] = m[(x + u) * kLd + c + 16 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 wv = load4(w + (r + R * i) * kLdP + x);
#pragma unroll
      for (int j = 0; j < kDCols; ++j) {
        acc[i][j] = fmaf(wv.x, mv[0][j], acc[i][j]);
        acc[i][j] = fmaf(wv.y, mv[1][j], acc[i][j]);
        acc[i][j] = fmaf(wv.z, mv[2][j], acc[i][j]);
        acc[i][j] = fmaf(wv.w, mv[3][j], acc[i][j]);
      }
    }
  }
}

// Pass 1: dk and dv of one (batch, kv head, 64-key tile).
template <typename T, int D, int NT>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
            int Hkv, int causal, int q_offset, float scale) {
  constexpr int kLd = D + 4;
  constexpr int R = NT / 16;               // row groups
  constexpr int kRows = kB / R;            // key rows per thread
  constexpr int kDCols = D / 16;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);   // kB x kLd
  float* sv = sk + kB * kLd;
  float* sq = sv + kB * kLd;
  float* sdo = sq + kB * kLd;
  float* sp = sdo + kB * kLd;              // P^T, [key][query], kB x kLdP
  float* sds = sp + kB * kLdP;             // dS^T
  float* sl = sds + kB * kLdP;             // lse of the tile's query rows
  float* sd = sl + kB;                     // Delta of the tile's query rows

  const int r = threadIdx.x >> 4;
  const int c = threadIdx.x & 15;
  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int64_t q_rs = static_cast<int64_t>(Hq) * D;     // row strides
  const int64_t k_rs = static_cast<int64_t>(Hkv) * D;
  const int64_t k_off = static_cast<int64_t>(b) * Sk * k_rs + hk * D;
  load_tile<T, D, NT>(k + k_off, k_rs, k0, Sk, sk);
  load_tile<T, D, NT>(v + k_off, k_rs, k0, Sk, sv);

  float dka[kRows][kDCols], dva[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) dka[i][j] = dva[i][j] = 0.f;

  // causal: query row i sees key k0 once q_offset + i >= k0
  const int t_begin = causal ? max(0, k0 - q_offset) / kB : 0;
  const int n_qt = (Sq + kB - 1) / kB;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t q_off = static_cast<int64_t>(b) * Sq * q_rs + h * D;
    const float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * Sq;
    const float* db = delta + (static_cast<int64_t>(b) * Hq + h) * Sq;
    for (int t = t_begin; t < n_qt; ++t) {
      const int q0 = t * kB;
      __syncthreads();               // the last tile's q, dO, P and dS are read
      load_tile<T, D, NT>(q + q_off, q_rs, q0, Sq, sq);
      load_tile<T, D, NT>(dout + q_off, q_rs, q0, Sq, sdo);
      for (int e = threadIdx.x; e < kB; e += NT) {
        const bool in = q0 + e < Sq;
        sl[e] = in ? lb[q0 + e] : 0.f;
        sd[e] = in ? db[q0 + e] : 0.f;
      }
      __syncthreads();

      // P^T for key rows r + R i and query columns c + 16 j
      float x[kRows][4];
      tile_dots<D, kRows>(sk, sq, r, c, x);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int key = k0 + r + R * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q0 + c + 16 * j;
          const bool live = key < Sk && qi < Sq && !(causal && q_offset + qi < key);
          sp[(r + R * i) * kLdP + c + 16 * j] =
              live ? expf(x[i][j] * scale - sl[c + 16 * j]) : 0.f;
        }
      }
      // dS^T = P^T * (dP^T - Delta), dP^T = V dO^T; each thread reads back
      // only the P^T entries it wrote
      tile_dots<D, kRows>(sv, sdo, r, c, x);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (r + R * i) * kLdP + c + 16 * j;
          sds[at] = sp[at] * (x[i][j] - sd[c + 16 * j]);
        }
      __syncthreads();

      tile_accumulate<D, kRows>(sp, sdo, r, c, dva);    // dV += P^T dO
      tile_accumulate<D, kRows>(sds, sq, r, c, dka);    // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + r + R * i;
    if (key >= Sk) continue;
    T* pk = dk + k_off + static_cast<int64_t>(key) * k_rs;
    T* pv = dv + k_off + static_cast<int64_t>(key) * k_rs;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      pk[c + 16 * j] = from_f32<T>(dka[i][j] * scale);
      pv[c + 16 * j] = from_f32<T>(dva[i][j]);
    }
  }
}

// Pass 2: dq of one (batch, q head, 64-row query tile).
template <typename T, int D, int NT>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
          int q_offset, float scale) {
  constexpr int kLd = D + 4;
  constexpr int R = NT / 16;
  constexpr int kRows = kB / R;            // query rows per thread
  constexpr int kDCols = D / 16;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // kB x kLd
  float* sdo = sq + kB * kLd;
  float* sk = sdo + kB * kLd;
  float* sv = sk + kB * kLd;
  float* sds = sv + kB * kLd;              // P, then dS: kB x kLdP

  const int r = threadIdx.x >> 4;
  const int c = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t q_rs = static_cast<int64_t>(Hq) * D;
  const int64_t k_rs = static_cast<int64_t>(Hkv) * D;
  const int64_t q_off = static_cast<int64_t>(b) * Sq * q_rs + h * D;
  const int64_t k_off = static_cast<int64_t>(b) * Sk * k_rs + hk * D;
  load_tile<T, D, NT>(q + q_off, q_rs, q0, Sq, sq);
  load_tile<T, D, NT>(dout + q_off, q_rs, q0, Sq, sdo);

  float lse_r[kRows], delta_r[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r + R * i;
    const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.f;
    delta_r[i] = row < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past the tile's last real row are masked for every row
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + min(q0 + kB, Sq));
  const int n_tiles = (k_end + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();                 // the last tile's k, v and dS are read
    load_tile<T, D, NT>(k + k_off, k_rs, k0, Sk, sk);
    load_tile<T, D, NT>(v + k_off, k_rs, k0, Sk, sv);
    __syncthreads();

    // P for query rows r + R i and key columns c + 16 j
    float x[kRows][4];
    tile_dots<D, kRows>(sq, sk, r, c, x);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r + R * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + c + 16 * j;
        const bool live = key < Sk && qi < Sq && !(causal && q_offset + qi < key);
        sds[(r + R * i) * kLdP + c + 16 * j] =
            live ? expf(x[i][j] * scale - lse_r[i]) : 0.f;
      }
    }
    // dS = P * (dP - Delta), dP = dO V^T, in place over P
    tile_dots<D, kRows>(sdo, sv, r, c, x);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (r + R * i) * kLdP + c + 16 * j;
        sds[at] = sds[at] * (x[i][j] - delta_r[i]);
      }
    __syncthreads();

    tile_accumulate<D, kRows>(sds, sk, r, c, acc);       // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r + R * i;
    if (row >= Sq) continue;
    T* out = dq + q_off + static_cast<int64_t>(row) * q_rs;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) out[c + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, causal, q_offset;
};

template <typename T, int D>
int launch(int pass, const Args& a, cudaStream_t stream) {
  constexpr int NT = threads_for<D>();
  constexpr int kSmem = smem_bytes<D>();
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (pass == 0) {
    const int rc = launch_delta<T, D>(a.o, a.dout, a.delta, a.B, a.Sq, a.Hq, stream);
    if (rc != 0) return rc;
  } else if (pass == 1) {
    // above 48 KB a block's dynamic shared memory must be allowed per kernel
    const cudaError_t attr = cudaFuncSetAttribute(
        dkdv_kernel<T, D, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((a.Sk + kB - 1) / kB, a.Hkv, a.B);
    dkdv_kernel<T, D, NT><<<grid, NT, kSmem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.q_offset,
        scale);
  } else if (pass == 2) {
    const cudaError_t attr = cudaFuncSetAttribute(
        dq_kernel<T, D, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((a.Sq + kB - 1) / kB, a.Hq, a.B);
    dq_kernel<T, D, NT><<<grid, NT, kSmem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk,
        a.Hq, a.Hkv, a.causal, a.q_offset, scale);
  } else {
    return -4;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int pass, int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(pass, a, s);
    case 64: return launch<T, 64>(pass, a, s);
    case 128: return launch<T, 128>(pass, a, s);
    default: return -2;
  }
}

}  // namespace

// Runs pass `pass` (0: Delta, 1: dk and dv, 2: dq) of the backward; the
// three must run in that order on one stream. q, o, do, dq: (B, Sq, Hq, D);
// k, v, dk, dv: (B, Sk, Hkv, D); all contiguous f32 (`dtype` 0). lse:
// the forward's (B, Hq, Sq) f32 log-sum-exp; delta: (B, Hq, Sq) f32
// scratch, written by pass 0 and read by 1 and 2. Returns 0 on success,
// else the CUDA error code of the launch, -1 for a type other than f32, -2
// for an unsupported D, -3 for too many rows, -4 for an unknown pass.
extern "C" int flash_attention_bwd_launch(
    int pass, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    int causal, int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, Hq, Hkv,
               causal, q_offset};
  if (dtype != 0) return -1;   // f16 and bf16: flash_attention_bwd_tc.cu
  return dispatch_dim<float>(pass, D, a, s);
}
