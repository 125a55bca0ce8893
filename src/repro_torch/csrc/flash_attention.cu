// Flash attention, forward: o = softmax(q k^T / sqrt(D) [causal]) v, with a
// streaming softmax over key tiles and all arithmetic in f32. This is the
// route for f32 inputs; f16 and bf16 inputs take flash_attention_tc.cu.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:62)
// and computes what its _flash_kernel computes: scores in f32 scaled by
// 1/sqrt(D); the causal mask q_pos >= k_pos from global positions, masked
// scores set to the -1e30 sentinel; running max m, sum l and accumulator acc
// in f32, rescaled by corr = exp(m_prev - m_new) at each key tile; P kept in
// f32 for P.V; the output acc / max(l, 1e-30), rounded once to q's type.
// The sums run in another order, so the result is not bitwise the plain
// version's.
//
// The Pallas kernel walks a sequential grid (head, q block, kv block) and
// carries m, l and acc from one kv step to the next in VMEM scratch. Blocks
// on Hopper run in parallel and in no order, so here one block owns one
// (batch, q head, 64-row q tile) and walks the key tiles in a loop, with m,
// l and acc in registers. What differs from the Pallas kernel, and why:
//   - Layout and strides. q is read in its (B, Sq, Hq, D) layout and k, v in
//     (B, Sk, Hkv, D) with the batch, sequence and head strides the caller
//     gives, so a prefix of a KV cache (not contiguous across the batch) is
//     read in place. The last axis must be contiguous. o is (B, Sq, Hq, D),
//     contiguous.
//   - GQA without repeat: q head h reads kv head h / (Hq / Hkv).
//   - Ragged lengths: rows past Sq are neither read nor written and keys
//     past Sk are masked, where the Pallas kernel asserts S % block == 0.
//   - Causal tiles entirely above the diagonal are skipped. This is exact:
//     every row's first tile holds key 0 <= q_pos, so m is a real score
//     after it, and a later fully masked tile gives p = exp(-1e30 - m) = 0
//     and corr = exp(m - m) = 1 in the Pallas kernel too, leaving l and acc
//     unchanged.
//   - The query tile holding the most work starts first (reversed tile
//     order), so the causal triangle's long rows do not end the grid.
//
// The log-sum-exp output. With a non-null lse pointer each row's m + log(l),
// the log-sum-exp of its scaled scores, is written in f32 to lse (B, Hq,
// Sq): the backward (flash_attention_bwd.cu) rebuilds P from it. Serving
// passes null, and its kernel does the same work as before.
//
// Bound: operations. A causal call does about 4 * B * Hq * D * S(S+1)/2
// flops and moves q, k, v and o once. It multiplies on the CUDA cores in
// f32, so its bound is the card's f32 rate outside the tensor cores.
//
// Threads: 128 per block, 8 groups of 16. Group g owns query rows g, g+8,
// ..., g+56 of the tile; lane c of a group owns key columns c, c+16, c+32,
// c+48 of the score tile and output columns c, c+16, ... of the head. A
// row's max and sum reduce across its group's 16 lanes with shuffles. The
// q, k and v tiles are staged in shared memory as f32 with rows padded by 4
// floats (conflict-free 16-byte reads), and P goes through shared memory
// between the two products.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = 8;        // query rows per thread
constexpr int kCols = 4;        // score columns per thread
constexpr int kLdP = kBK + 16;  // row stride of P: neighbouring groups' rows
                                // land 16 banks apart
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, s, h;              // in elements; the last axis is contiguous
};

// Rows r0 .. r0 + 63 of one head (row r at base + r * stride) into dst as
// f32, row stride D + 4; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t stride, int r0, int n,
                                          float* __restrict__ dst) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kBQ * kVecs; e += kThreads) {
    const int r = e / kVecs;
    const int c = (e - r * kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(base + static_cast<int64_t>(r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int Hq, int group,
             Strides qs, Strides ks, Strides vs, int causal, int q_offset,
             float scale) {
  constexpr int kLd = D + 4;
  constexpr int kDCols = D / 16;             // output columns per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // kBQ x kLd
  float* sk = sq + kBQ * kLd;                     // kBK x kLd
  float* sv = sk + kBK * kLd;                     // kBK x kLd
  float* sp = sv + kBK * kLd;                     // kBQ x kLdP

  const int g = threadIdx.x >> 4;
  const int c = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile<T, D>(qb, qs.s, q0, Sq, sq);

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  // Causal: keys past the tile's last real row are masked for every row.
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + min(q0 + kBQ, Sq));
  const int n_tiles = (k_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the last tile's k, v and P are read
    load_tile<T, D>(kb, ks.s, k0, Sk, sk);
    load_tile<T, D>(vb, vs.s, k0, Sk, sv);
    __syncthreads();

    // S = q k^T for rows g + 8 i and key columns c + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = load4(sk + (c + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = load4(sq + (g + 8 * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // scale, mask, and the streaming softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q_offset + q0 + g + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + c + 16 * j;
        float x = s[i][j] * scale;
        if (k_pos >= Sk || (causal && q_pos < k_pos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < kCols; ++j) sp[(g + 8 * i) * kLdP + c + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P v for rows g + 8 i and head columns c + 16 j
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float vv[4][kDCols];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < kDCols; ++j) vv[u][j] = sv[(kk + u) * kLd + c + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = load4(sp + (g + 8 * i) * kLdP + kk);
#pragma unroll
        for (int j = 0; j < kDCols; ++j) {
          acc[i][j] = fmaf(p.x, vv[0][j], acc[i][j]);
          acc[i][j] = fmaf(p.y, vv[1][j], acc[i][j]);
          acc[i][j] = fmaf(p.z, vv[2][j], acc[i][j]);
          acc[i][j] = fmaf(p.w, vv[3][j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + g + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && c == 0)
      lse[(static_cast<int64_t>(b) * Hq + h) * Sq + row] = m[i] + logf(den);
    T* out = o + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) out[c + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, Strides qs, Strides ks,
           Strides vs, int causal, int q_offset, cudaStream_t stream) {
  constexpr int kSmem = static_cast<int>(sizeof(float))
                        * (3 * kBQ * (D + 4) + kBQ * kLdP);
  // above 48 KB a block's dynamic shared memory must be allowed per kernel
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, Hq, Hq / Hkv,
      qs, ks, vs, causal, q_offset, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                 Strides qs, Strides ks, Strides vs, int causal, int q_offset,
                 cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, qs, ks, vs, causal, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, qs, ks, vs, causal, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, qs, ks, vs, causal, q_offset, s);
    default: return -2;
  }
}

}  // namespace

// q: (B, Sq, Hq, D), k and v: (B, Sk, Hkv, D), each with the given batch,
// sequence and head strides (elements) and a contiguous last axis, 4-element
// aligned; o: (B, Sq, Hq, D) contiguous; lse: null, or (B, Hq, Sq) f32 for
// each row's log-sum-exp. Query row r sits at global position
// q_offset + r, key j at j. Returns 0 on success, else the CUDA error code
// of the launch, -1 for a type other than f32 (`dtype` 0) or -2 for an
// unsupported D.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int causal, int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  switch (dtype) {
    case 0: return dispatch_dim<float>(q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, causal, q_offset, s);
    default: return -1;
  }
}
