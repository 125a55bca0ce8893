// Flash attention, backward, for f16 and bf16 inputs: dq, dk and dv of
// o = softmax(q k^T / sqrt(D) [causal]) v on the tensor cores.
//
// flash_attention_pallas (src/repro/kernels/flash_attention.py:62) is
// forward only; the JAX model gets attention's gradient by autodiff of
// chunked_attention (@jax.checkpoint, src/repro/models/layers.py:141). This
// kernel computes the written-out flash backward of
// ref.flash_attention_bwd_ref, with the scores S = q k^T / sqrt(D) masked as
// in the forward:
//   P = exp(S - lse)   dV = P^T dO   dP = dO V^T   Delta = rowsum(dO * O)
//   dS = P * (dP - Delta)   dQ = dS K / sqrt(D)   dK = dS^T Q / sqrt(D)
// f32 inputs take flash_attention_bwd.cu, whose products run in f32.
//
// Arithmetic. The five products run on the tensor cores as
// mma.sync.m16n8k16 with 16-bit operands and f32 sums: S = Q K^T and
// dP = dO V^T read the inputs as they are; P and dS are rounded to the input
// type just before dV += P^T dO, dK += dS^T Q and dQ += dS K, as
// FlashAttention-2 does (ref.flash_attention_bwd_ref(..., round_to=dtype)
// emulates it). The exponent from lse, Delta and dS = P (dP - Delta) stay in
// f32. P and dS never leave registers: the f32 accumulator fragment of two
// adjacent 8-column tiles is, element for element, the 16-bit A operand of
// one 16-deep product, so the P^T and dS^T of a tile pair feed the next
// products after one rounding each. Operands come from shared memory through
// ldmatrix (.trans where the product reads a tile along its rows).
//
// Instruction: mma.sync, not wgmma. wgmma takes A from shared memory or
// from registers in its own fragment layout, and B only from shared memory;
// every product here has a 64-row tile per block split over four warps, and
// the register-resident P^T and dS^T are the A operand of the m16n8k16
// layout. A wgmma version would stage P and dS through shared memory or
// reshape them to the warpgroup's layout; that is the next step.
//
// Passes, each its own launch (the `pass` argument), none with atomics, so
// every element has one owner per pass, each sum runs in a fixed order and
// two calls give the same bits:
//   0. Delta for each (batch, q head, row), one warp per row
//      (flash_bwd_delta.cuh).
//   1. dk, dv partials: one block per (q head, batch, 64-key tile), the key
//      tile the slowest grid axis so that the longest blocks (key tile 0
//      under a causal mask sees every query tile) start first. A block holds
//      its K and V tiles in shared memory and walks the query tiles of its
//      one q head from the first that sees the tile, the next query tile's
//      Q, dO, lse and Delta copied in with cp.async while the current one is
//      computed. Its dK and dV sums (unscaled, f32) go to scratch of shape
//      (B, Hq, Sk, D) each. Splitting the G = Hq / Hkv q heads of a kv head
//      over blocks keeps the longest block at n query tiles where the f32
//      route's walks G n (2,048 blocks of at most 16 pairs at full
//      tinyllama, against 256 of up to 128).
//   2. dq: one block per (q head, batch, 64-row query tile), longest first,
//      walking the key tiles up to the causal limit with the next K and V
//      tiles copied in while the current ones are computed.
//   3. dk = round(sum over the G heads of the dK partials, in head order,
//      times 1/sqrt(D)), dv likewise without the scale.
// S and dP are computed in both passes 1 and 2: 7 products of 64 x 64 x D
// per tile pair where a dQ summed with atomics needs 5, the price of
// determinism without a (B, Hq, Sq, D) per-key-tile reduction.
//
// Threads: four warps, each owning 16 rows of the block's 64-row tile (key
// rows in pass 1, query rows in pass 2) and all 64 columns of the score
// tile, so each warp's S^T (or S) and dP^T (or dP) are 16 x 64 f32, 32
// registers each; its dK and dV sums (pass 1) 16 x D f32. Shared memory
// holds 16-bit tiles with rows padded by 8 elements, so the 8 row addresses
// of an ldmatrix fall in distinct banks: (2 + 2 x 2) tiles of 64 x (D + 8),
// 55,296 bytes at D = 64 and 104,448 at D = 128, plus lse and Delta.
//
// Layout: q, o, do, dq (B, Sq, Hq, D) and k, v, dk, dv (B, Sk, Hkv, D), all
// contiguous and 16-byte aligned, f16 or bf16; lse and Delta (B, Hq, Sq)
// f32. Query row i sits at position q_offset + i and key j at j, as in the
// forward; rows past Sq and keys past Sk are zero-filled in shared memory,
// masked, and never written.
//
// Bound: operations. The five products the backward needs are 43 GFLOP at
// full tinyllama-1.1b's training shape (B 4, S 1024, Hq 32, D 64, causal):
// 0.0435 ms at the bf16 tensor-core rate; this kernel does 7/5 of that.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"
#include "flash_bwd_delta.cuh"

namespace {

constexpr int kB = 64;          // rows per tile, queries and keys alike
constexpr int kThreads = 128;   // four warps of 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

template <int D> __host__ __device__ constexpr int ld() { return D + 8; }   // row stride

template <int D>
constexpr int smem_bytes() {
  return 6 * kB * ld<D>() * 2 + 4 * kB * static_cast<int>(sizeof(float));
}

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: a the 4-register A fragment, b0 b1 the B
// fragment's two registers
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- tiles and fragments ------------------------------------------------

// Rows r0 .. r0 + 63 of one head (row r at base + r * stride) into dst (row
// stride D + 8) by cp.async; rows at or past n are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t stride, int r0, int n, T* dst) {
  constexpr int kChunks = D / 8;             // 16-byte chunks per row
  for (int e = threadIdx.x; e < kB * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * ld<D>() + c,
               in ? base + static_cast<int64_t>(r0 + r) * stride + c : base, in);
  }
}

// 64 values of a (B, Hq, Sq) f32 row from r0 (zero past n), by 64 threads
__device__ __forceinline__ void load_row64(const float* __restrict__ src,
                                           int r0, int n, float* dst) {
  const int e = threadIdx.x;
  if (e < kB) cp_async4(dst + e, r0 + e < n ? src + r0 + e : src, r0 + e < n);
}

// A fragment (16 x 16) of rows m0.. and columns k0.. of a tile stored
// [row][col], col contiguous
template <int D, typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const T* tile, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (m0 + (lane & 15)) * ld<D>() + k0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles (n0.., n0 + 8..) over depth k0..k0 + 15
// from a tile stored [n][k], k contiguous: b[0], b[1] for the first, b[2],
// b[3] for the second
template <int D, typename T>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const T* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld<D>() + k0
                 + ((lane >> 3) & 1) * 8);
}

// the same from a tile stored [k][n], n contiguous (ldmatrix .trans)
template <int D, typename T>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const T* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld<D>() + n0
                   + (lane >> 4) * 8);
}

// acc[8][4] = rows m0.. of a (16 x D) times the 64 rows of b^T (64 x D
// tile stored [n][k]): a 16 x 64 score tile in accumulator fragments
template <typename T, int D>
__device__ __forceinline__ void scores(float (&acc)[8][4], const T* a, const T* b, int m0) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t fa[4];
    frag_a<D>(fa, a, m0, k0);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t fb[4];
      frag_b_nk<D>(fb, b, n * 8, k0);
      mma<T>(acc[n], fa, fb[0], fb[1]);
      mma<T>(acc[n + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[D / 8][4] += w (16 x 64, A fragments from registers, 4 deep tiles)
// times m (64 x D tile stored [k][n])
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const uint32_t (&w)[4][4], const T* m) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t fb[4];
      frag_b_kn<D>(fb, m, n * 8, kk * 16);
      mma<T>(acc[n], w[kk], fb[0], fb[1]);
      mma<T>(acc[n + 1], w[kk], fb[2], fb[3]);
    }
}

// a 16 x 64 f32 accumulator tile, rounded, as the A fragments of 4 16-deep
// products
template <typename T>
__device__ __forceinline__ void to_a(uint32_t (&w)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    w[kk][0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
    w[kk][1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
    w[kk][2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    w[kk][3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// ---- pass 1: dK and dV partials of one (q head, batch, key tile) ----------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk_part, float* __restrict__ dv_part, int Sq,
            int Sk, int Hq, int Hkv, int causal, int q_offset, float scale) {
  constexpr int kLd = ld<D>();
  extern __shared__ float4 smem4[];
  T* sk = reinterpret_cast<T*>(smem4);      // kB x kLd each
  T* sv = sk + kB * kLd;
  T* sq = sv + kB * kLd;                    // two stages of Q, then of dO
  T* sdo = sq + 2 * kB * kLd;
  float* sl = reinterpret_cast<float*>(sdo + 2 * kB * kLd);   // 2 x kB
  float* sd = sl + 2 * kB;                                     // 2 x kB

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kB;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = warp * 16;
  const int64_t q_rs = static_cast<int64_t>(Hq) * D;     // row strides
  const int64_t k_rs = static_cast<int64_t>(Hkv) * D;
  const int64_t k_off = static_cast<int64_t>(b) * Sk * k_rs + hk * D;
  const int64_t q_off = static_cast<int64_t>(b) * Sq * q_rs + h * D;
  const int64_t r_off = (static_cast<int64_t>(b) * Hq + h) * Sq;
  const float scale_log2 = scale * kLog2e;

  // causal: query row i sees key k0 once q_offset + i >= k0
  const int t_begin = causal ? max(0, k0 - q_offset) / kB : 0;
  const int n_qt = (Sq + kB - 1) / kB;
  auto fetch = [&](int t, int stage) {
    load_tile<T, D>(q + q_off, q_rs, t * kB, Sq, sq + stage * kB * kLd);
    load_tile<T, D>(dout + q_off, q_rs, t * kB, Sq, sdo + stage * kB * kLd);
    load_row64(lse + r_off, t * kB, Sq, sl + stage * kB);
    load_row64(delta + r_off, t * kB, Sq, sd + stage * kB);
  };
  load_tile<T, D>(k + k_off, k_rs, k0, Sk, sk);
  load_tile<T, D>(v + k_off, k_rs, k0, Sk, sv);
  if (t_begin < n_qt) fetch(t_begin, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = t_begin; t < n_qt; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < n_qt) {
      fetch(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tq = sq + stage * kB * kLd;
    const T* tdo = sdo + stage * kB * kLd;
    const float* tl = sl + stage * kB;
    const float* td = sd + stage * kB;
    const int q0 = t * kB;

    float s[8][4], dp[8][4];
    scores<T, D>(s, sk, tq, m0);     // S^T: key rows, query columns
    scores<T, D>(dp, sv, tdo, m0);   // dP^T = V dO^T
    // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - Delta), in f32
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + m0 + (lane >> 2) + (e >> 1) * 8;
        const int col = n * 8 + (lane & 3) * 2 + (e & 1);
        const int qi = q0 + col;
        const bool live = key < Sk && qi < Sq && !(causal && q_offset + qi < key);
        const float p = live ? exp2f(fmaf(s[n][e], scale_log2, -tl[col] * kLog2e)) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - td[col]);
      }
    uint32_t w[4][4];
    to_a<T>(w, s);
    accumulate<T, D>(dva, w, tdo);   // dV += P^T dO
    to_a<T>(w, dp);
    accumulate<T, D>(dka, w, tq);    // dK += dS^T Q
    __syncthreads();                 // this stage is refilled next-but-one
  }
  cp_async_wait<0>();

  const int64_t p_off = (static_cast<int64_t>(b) * Hq + h) * Sk;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + m0 + (lane >> 2) + half * 8;
    if (key >= Sk) continue;
    float* pk = dk_part + (p_off + key) * D;
    float* pv = dv_part + (p_off + key) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(pk + col) = make_float2(dka[n][2 * half], dka[n][2 * half + 1]);
      *reinterpret_cast<float2*>(pv + col) = make_float2(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

// ---- pass 2: dQ of one (q head, batch, query tile) -------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
          int q_offset, float scale) {
  constexpr int kLd = ld<D>();
  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);      // kB x kLd each
  T* sdo = sq + kB * kLd;
  T* sk = sdo + kB * kLd;                   // two stages of K, then of V
  T* sv = sk + 2 * kB * kLd;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;   // longest rows first
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = warp * 16;
  const int64_t q_rs = static_cast<int64_t>(Hq) * D;
  const int64_t k_rs = static_cast<int64_t>(Hkv) * D;
  const int64_t q_off = static_cast<int64_t>(b) * Sq * q_rs + h * D;
  const int64_t k_off = static_cast<int64_t>(b) * Sk * k_rs + hk * D;
  const int64_t r_off = (static_cast<int64_t>(b) * Hq + h) * Sq;
  const float scale_log2 = scale * kLog2e;

  // causal: keys past the tile's last real row are masked for every row
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + min(q0 + kB, Sq));
  const int n_kt = (k_end + kB - 1) / kB;
  auto fetch = [&](int t, int stage) {
    load_tile<T, D>(k + k_off, k_rs, t * kB, Sk, sk + stage * kB * kLd);
    load_tile<T, D>(v + k_off, k_rs, t * kB, Sk, sv + stage * kB * kLd);
  };
  load_tile<T, D>(q + q_off, q_rs, q0, Sq, sq);
  load_tile<T, D>(dout + q_off, q_rs, q0, Sq, sdo);
  if (n_kt > 0) fetch(0, 0);
  cp_async_commit();

  // lse (times log2 e) and Delta of the thread's two rows
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + m0 + (lane >> 2) + half * 8;
    lse_r[half] = row < Sq ? lse[r_off + row] * kLog2e : 0.f;
    delta_r[half] = row < Sq ? delta[r_off + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_kt) {
      fetch(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tk = sk + stage * kB * kLd;
    const T* tv = sv + stage * kB * kLd;
    const int k0 = t * kB;

    float s[8][4], dp[8][4];
    scores<T, D>(s, sq, tk, m0);     // S: query rows, key columns
    scores<T, D>(dp, sdo, tv, m0);   // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int qi = q0 + m0 + (lane >> 2) + half * 8;
        const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const bool live = key < Sk && qi < Sq && !(causal && q_offset + qi < key);
        const float p = live ? exp2f(fmaf(s[n][e], scale_log2, -lse_r[half])) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[half]);   // dS
      }
    uint32_t w[4][4];
    to_a<T>(w, s);
    accumulate<T, D>(acc, w, tk);    // dQ += dS K
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + m0 + (lane >> 2) + half * 8;
    if (row >= Sq) continue;
    T* out = dq + q_off + static_cast<int64_t>(row) * q_rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(out + col) =
          pack2<T>(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

// ---- pass 3: dK and dV summed over the G q heads, in head order ------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
sum_heads_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                 T* __restrict__ dk, T* __restrict__ dv, int64_t n4, int Sk,
                 int Hq, int Hkv, float scale) {
  // one thread per 4 columns of one (b, key, kv head) row of dk and dv
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  constexpr int kV = D / 4;
  const int c = static_cast<int>(e % kV) * 4;
  const int64_t row = e / kV;                 // (b * Sk + key) * Hkv + hk
  const int hk = static_cast<int>(row % Hkv);
  const int64_t bk = row / Hkv;
  const int64_t b = bk / Sk;
  const int key = static_cast<int>(bk - b * Sk);
  const int group = Hq / Hkv;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < group; ++g) {
    const int64_t at = ((b * Hq + hk * group + g) * Sk + key) * D + c;
    const float4 pk = *reinterpret_cast<const float4*>(dk_part + at);
    const float4 pv = *reinterpret_cast<const float4*>(dv_part + at);
    sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
    sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
  }
  uint32_t* ok = reinterpret_cast<uint32_t*>(dk + row * D + c);
  uint32_t* ov = reinterpret_cast<uint32_t*>(dv + row * D + c);
  ok[0] = pack2<T>(sk.x * scale, sk.y * scale);
  ok[1] = pack2<T>(sk.z * scale, sk.w * scale);
  ov[0] = pack2<T>(sv.x, sv.y);
  ov[1] = pack2<T>(sv.z, sv.w);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float *dk_part, *dv_part;
  int B, Sq, Sk, Hq, Hkv, causal, q_offset;
};

template <typename T, int D>
int launch(int pass, const Args& a, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (a.B > 65535) return -3;
  if (pass == 0) {
    const int rc = launch_delta<T, D>(a.o, a.dout, a.delta, a.B, a.Sq, a.Hq, stream);
    if (rc != 0) return rc;
  } else if (pass == 1) {
    const int n_kt = (a.Sk + kB - 1) / kB;
    if (n_kt > 65535) return -3;
    // above 48 KB a block's dynamic shared memory must be allowed per kernel
    const cudaError_t attr = cudaFuncSetAttribute(
        dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    dkdv_kernel<T, D><<<dim3(a.Hq, a.B, n_kt), kThreads, kSmem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.dk_part, a.dv_part, a.Sq, a.Sk, a.Hq,
        a.Hkv, a.causal, a.q_offset, scale);
  } else if (pass == 2) {
    const int n_qt = (a.Sq + kB - 1) / kB;
    if (n_qt > 65535) return -3;
    const cudaError_t attr = cudaFuncSetAttribute(
        dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    dq_kernel<T, D><<<dim3(a.Hq, a.B, n_qt), kThreads, kSmem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk,
        a.Hq, a.Hkv, a.causal, a.q_offset, scale);
  } else if (pass == 3) {
    const int64_t n4 = static_cast<int64_t>(a.B) * a.Sk * a.Hkv * (D / 4);
    const int64_t blocks = (n4 + 255) / 256;
    if (blocks > 0x7fffffff) return -3;
    sum_heads_kernel<T, D><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        a.dk_part, a.dv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n4,
        a.Sk, a.Hq, a.Hkv, scale);
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

// Runs pass `pass` (0: Delta, 1: dk and dv partials, 2: dq, 3: dk and dv)
// of the backward; the four must run in that order on one stream. q, o, do,
// dq: (B, Sq, Hq, D); k, v, dk, dv: (B, Sk, Hkv, D); all contiguous and
// 16-byte aligned, f16 (`dtype` 1) or bf16 (2). lse: the forward's
// (B, Hq, Sq) f32 log-sum-exp; delta: (B, Hq, Sq) f32 scratch, written by
// pass 0; dk_part, dv_part: (B, Hq, Sk, D) f32 scratch, written by pass 1.
// Returns 0 on success, else the CUDA error code of the launch, -1 for a
// type other than f16 and bf16, -2 for an unsupported D, -3 for a grid too
// large, -4 for an unknown pass.
extern "C" int flash_attention_bwd_tc_launch(
    int pass, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* dk_part, void* dv_part, int dtype, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, int causal, int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv,
               static_cast<float*>(dk_part), static_cast<float*>(dv_part),
               B, Sq, Sk, Hq, Hkv, causal, q_offset};
  switch (dtype) {
    case 1: return dispatch_dim<__half>(pass, D, a, s);
    case 2: return dispatch_dim<__nv_bfloat16>(pass, D, a, s);
    default: return -1;
  }
}
