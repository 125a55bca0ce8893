// wkv6, the RWKV-6 time-mix recurrence, forward: a chunked kernel for a
// sequence and a one-pass kernel for a decode step (S = 1).
//
// Replaces wkv6_pallas (src/repro/kernels/wkv6.py:65) and computes what its
// _wkv_kernel computes, per head with a (K x K) state S and w_t = e^{logw_t}:
//   y_t = r_t (diag(u) k_t^T v_t + S_{t-1});  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// in chunks of 16 rows. Within a chunk, with L the cumulative sum of logw
// from the chunk's start (L_incl includes row t, L_excl = L_incl - logw):
//   r_f = r e^{L_excl},  k_f = k e^{-L_incl},  A = tril(r_f k_f^T, -1) + diag(r u k^T)
//   y   = A v + r_f S_prev
//   S   = diag(e^{L_end}) S_prev + kd^T v,  kd = k_f e^{L_end}
// The exponents reach +-80 only because logw >= LOG_W_MIN = -5 and a chunk
// has at most 16 rows (src/repro/models/rwkv6.py:32-36); this kernel keeps
// that contract and never enlarges the chunk.
//
// Bound: bytes, with operations level. Each input is read once and y and
// the state written once: at B=4, S=1024, H=40, K=64 with bf16 r, k, v that
// is 152 MB, 0.0454 ms at 3.35 TB/s. The products the function needs (the
// scores' lower triangle with the bonus, their product with v, r_f S_prev
// and k^T v) are 3.04 GFLOP there: 0.0454 ms at the 67 TFLOP/s f32 rate of
// the CUDA cores. A decode step moves the 5.2 MB of state in and out: 0.0016
// ms.
//
// Chunked kernel (S > 1). One block per (batch, head), 160 blocks at
// rwkv6-3b's B=4, H=40: every input byte is read once, and the chunk's
// cumulative sums and 16 x 16 scores are formed once per head, where four
// blocks per head would form them four times. 160 blocks fill the 132 SMs
// 1.2 times; at bf16 a block takes 104 KB of shared memory and at most 128
// registers a thread, so the 28 SMs that get two heads run both at once.
// Eight warps in two roles:
//   - Producers (warps 4-7). One thread keeps a ring of four raw stages
//     filled by TMA, three chunks ahead: a box of 16 rows of one head per
//     array, from tensor maps over the (B, S, H, 64) views, rows past S
//     zero-filled. For a chunk each thread takes two neighbouring columns
//     and four rows, forms in f32 the cumulative sums down its columns,
//     r_f, k_f, kd, e^{L_end} and r u k (the bonus summed by a fixed warp
//     shuffle tree), and writes r_f, v and kd into one of two prepared
//     stages as TF32 hi and lo terms in the tensor cores' fragment order.
//     Then the four warps form the scores A on the tensor cores (each one
//     n-tile over half the k steps; the halves added in warp order) and
//     write them, masked and with the bonus on the diagonal, beside them.
//     None of that depends on the state, so it runs up to two chunks ahead
//     of the consumers.
//   - Consumers (warps 0-3) each hold 16 of the head's 64 value columns of
//     S, transposed, in registers as mma accumulators (32 floats a thread)
//     for the whole sequence; S never goes to shared or device memory
//     between chunks. A chunk is three products on the tensor cores
//     (mma.sync m16n8k8 TF32): y^T = v^T A^T + S^T r_f^T, then S^T =
//     S^T diag(e^{L_end}) + v^T kd. The accumulator layout of S^T is the A
//     operand layout of the y product once its k index is permuted (k = t4
//     <-> column 2 t4, k = t4 + 4 <-> 2 t4 + 1, with r_f read in the same
//     order), so S feeds the product from registers with no shuffle.
// Full and empty mbarriers hand the prepared stages over, the TMA's bytes
// land on one barrier per raw stage, and a named barrier orders the
// producers' own steps. Shared-memory tiles of 16-byte groups are
// XOR-swizzled by row so that the producers' writes and the consumers'
// fragment reads are free of bank conflicts.
//
// The serial chain: per chunk only y += r_f S_prev and the state update
// depend on the previous chunk. On a consumer warp that is the split of S
// into TF32 terms (3 instructions an element, 32 elements), four or six
// dependent m16n8k8 products on each of its eight accumulator tiles (two k
// steps of the chunk's 16 rows, two or three terms, the tiles independent)
// and the decay's multiply: about 0.1 us of latency a chunk at the H100's
// clock (inferred from the code), against the 1 us a chunk that 64 chunks
// may take to reach half the bound. What holds the kernel above its bound
// is throughput, not the chain: per head and chunk the block issues some
// 5,000 warp instructions (estimated from the compiled code) and 400
// mma.sync m16n8k8 TF32 products, with one warp of each role to a
// scheduler to hide their latency (runs with parts of the work switched
// off, not kept: PERF.md).
//
// Precision. Each tensor-core operand x is split as hi = tf32(x) (rounded
// to nearest) and lo = x - hi, which the tensor cores cut to TF32; a
// product is hi hi + hi lo + lo hi in f32 (lo lo is dropped). v in f16 or
// bf16 is exact in TF32, so its lo term is skipped. The CPU emulation
// (ref.wkv6_ref(..., tf32="split")) uses at most 1.3% of the 3e-4 gate;
// one TF32 rounding of each operand would use 6-11x of it
// (tests/test_torch_rwkv.py, logw over the whole clamp range). The cumulative sums and decays are f32 on the
// CUDA cores; exponentials are ex2.approx of the argument times log2(e)
// (about 5e-6 relative at the 80 the exponents reach).
//
// Decode kernel (S = 1). y_w = sum_c r_c (u_c k_c v_w + S_cw) and S_cw <-
// e^{logw_c} S_cw + k_c v_w in one pass over the state: block (16 value
// columns, head, batch), a thread a row c and four columns, 16-byte loads
// and stores of S, the sum over c by a fixed shuffle tree and then in warp
// order, so a run repeats bit for bit.
//
// What else differs from the Pallas kernel, and why:
//   - State in and out. The Pallas kernel starts from zero and returns no
//     state; serving needs both, so the kernels read s0 (or zero when it is
//     null) and write the final state. A thread reads its part of the state
//     before it writes it and nothing else touches it, so s_fin may be s0
//     itself (the layer's cache, updated in place).
//   - Ragged S. The last chunk may be shorter; its rows past S are
//     zero-filled by the TMA and never written, so they add nothing and
//     leave the decay to the chunk's end that of its last valid row. The
//     Pallas kernel asserts S % 16 == 0.
//   - Layout. r, k, v and logw are read in place through their (B, S, H, K)
//     batch, sequence and head strides (the last axis contiguous; base and
//     strides 16-byte aligned, as TMA needs, which the wrapper checks), where
//     wkv6_pallas copies them to (B H, S, K) first. y is written as
//     (B, S, H, K) f32.
//   - Types. r, k and v are f32, f16 or bf16; logw, u, y and the state are
//     f32. No atomics: every output has one writer and every sum a fixed
//     order, so a run repeats bit for bit.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kK = 64;                  // head size (HEAD_K)
constexpr int kC = 16;                  // rows per chunk (WKV_CHUNK)
constexpr int kConsumers = 128;         // warps 0-3: 16 value columns each
constexpr int kProducers = 128;         // warps 4-7
constexpr int kThreads = kConsumers + kProducers;
constexpr int kPrepStages = 2;
constexpr int kRawStages = 4;

// A prepared stage, in floats. Each tile is rows of 16-byte groups {hi of
// two neighbours, lo of the same two}, the groups swizzled by row (swz).
constexpr int kRF = 0;                  // r_f: [16 rows t][32 groups of c]
constexpr int kSC = kRF + kC * 2 * kK;  // A: [16 rows t][8 groups of j]
constexpr int kVT = kSC + kC * 2 * kC;  // v^T: [64 rows w][8 groups of j]
constexpr int kKD = kVT + kK * 2 * kC;  // kd^T: [64 rows c][8 groups of j]
constexpr int kDEC = kKD + kK * 2 * kC; // e^{L_end}: [64]
constexpr int kPrepFloats = kDEC + kK;
constexpr int kBarBytes = 128;          // full[2], empty[2], raw[4]; then 128-byte aligned
// the producers' own: k_f in r_f's layout, the bonus of each row, and two
// warps' halves of the scores
constexpr int kScratchBytes = (kC * 2 * kK + kC + 2 * 32 * 4) * 4;

template <typename T>
__host__ __device__ constexpr int raw_bytes() {
  return kC * kK * (3 * static_cast<int>(sizeof(T)) + 4);
}

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kBarBytes + kPrepStages * kPrepFloats * 4 + kRawStages * raw_bytes<T>() +
         kScratchBytes;
}

struct Strides {
  int64_t b, s, h;                      // in elements; the last axis is contiguous
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one box of a 4-D tensor map (coordinates innermost first: column, row,
// head, batch) into shared memory, its bytes counted on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// waits until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the producers' own barrier (named barrier 1, their 128 threads)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kProducers) : "memory");
}

// e^x as 2^(x log2 e) in one instruction
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for finite x, in two integer
// instructions at full rate where the conversion runs at a quarter of it
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo: hi rounded to TF32, lo = x - hi (exact in f32) left as it
// is, since the tensor cores read a TF32 operand's top 19 bits and drop the
// rest (lo truncated: 2^-21 of x at most)
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = x - hi;
}

// {hi(a), hi(b), lo(a), lo(b)}: one 16-byte group of a fragment tile
__device__ __forceinline__ float4 split4(float a, float b) {
  float4 g;
  split_tf32(a, g.x, g.z);
  split_tf32(b, g.y, g.w);
  return g;
}

// two consecutive elements (4- or 8-byte aligned) widened to f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// d += a b for one m16n8k8 TF32 tile: a the 4-register A fragment, b0 b1
// the B fragment's two registers
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], float b0,
                                    float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// The 16-byte group a tile's row keeps its group `grp` in: the low three
// bits XORed with a bijection of the row's own low three bits. Eight
// consecutive rows then put one group in eight different bank quads (the
// producers' writes), and rows 2m, 2m + 1 put groups 4q..4q+3 in eight
// different quads (the consumers' fragment reads).
__device__ __forceinline__ int swz(int row, int grp) {
  return grp ^ (((row >> 1) & 3) | ((row & 1) << 2));
}

// ---- chunked kernel -----------------------------------------------------

// The tensor maps of r, k, v (type T) and logw (f32): (64, S, H, B), boxes
// of one chunk's 16 rows of one head, rows past S zero-filled.
struct Maps {
  CUtensorMap r, k, v, w;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_kernel(const __grid_constant__ Maps maps, const float* __restrict__ u,
            const float* s0, float* __restrict__ y, float* s_fin, int S, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  // full[s] at 8 s, empty[s] at 16 + 8 s, raw[s] (the copies) at 32 + 8 s
  const uint32_t bars = smem_addr(smem);
  unsigned char* raw = smem + kBarBytes;      // TMA destinations, 128-byte aligned
  float* prep = reinterpret_cast<float*>(raw + kRawStages * raw_bytes<T>());
  float* kf_t = prep + kPrepStages * kPrepFloats;
  float* bon = kf_t + kC * 2 * kK;            // the bonus of each row

  constexpr bool kSplitV = sizeof(T) == 4;      // f16 and bf16 v are exact in TF32
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nchunks = (S + kC - 1) / kC;
  if (tid == 0) {
    for (int s = 0; s < kPrepStages; ++s) {
      mbar_init(bars + 8 * s, kProducers);
      mbar_init(bars + 16 + 8 * s, kConsumers);
    }
    for (int s = 0; s < kRawStages; ++s) mbar_init(bars + 32 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producers ----
    const int p = tid - kConsumers;
    const int cp = p & 31;                      // columns 2 cp, 2 cp + 1
    const int pw = p >> 5;                      // producer warp: rows 4 pw .. 4 pw + 3
    const float2 uc = *reinterpret_cast<const float2*>(u + h * kK + 2 * cp);
    // chunk m's rows into raw stage m % 4, by one thread: four TMA boxes
    auto issue = [&](int m) {
      if (p == 0 && m < nchunks) {
        unsigned char* dst = raw + (m % kRawStages) * raw_bytes<T>();
        const uint32_t bar = bars + 32 + 8 * (m % kRawStages);
        constexpr int kTile = kC * kK * static_cast<int>(sizeof(T));
        mbar_expect_tx(bar, raw_bytes<T>());
        tma_load(dst, &maps.r, bar, 0, m * kC, h, b);
        tma_load(dst + kTile, &maps.k, bar, 0, m * kC, h, b);
        tma_load(dst + 2 * kTile, &maps.v, bar, 0, m * kC, h, b);
        tma_load(dst + 3 * kTile, &maps.w, bar, 0, m * kC, h, b);
      }
    };
    for (int m = 0; m < kRawStages - 1; ++m) issue(m);

    for (int n = 0; n < nchunks; ++n) {
      producer_sync();                          // chunk n - 1's raw stage fully read
      issue(n + kRawStages - 1);                // into the stage chunk n - 1 held
      mbar_wait(bars + 32 + 8 * (n % kRawStages), (n / kRawStages) & 1);   // chunk n landed
      const int s = n % kPrepStages;
      float* stg = prep + s * kPrepFloats;
      if (n >= kPrepStages) mbar_wait(bars + 16 + 8 * s, (n / kPrepStages - 1) & 1);
      const unsigned char* rw = raw + (n % kRawStages) * raw_bytes<T>();
      const T* xr = reinterpret_cast<const T*>(rw);
      const T* xk = xr + kC * kK;
      const T* xv = xk + kC * kK;
      const float* xw = reinterpret_cast<const float*>(xv + kC * kK);

      // cumulative log decay down columns 2 cp, 2 cp + 1, kept at this
      // warp's rows; zero-filled rows past S keep the sum, so row 15's is the
      // last valid row's
      float2 lsel[4], acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float2 w = *reinterpret_cast<const float2*>(xw + t * kK + 2 * cp);
        acc.x += w.x;
        acc.y += w.y;
        if ((t >> 2) == pw) lsel[t & 3] = acc;
      }
      const float2 dec = make_float2(exp_fast(acc.x), exp_fast(acc.y));
      if (pw == 0) *reinterpret_cast<float2*>(stg + kDEC + 2 * cp) = dec;
      float bk[4];                              // r u k of each row, these two columns
      float kd[4][2], vv[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * pw + i;
        const float2 rv = load2(xr + t * kK + 2 * cp);
        const float2 kv = load2(xk + t * kK + 2 * cp);
        const float2 w = *reinterpret_cast<const float2*>(xw + t * kK + 2 * cp);
        const float2 rf = make_float2(rv.x * exp_fast(lsel[i].x - w.x),
                                      rv.y * exp_fast(lsel[i].y - w.y));
        const float2 kf = make_float2(kv.x * exp_fast(-lsel[i].x),
                                      kv.y * exp_fast(-lsel[i].y));
        bk[i] = rv.x * uc.x * kv.x + rv.y * uc.y * kv.y;
        kd[i][0] = kf.x * dec.x;
        kd[i][1] = kf.y * dec.y;
        const float2 v2 = load2(xv + t * kK + 2 * cp);
        vv[i][0] = v2.x;
        vv[i][1] = v2.y;
        const int at = t * 2 * kK + swz(t, cp) * 4;
        *reinterpret_cast<float4*>(stg + kRF + at) = split4(rf.x, rf.y);
        *reinterpret_cast<float4*>(kf_t + at) = split4(kf.x, kf.y);
      }
      // kd^T and v^T: rows 2 cp, 2 cp + 1, groups of rows t pairs 2 pw, 2 pw + 1
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
        const int c = 2 * cp + ci;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int at = c * 2 * kC + swz(c, 2 * pw + q) * 4;
          *reinterpret_cast<float4*>(stg + kKD + at) = split4(kd[2 * q][ci], kd[2 * q + 1][ci]);
          *reinterpret_cast<float4*>(stg + kVT + at) =
              kSplitV ? split4(vv[2 * q][ci], vv[2 * q + 1][ci])   // f16, bf16: exact
                      : make_float4(vv[2 * q][ci], vv[2 * q + 1][ci], 0.f, 0.f);
        }
      }
      // the bonus: r u k summed over the 64 columns by a fixed tree
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) bk[i] += __shfl_xor_sync(0xffffffffu, bk[i], off);
      }
      if (cp == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) bon[4 * pw + i] = bk[i];
      }
      producer_sync();                          // r_f, k_f, the bonus complete

      // A: strictly lower r_f k_f^T, the bonus on the diagonal, zero above,
      // on the tensor cores: producer warp pw forms columns j of n-tile
      // pw & 1 over the k steps of half pw >> 1 (3 TF32 terms each); warps
      // 2 and 3 hand their halves to warps 0 and 1, which add them
      {
        const int lane = p & 31, g = lane >> 2, t4 = lane & 3;
        const int nt = pw & 1, k0 = 4 * (pw >> 1);
        float shh[4] = {}, shl[4] = {}, slh[4] = {};
#pragma unroll
        for (int kk = k0; kk < k0 + 4; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(
              stg + kRF + g * 2 * kK + swz(g, 4 * kk + t4) * 4);
          const float4 a1 = *reinterpret_cast<const float4*>(
              stg + kRF + (g + 8) * 2 * kK + swz(g + 8, 4 * kk + t4) * 4);
          const int j = 8 * nt + g;
          const float4 f = *reinterpret_cast<const float4*>(
              kf_t + j * 2 * kK + swz(j, 4 * kk + t4) * 4);
          const uint32_t ah[4] = {__float_as_uint(a0.x), __float_as_uint(a1.x),
                                  __float_as_uint(a0.y), __float_as_uint(a1.y)};
          const uint32_t al[4] = {__float_as_uint(a0.z), __float_as_uint(a1.z),
                                  __float_as_uint(a0.w), __float_as_uint(a1.w)};
          mma(shh, ah, f.x, f.y);
          mma(shl, ah, f.z, f.w);
          mma(slh, al, f.x, f.y);
        }
        float4 part;                            // this warp's half of four entries
        part.x = shh[0] + (shl[0] + slh[0]);
        part.y = shh[1] + (shl[1] + slh[1]);
        part.z = shh[2] + (shl[2] + slh[2]);
        part.w = shh[3] + (shl[3] + slh[3]);
        float4* half_sums = reinterpret_cast<float4*>(kf_t + kC * 2 * kK + kC);
        if (pw >= 2) half_sums[(pw - 2) * 32 + lane] = part;
        producer_sync();                        // the upper halves are written
        if (pw < 2) {
          const float4 up = half_sums[pw * 32 + lane];
          const float e4[4] = {part.x + up.x, part.y + up.y, part.z + up.z, part.w + up.w};
          // e4[0], e4[1]: row g, columns j0, j0 + 1; e4[2], e4[3]: row g + 8
          const int j0 = 8 * nt + 2 * t4;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int t = g + 8 * hr;
            float e[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int j = j0 + i;
              e[i] = j > t ? 0.f : j == t ? bon[t] : e4[2 * hr + i];
            }
            *reinterpret_cast<float4*>(stg + kSC + t * 2 * kC + swz(t, j0 >> 1) * 4) =
                split4(e[0], e[1]);
          }
        }
      }
      mbar_arrive(bars + 8 * s);                // stage s holds chunk n
    }
    return;
  }

  // ---- consumers: value columns w0 .. w0 + 15, S^T in registers ----
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = 16 * warp;
  const int64_t sbase = (static_cast<int64_t>(b) * H + h) * kK * kK;
  // st[nt]: S^T rows w0 + g, w0 + g + 8 by state columns c, c + 1, c = 8 nt + 2 t4
  float st[8][4] = {};
  if (s0 != nullptr) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* src = s0 + sbase + (8 * nt + 2 * t4) * kK + w0 + g;
      st[nt][0] = src[0];
      st[nt][1] = src[kK];
      st[nt][2] = src[8];
      st[nt][3] = src[kK + 8];
    }
  }

  for (int n = 0; n < nchunks; ++n) {
    const int s = n % kPrepStages;
    mbar_wait(bars + 8 * s, (n / kPrepStages) & 1);
    const float* stg = prep + s * kPrepFloats;

    // v^T as the A operand, k <-> rows j = 8 kj + 2 t4 (k = t4), + 1 (k = t4 + 4)
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int kj = 0; kj < 2; ++kj) {
      const int w = w0 + g;
      const float4 x0 = *reinterpret_cast<const float4*>(
          stg + kVT + w * 2 * kC + swz(w, 4 * kj + t4) * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(
          stg + kVT + (w + 8) * 2 * kC + swz(w + 8, 4 * kj + t4) * 4);
      vh[kj][0] = __float_as_uint(x0.x);
      vh[kj][1] = __float_as_uint(x1.x);
      vh[kj][2] = __float_as_uint(x0.y);
      vh[kj][3] = __float_as_uint(x1.y);
      vl[kj][0] = __float_as_uint(x0.z);
      vl[kj][1] = __float_as_uint(x1.z);
      vl[kj][2] = __float_as_uint(x0.w);
      vl[kj][3] = __float_as_uint(x1.w);
    }
    // y^T (16 value columns by the chunk's rows t = 8 nt + ...), one
    // accumulator per product term
    float yhh[2][4] = {}, yhl[2][4] = {}, ylh[2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int t = 8 * nt + g;
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        const float4 a = *reinterpret_cast<const float4*>(
            stg + kSC + t * 2 * kC + swz(t, 4 * kj + t4) * 4);
        mma(yhh[nt], vh[kj], a.x, a.y);
        mma(yhl[nt], vh[kj], a.z, a.w);
        if (kSplitV) mma(ylh[nt], vl[kj], a.x, a.y);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // S_prev^T columns 8 kk .. 8 kk + 7 as the A operand (k = t4 <-> column
      // 8 kk + 2 t4, k = t4 + 4 <-> 8 kk + 2 t4 + 1), split before the update
      uint32_t ah[4], al[4];
      const int perm[4] = {0, 2, 1, 3};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float hi, lo;
        split_tf32(st[kk][perm[i]], hi, lo);
        ah[i] = __float_as_uint(hi);
        al[i] = __float_as_uint(lo);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int t = 8 * nt + g;
        const float4 f = *reinterpret_cast<const float4*>(
            stg + kRF + t * 2 * kK + swz(t, 4 * kk + t4) * 4);
        mma(yhh[nt], ah, f.x, f.y);
        mma(yhl[nt], ah, f.z, f.w);
        mma(ylh[nt], al, f.x, f.y);
      }
      // S^T columns 8 kk .. 8 kk + 7: decay, then + v^T kd
      const float2 d = *reinterpret_cast<const float2*>(stg + kDEC + 8 * kk + 2 * t4);
      st[kk][0] *= d.x;
      st[kk][1] *= d.y;
      st[kk][2] *= d.x;
      st[kk][3] *= d.y;
      const int c = 8 * kk + g;
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        const float4 f = *reinterpret_cast<const float4*>(
            stg + kKD + c * 2 * kC + swz(c, 4 * kj + t4) * 4);
        mma(st[kk], vh[kj], f.x, f.y);
        mma(st[kk], vh[kj], f.z, f.w);
        if (kSplitV) mma(st[kk], vl[kj], f.x, f.y);
      }
    }
    mbar_arrive(bars + 16 + 8 * s);             // stage s read

    const int t0 = n * kC;
    const int nv = min(kC, S - t0);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 8 * nt + 2 * t4 + i;
        if (t < nv) {
          float* yr = y + ((static_cast<int64_t>(b) * S + t0 + t) * H + h) * kK + w0 + g;
          yr[0] = yhh[nt][i] + (yhl[nt][i] + ylh[nt][i]);
          yr[8] = yhh[nt][2 + i] + (yhl[nt][2 + i] + ylh[nt][2 + i]);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float* dst = s_fin + sbase + (8 * nt + 2 * t4) * kK + w0 + g;
    dst[0] = st[nt][0];
    dst[kK] = st[nt][1];
    dst[8] = st[nt][2];
    dst[kK + 8] = st[nt][3];
  }
}

// ---- decode kernel (S = 1) ------------------------------------------------

constexpr int kDecThreads = 256;        // 64 rows x 4 threads of 4 columns
constexpr int kDecCols = 16;            // value columns a block owns

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
wkv6_decode_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const float* s0,
                   float* __restrict__ y, float* s_fin, int H, Strides rs,
                   Strides ks, Strides vs, Strides ws) {
  __shared__ float part[kDecThreads / 32][kDecCols];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid >> 2;                       // the state row
  const int w = blockIdx.x * kDecCols + 4 * (tid & 3);   // the first of four columns
  const int h = blockIdx.y, b = blockIdx.z;
  const float rc = to_f32(r[b * rs.b + h * rs.h + c]);
  const float kc = to_f32(k[b * ks.b + h * ks.h + c]);
  const float ukc = u[h * kK + c] * kc;
  const float dec = expf(logw[b * ws.b + h * ws.h + c]);
  const float4 vv = load4(v + b * vs.b + h * vs.h + w);
  const int64_t at = ((static_cast<int64_t>(b) * H + h) * kK + c) * kK + w;
  const float4 sv = s0 == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                  : *reinterpret_cast<const float4*>(s0 + at);
  float part4[4] = {rc * fmaf(ukc, vv.x, sv.x), rc * fmaf(ukc, vv.y, sv.y),
                    rc * fmaf(ukc, vv.z, sv.z), rc * fmaf(ukc, vv.w, sv.w)};
  *reinterpret_cast<float4*>(s_fin + at) =
      make_float4(fmaf(dec, sv.x, kc * vv.x), fmaf(dec, sv.y, kc * vv.y),
                  fmaf(dec, sv.z, kc * vv.z), fmaf(dec, sv.w, kc * vv.w));
  // the warp's 8 rows (lanes 4 apart), by a fixed tree; then the 8 warps in order
#pragma unroll
  for (int off = 4; off < 32; off *= 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) part4[i] += __shfl_xor_sync(0xffffffffu, part4[i], off);
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp][4 * lane + i] = part4[i];
  }
  __syncthreads();
  if (tid < kDecCols) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kDecThreads / 32; ++i) a += part[i][tid];
    y[(static_cast<int64_t>(b) * H + h) * kK + blockIdx.x * kDecCols + tid] = a;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no link
// to the driver library)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T> constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
template <> constexpr CUtensorMapDataType kMapType<__half> = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
template <> constexpr CUtensorMapDataType kMapType<__nv_bfloat16> =
    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// a (B, S, H, 64) tensor of T as the map (64, S, H, B) with boxes of 16 rows
// of one head, no swizzle (row-major in shared memory), rows past S read as
// zero; an axis of size 1 gets its contiguous stride (never stepped)
template <typename T>
bool encode(CUtensorMap* map, const void* base, int B, int S, int H, Strides st) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int64_t e = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kK), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(e * (S > 1 ? st.s : static_cast<int64_t>(H) * kK)),
      static_cast<cuuint64_t>(e * (H > 1 ? st.h : kK)),
      static_cast<cuuint64_t>(e * (B > 1 ? st.b : static_cast<int64_t>(S) * H * kK))};
  const cuuint32_t box[4] = {kK, kC, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, kMapType<T>, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* y, float* s_fin, int B,
           int S, int H, Strides rs, Strides ks, Strides vs, Strides ws,
           cudaStream_t stream) {
  if (S == 1) {
    wkv6_decode_kernel<T><<<dim3(kK / kDecCols, H, B), kDecThreads, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        logw, u, s0, y, s_fin, H, rs, ks, vs, ws);
    return static_cast<int>(cudaGetLastError());
  }
  // the encoder is a libcuda call and needs a current context, which a
  // thread that has made no runtime call yet (autograd's, say) lacks:
  // setting the current device makes its primary context current
  int device;
  if (cudaGetDevice(&device) != cudaSuccess || cudaSetDevice(device) != cudaSuccess)
    return -3;
  Maps maps;
  if (!encode<T>(&maps.r, r, B, S, H, rs) || !encode<T>(&maps.k, k, B, S, H, ks) ||
      !encode<T>(&maps.v, v, B, S, H, vs) || !encode<float>(&maps.w, logw, B, S, H, ws))
    return -2;
  constexpr int bytes = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T><<<dim3(H, B), kThreads, bytes, stream>>>(maps, u, s0, y, s_fin, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, 64) of type `dtype`, logw: (B, S, H, 64) f32, each
// with the given batch, sequence and head strides (elements, 16-byte
// multiples), a contiguous last axis and a 16-byte aligned start; u: (H, 64)
// f32; s0: (B, H, 64, 64) f32 or null for a zero state; y: (B, S, H, 64) f32
// and s_fin: (B, H, 64, 64) f32, all contiguous and 16-byte aligned (s_fin
// may be s0). S = 1 takes the one-pass decode kernel, S > 1 the chunked one.
// Returns 0 on success, else the CUDA error code of the launch, -1 for an
// unknown type code, or -2 when a TMA tensor map cannot be encoded.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* y, void* s_fin, int dtype, int B, int S,
                           int H, int64_t r_sb, int64_t r_ss, int64_t r_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t w_sb, int64_t w_ss, int64_t w_sh,
                           void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, ws{w_sb, w_ss, w_sh};
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s0);
  float* yy = static_cast<float*>(y);
  float* so = static_cast<float*>(s_fin);
  switch (dtype) {
    case 0: return launch<float>(r, k, v, lw, uu, si, yy, so, B, S, H, rs, ks, vs, ws, st);
    case 1: return launch<__half>(r, k, v, lw, uu, si, yy, so, B, S, H, rs, ks, vs, ws, st);
    case 2: return launch<__nv_bfloat16>(r, k, v, lw, uu, si, yy, so, B, S, H, rs, ks, vs, ws, st);
    default: return -1;
  }
}
