// wkv6 backward: the gradient of the RWKV-6 time-mix recurrence that
// csrc/wkv6.cu computes forward.
//
// The TPU side has no kernel for this: the JAX package differentiates
// wkv6_chunked (src/repro/models/rwkv6.py:97) through XLA, and
// wkv6_pallas (src/repro/kernels/wkv6.py:65) has no backward. Per head,
// with the forward's 16-row chunks from the start, L the cumulative log
// decay within a chunk, r_f = r e^{L_excl}, k_f = k e^{-L_incl},
// kd = k e^{L_end - L_incl}, A = tril(r_f k_f^T, -1) and G the gradient of
// the state after the chunk (the final state's gradient for the last):
//   G_prev = diag(e^{L_end}) G + r_f^T dy                 (reverse walk)
//   dkd = v G^T    dv = A^T dy + (r u k) dy + kd G
//   dA = tril(dy v^T, -1)   dr_f = dA k_f + dy S_prev^T   dk_f = dA^T r_f
//   dr = dr_f e^{L_excl} + (dy.v) u k
//   dk = dk_f e^{-L_incl} + dkd e^{L_end - L_incl} + (dy.v) u r
//   du = sum over batch and rows of (dy.v) r k
// and dlogw from dL_excl = dr_f r_f and dL_incl = -dk_f k_f - dkd kd (plus,
// at the chunk's last row, dL_end = e^{L_end} sum_w S_prev G + sum_j dkd kd)
// by a reverse cumulative sum down the chunk, less dL_excl. The plain
// version, ref.wkv6_bwd_ref, writes out the same algebra; with
// tf32="split" it also rounds each product's operands as this kernel does.
//
// Bound. At rwkv6-3b's training shape (B 4, S 1024, H 40, K 64, bf16 r, k,
// v): r, k, v and dr, dk, dv (bf16), logw, dy and dlogw (f32) are each
// moved once, 251.7 MB, 0.0751 ms at 3.35 TB/s. The products the function
// needs, per chunk of C rows and head: five of C x K x K multiply-adds (the
// state's recompute k^T v, since the forward keeps no state; the reverse
// walk's r_f^T dy; v G^T; kd G; dy S_prev^T), three over the scores'
// lower triangle with its diagonal (A with the bonus, dA with dy . v, A^T
// dy) and two over the strict triangle (dA k_f, dA^T r_f), each triangle
// entry K multiply-adds: 7.56 GFLOP there. This kernel does them on the
// tensor cores as three TF32 products each, 0.046 ms at 495 TFLOP/s, so
// bytes bound it (0.113 ms if they ran at the CUDA cores' 67 TFLOP/s f32
// rate). chip_smoke.py phase 15 counts both for the shape it times.
//
// Design. One block of sixteen warps per (batch, head), grid (H, B), in
// three roles that hand work on through mbarriers; 220 KB of shared memory
// at bf16 and f16 (224 KB at f32) and at most 128 registers a thread, so
// one block an SM: 160 heads run as a wave of 132 blocks and one of 28.
//   - Rows warps (8-15; a warp two rows of a chunk, a lane two columns).
//     One thread keeps a ring of raw stages (three for f16 and bf16 rows,
//     two for f32) filled by TMA two or three chunks ahead: boxes of one
//     chunk's 16 rows of one head from tensor maps over the (B, S, H, 64)
//     views of r, k, v, logw and dy, rows past S zero-filled by the copy.
//     For each chunk they form its operands into one of two prep stages:
//     the cumulative sums down each column in the plain version's order,
//     the exponentials, r_f, k_f, kd and dy split into TF32 hi and lo
//     planes (v too when it is f32; f16 and bf16 are exact), e^{L_end}, and
//     the row sums r u k and dy . v by a fixed shuffle tree. Then, a chunk
//     behind, its epilogue: dr, dk, dv and dlogw (its reverse sum down each
//     column in the plain version's order) into an output stage that one
//     thread writes out by TMA (rows past S are not written); du per column.
//   - Pass 1 recomputes the chunk-start states, which the forward keeps
//     nowhere, walking the chunks from the first. The state warps (0-3)
//     each hold 16 rows c of S (64 x 64 f32) as mma accumulators (32 floats
//     a thread); a chunk is S = diag(e^{L_end}) S + kd^T v on the tensor
//     cores. Each state goes to the scratch (B H ceil(S/16) x 16 KB,
//     allocated by the wrapper) in the order of the registers that hold
//     it, 16 bytes a thread, so a warp's store and its later load are each
//     512 contiguous bytes; the last chunk's state stays in the registers.
//   - Pass 2 walks the chunks back from the last. The state warps keep G
//     (their 16 rows by 64 columns) as accumulators and take dy S_prev^T
//     and v G^T over all 64 value columns (so no sum crosses warps), sum_w
//     S_prev G, then G <- diag(e^{L_end}) G + r_f^T dy, leaving G
//     transposed in one of two buffers for the product warps; meanwhile
//     they load the next chunk's S_prev from the scratch into registers.
//     The product warps (4-7) take A (bonus on the diagonal) and dA, then
//     dA k_f, dA^T r_f and dv = A^T dy + kd G. The scratch is the one round
//     trip left: 167.8 MB written and read at the training shape, so a
//     design that keeps it cannot beat 587 MB / 3.35 TB/s = 0.175 ms.
//   - Fragment loads: a matrix kept with its contraction index along rows
//     is read as 8-byte pairs of neighbouring k (both operands of that
//     product then take k = 2 t4, 2 t4 + 1 for the mma's k = t4, t4 + 4),
//     one kept with it down columns as single words (k = t4, t4 + 4). Rows
//     are 72 or 24 floats apart (8 mod 32), so neither read conflicts.
//   - What holds it back (PERF.md, from builds of this kernel with parts of
//     its work left out or done twice, timed in turns): each block's latency,
//     not memory (one block alone takes about as long as a wave of 132) and
//     not the tensor cores (issuing the state warps' mma twice adds 3%);
//     the roles' serial work around the products and the hand-offs do.
//
// Precision. Each tensor-core operand x is split as hi = tf32(x) (rounded
// to nearest) and lo = x - hi, which the tensor cores cut to TF32; a
// product is hi hi + hi lo + lo hi in f32 (lo lo dropped; v's lo is zero
// for f16 and bf16 and skipped), as in csrc/wkv6.cu. One TF32 rounding of
// each operand breaks the forward's 3e-4 gate 6-11x; the split's emulation
// is held against jax.vjp in tests/test_torch_rwkv_train.py. Sums,
// exponentials (ex2.approx) and the scans are f32 on the CUDA cores.
//
// No atomics: every output has one writer and every sum a fixed order. du
// leaves each block as a (batch, head) partial; a second kernel sums the
// partials over the batch in order b = 0, 1, ... So a run repeats bit for
// bit.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kK = 64;              // head size
constexpr int kC = 16;              // rows per chunk
constexpr int kThreads = 512;       // warps 0-3 state, 4-7 products, 8-15 rows
constexpr int kRowsThreads = 256;   // the rows warps: two rows of a chunk each
constexpr int kRR = kC / 8;         // rows a rows warp takes
constexpr int kBarBytes = 128;      // the mbarriers (Bar); then 128-byte aligned
constexpr int kW = 72;              // row stride of a 16 x 64 plane, floats
constexpr int kN = 24;              // row stride of a 16 x 16 plane
constexpr int kP = kC * kW;
constexpr int kQ = kC * kN;

// A prep stage: one chunk's operands as 16 x 64 planes [row][column], TF32
// hi and lo (V_L only for f32 v), then e^{L_end} and the bonus r u k of
// each row. Pass 1 uses KD, V and DEC.
enum Prep { RF_H, RF_L, KF_H, KF_L, KD_H, KD_L, DY_H, DY_L, V_H, V_L, kPrepPlanes };
constexpr int oDEC = kPrepPlanes * kP;
constexpr int oBON = oDEC + kK;
constexpr int kPrepFloats = oBON + kC;
// The products handed to the epilogue, [row][column], and sum_w S_prev G
enum Res { DRFS, DKD, DRFL, DKF, DV, kResPlanes };
constexpr int oLSG = kResPlanes * kP;
constexpr int kResFloats = oLSG + kK;
// The product warps' 16 x 16 planes: A (bonus on the diagonal), dA, dA^T
enum Small { AP_H, AP_L, DA_H, DA_L, DAT_H, DAT_L, kSmall };
// float offsets: two prep stages, the products, the small planes, two
// buffers of G transposed ([w][c]), the epilogue's d_incl and dkd kd
constexpr int oRes = 2 * kPrepFloats;
constexpr int oSmall = oRes + kResFloats;
constexpr int oGT = oSmall + kSmall * kQ;
constexpr int oTmp = oGT + 2 * kK * kW;
constexpr int kFloats = oTmp + 2 * kP;
// mbarriers, 8 bytes each: TMA rows landed (per raw stage); prep stage
// written (by the 256 rows threads) and read (by the 256 state and product
// threads); products written (256) and read (256); G^T buffer written (the
// 128 state threads) and read (the 128 product threads)
enum Bar { RAW = 0, PREP_FULL = 3, PREP_EMPTY = 5, RES_FULL = 7, RES_EMPTY = 8,
           GT_FULL = 9, GT_EMPTY = 11 };

// raw stages: three for f16 and bf16 rows, two for f32 (shared memory)
template <typename T>
constexpr int kRawStages = sizeof(T) == 4 ? 2 : 3;

template <typename T>
__host__ __device__ constexpr int raw_bytes() {
  return kC * kK * (3 * static_cast<int>(sizeof(T)) + 8);   // r, k, v; logw, dy
}

// the output stage: one chunk's dr, dk, dv (T) and dlogw (f32) tiles
template <typename T>
__host__ __device__ constexpr int out_bytes() {
  return kC * kK * (3 * static_cast<int>(sizeof(T)) + 4);
}

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kBarBytes + kRawStages<T> * raw_bytes<T>() + out_bytes<T>() + kFloats * 4;
}

struct Strides {
  int64_t b, s, h;                  // in elements; the last axis is contiguous
};

// ---- PTX wrappers (as in csrc/wkv6.cu) ----------------------------------

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

// one box of shared memory out to a 4-D tensor map (rows past its extent
// are not written), in the thread's current bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// the product warps alone (named barrier 1), the rows warps alone (2)
__device__ __forceinline__ void product_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
__device__ __forceinline__ void rows_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// e^x as 2^(x log2 e) in one instruction (about 5e-6 relative at the 80
// the exponents reach, as in csrc/wkv6.cu)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 gives for finite x
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo: hi rounded to TF32, lo = x - hi (exact in f32), which the
// tensor cores cut to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// d += a b for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the three terms of a split product: hi hi, hi lo, lo hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&b)[4]) {
  mma(d, ah, b[0], b[1]);
  mma(d, ah, b[2], b[3]);
  mma(d, al, b[0], b[1]);
}

// the same three terms, each into its own accumulator (three short
// dependency chains instead of one long one)
__device__ __forceinline__ void mma3s(float (&d)[3][4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const uint32_t (&b)[4]) {
  mma(d[0], ah, b[0], b[1]);
  mma(d[1], ah, b[2], b[3]);
  mma(d[2], al, b[0], b[1]);
}

// element i of a product kept as three terms: hi hi + (hi lo + lo hi)
__device__ __forceinline__ float sum3(const float (&d)[3][4], int i) {
  return d[0][i] + (d[1][i] + d[2][i]);
}

__device__ __forceinline__ uint32_t word(const float* p) { return __float_as_uint(*p); }

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The A fragment (rows m0 + g, m0 + g + 8) of a matrix kept [m][k] in
// planes h and l: 8-byte pairs, the mma's k = t4, t4 + 4 taking columns
// k0 + 2 t4, k0 + 2 t4 + 1
__device__ __forceinline__ void a_rows(const float* h, const float* l, int stride, int m0,
                                       int k0, int g, int t4, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int o0 = (m0 + g) * stride + k0 + 2 * t4, o1 = o0 + 8 * stride;
  const float2 p = ld2(h + o0), q = ld2(h + o1), pl = ld2(l + o0), ql = ld2(l + o1);
  ah[0] = __float_as_uint(p.x); ah[1] = __float_as_uint(q.x);
  ah[2] = __float_as_uint(p.y); ah[3] = __float_as_uint(q.y);
  al[0] = __float_as_uint(pl.x); al[1] = __float_as_uint(ql.x);
  al[2] = __float_as_uint(pl.y); al[3] = __float_as_uint(ql.y);
}

// The A fragment of a matrix kept [k][m]: single words, k = t4, t4 + 4
__device__ __forceinline__ void a_cols(const float* h, const float* l, int stride, int m0,
                                       int k0, int g, int t4, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int o0 = (k0 + t4) * stride + m0 + g, o1 = o0 + 4 * stride;
  ah[0] = word(h + o0); ah[1] = word(h + o0 + 8); ah[2] = word(h + o1); ah[3] = word(h + o1 + 8);
  al[0] = word(l + o0); al[1] = word(l + o0 + 8); al[2] = word(l + o1); al[3] = word(l + o1 + 8);
}

// The B fragment (column n0 + g) of a matrix kept [n][k]: one 8-byte pair
// each of hi and lo, k as in a_rows; {hi0, hi1, lo0, lo1}
__device__ __forceinline__ void b_rows(const float* h, const float* l, int stride, int n0,
                                       int k0, int g, int t4, uint32_t (&b)[4]) {
  const int o = (n0 + g) * stride + k0 + 2 * t4;
  const float2 p = ld2(h + o), q = ld2(l + o);
  b[0] = __float_as_uint(p.x); b[1] = __float_as_uint(p.y);
  b[2] = __float_as_uint(q.x); b[3] = __float_as_uint(q.y);
}

// The B fragment of a matrix kept [k][n]: single words, k as in a_cols
__device__ __forceinline__ void b_cols(const float* h, const float* l, int stride, int n0,
                                       int k0, int g, int t4, uint32_t (&b)[4]) {
  const int o = (k0 + t4) * stride + n0 + g;
  b[0] = word(h + o); b[1] = word(h + o + 4 * stride);
  b[2] = word(l + o); b[3] = word(l + o + 4 * stride);
}

// two consecutive elements (4- or 8-byte aligned) widened to f32
__device__ __forceinline__ float2 load2(const float* p) { return ld2(p); }
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// two neighbours rounded to T and stored at once (4- or 8-byte aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// x split into the hi and lo planes at offset o, two neighbours at a time
__device__ __forceinline__ void put_split(float* h, float* l, int o, float x, float y) {
  const float hx = tf32_rna(x), hy = tf32_rna(y);
  *reinterpret_cast<float2*>(h + o) = make_float2(hx, hy);
  *reinterpret_cast<float2*>(l + o) = make_float2(x - hx, y - hy);
}

// ---- the kernel -----------------------------------------------------------

// The tensor maps of r, k, v (type T) and logw and dy (f32): (64, S, H, B),
// boxes of one chunk's 16 rows of one head, rows past S zero-filled.
struct Maps {
  CUtensorMap r, k, v, w, dy;       // read
  CUtensorMap dr, dk, dv, dl;       // written (dr, dk, dv of T; dlogw f32)
};

struct Args {
  const float *u, *s0, *ds_fin;
  float *du_part, *ds0, *states;
  int S, H;
};

// What a rows thread keeps of a chunk's prep for its epilogue: rows kRR e
// + ri, columns 2 l + ci
struct Kept {
  float er[kRR][2], en[kRR][2], ek[kRR][2];   // e^{L_excl}, e^{-L_incl}, e^{L_end - L_incl}
  float rr[kRR][2], kk[kRR][2], dbon[kRR];    // r, k, dy . v
  float2 dec;                                 // e^{L_end}
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);
  unsigned char* raw = smem + kBarBytes;
  unsigned char* outs = raw + kRawStages<T> * raw_bytes<T>();
  float* f = reinterpret_cast<float*>(outs + out_bytes<T>());
  float* res = f + oRes;
  auto bar = [&](int i) { return bars + 8 * i; };
  auto stage = [&](int q) { return f + (q & 1) * kPrepFloats; };
  auto small = [&](int p) { return f + oSmall + p * kQ; };
  auto gt = [&](int j) { return f + oGT + (j & 1) * kK * kW; };

  constexpr bool kSplitV = sizeof(T) == 4;     // f16 and bf16 v are exact in TF32
  constexpr int kTile = kC * kK * static_cast<int>(sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.S, H = a.H;
  const int nc = (S + kC - 1) / kC;
  const int n1 = nc - 1;                       // pass-1 items: chunks 0 .. nc - 2
  const int items = n1 + nc;                   // then pass 2: chunks nc - 1 .. 0
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  auto chunk = [&](int q) { return q < n1 ? q : nc - 1 - (q - n1); };

  if (tid == 0) {
    for (int s = 0; s < kRawStages<T>; ++s) mbar_init(bar(RAW + s), 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar(PREP_FULL + s), kRowsThreads);
      mbar_init(bar(PREP_EMPTY + s), 256);
      mbar_init(bar(GT_FULL + s), 128);
      mbar_init(bar(GT_EMPTY + s), 128);
    }
    mbar_init(bar(RES_FULL), 256);
    mbar_init(bar(RES_EMPTY), kRowsThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ==== rows warps: TMA, prep, epilogue ===================================
    const int e = warp - 8, et = tid - 256;     // rows kRR e .. kRR e + kRR - 1
    const int col = 2 * lane;                   // columns col, col + 1
    const float2 uc = ld2(a.u + h * kK + col);
    float du_acc[2] = {0.f, 0.f};
    float* tmp_inc = f + oTmp;                  // d_incl
    float* tmp_kdp = tmp_inc + kP;              // dkd kd
    // item q's rows into raw stage q % kRawStages<T>, by one thread
    auto issue = [&](int q) {
      if (q >= items) return;
      const int n = chunk(q);
      unsigned char* dst = raw + (q % kRawStages<T>) * raw_bytes<T>();
      const uint32_t br = bar(RAW + q % kRawStages<T>);
      if (q < n1) {
        mbar_expect_tx(br, 2 * kTile + kC * kK * 4);
      } else {
        mbar_expect_tx(br, raw_bytes<T>());
        tma_load(dst, &maps.r, br, 0, n * kC, h, b);
        tma_load(dst + 3 * kTile + kC * kK * 4, &maps.dy, br, 0, n * kC, h, b);
      }
      tma_load(dst + kTile, &maps.k, br, 0, n * kC, h, b);
      tma_load(dst + 2 * kTile, &maps.v, br, 0, n * kC, h, b);
      tma_load(dst + 3 * kTile, &maps.w, br, 0, n * kC, h, b);
    };
    // pass-2 item i's dr, dk, dv, dlogw from the products and the prep's kept
    // values; out through the output stage by TMA (rows past S not written)
    auto epilogue = [&](int i, const Kept& kp) {
      T* odr = reinterpret_cast<T*>(outs);
      T* odk = odr + kC * kK;
      T* odv = odk + kC * kK;
      float* odl = reinterpret_cast<float*>(odv + kC * kK);
      mbar_wait(bar(RES_FULL), i & 1);
      if (et == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      rows_sync();              // the output stage and the column sums' planes are free
      const float2 lsg = ld2(res + oLSG + col);
      float dex[kRR][2];
#pragma unroll
      for (int ri = 0; ri < kRR; ++ri) {
        const int t = kRR * e + ri, o = t * kW + col;
        const float2 drl = ld2(res + DRFL * kP + o), drs = ld2(res + DRFS * kP + o);
        const float2 dkd2 = ld2(res + DKD * kP + o), dkf2 = ld2(res + DKF * kP + o);
        const float2 dv2 = ld2(res + DV * kP + o);
        const float drf[2] = {drl.x + drs.x, drl.y + drs.y};
        const float dkdx[2] = {dkd2.x, dkd2.y}, dkfx[2] = {dkf2.x, dkf2.y};
        const float ux[2] = {uc.x, uc.y};
        float gr[2], gk[2], dinc[2], kdp[2];
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          const float ub = kp.dbon[ri] * ux[ci];
          gr[ci] = drf[ci] * kp.er[ri][ci] + ub * kp.kk[ri][ci];
          gk[ci] = dkfx[ci] * kp.en[ri][ci] + dkdx[ci] * kp.ek[ri][ci] + ub * kp.rr[ri][ci];
          du_acc[ci] += kp.dbon[ri] * kp.rr[ri][ci] * kp.kk[ri][ci];
          const float kd = kp.kk[ri][ci] * kp.ek[ri][ci];
          dex[ri][ci] = drf[ci] * (kp.rr[ri][ci] * kp.er[ri][ci]);
          dinc[ci] = dex[ri][ci] - dkfx[ci] * (kp.kk[ri][ci] * kp.en[ri][ci]) - dkdx[ci] * kd;
          kdp[ci] = dkdx[ci] * kd;
        }
        *reinterpret_cast<float2*>(tmp_inc + o) = make_float2(dinc[0], dinc[1]);
        *reinterpret_cast<float2*>(tmp_kdp + o) = make_float2(kdp[0], kdp[1]);
        store2(odr + t * kK + col, gr[0], gr[1]);
        store2(odk + t * kK + col, gk[0], gk[1]);
        store2(odv + t * kK + col, dv2.x, dv2.y);
      }
      mbar_arrive(bar(RES_EMPTY));              // the products are read
      rows_sync();                              // d_incl and dkd kd are in
      // dL_end = e^{L_end} sum_w S_prev G + sum_j dkd kd, added at row 15;
      // then the reverse cumulative sum of d_incl down each column
      float2 kdp[kC], inc[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        kdp[j] = ld2(tmp_kdp + j * kW + col);
        inc[j] = ld2(tmp_inc + j * kW + col);
      }
      float2 kds = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        kds.x += kdp[j].x;
        kds.y += kdp[j].y;
      }
      float2 run = make_float2(inc[kC - 1].x + (kp.dec.x * lsg.x + kds.x),
                               inc[kC - 1].y + (kp.dec.y * lsg.y + kds.y));
      float2 at[kRR];
#pragma unroll
      for (int t = kC - 1; t >= 0; --t) {
        if (t < kC - 1) {
          run.x += inc[t].x;
          run.y += inc[t].y;
        }
        if (t / kRR == e) at[t % kRR] = run;
      }
#pragma unroll
      for (int ri = 0; ri < kRR; ++ri)
        *reinterpret_cast<float2*>(odl + (kRR * e + ri) * kK + col) =
            make_float2(at[ri].x - dex[ri][0], at[ri].y - dex[ri][1]);
      // the output stage is read by the TMA (the async proxy) next
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      rows_sync();
      if (et == 0) {
        const int row = (nc - 1 - i) * kC;
        tma_store(&maps.dr, odr, 0, row, h, b);
        tma_store(&maps.dk, odk, 0, row, h, b);
        tma_store(&maps.dv, odv, 0, row, h, b);
        tma_store(&maps.dl, odl, 0, row, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    };

    if (et == 0) {
      for (int q = 0; q < kRawStages<T>; ++q) issue(q);
    }
    Kept cur, nxt;
    for (int q = 0; q < items; ++q) {
      const bool fwd = q < n1;
      float* st = stage(q);
      if (q >= 2) mbar_wait(bar(PREP_EMPTY + (q & 1)), ((q >> 1) - 1) & 1);
      mbar_wait(bar(RAW + q % kRawStages<T>), (q / kRawStages<T>) & 1);
      const unsigned char* rw = raw + (q % kRawStages<T>) * raw_bytes<T>();
      const T* xr = reinterpret_cast<const T*>(rw);
      const T* xk = xr + kC * kK;
      const T* xv = xk + kC * kK;
      const float* xw = reinterpret_cast<const float*>(xv + kC * kK);
      const float* xdy = xw + kC * kK;
      // cumulative log decay down columns col, col + 1 in row order, kept at
      // this warp's rows; rows past S are zero and keep the sum
      float2 lsel[kRR], lend = make_float2(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float2 w = ld2(xw + t * kK + col);
        lend.x += w.x;
        lend.y += w.y;
        if (t / kRR == e) lsel[t % kRR] = lend;
      }
      const float2 dec = make_float2(exp_fast(lend.x), exp_fast(lend.y));
      if (e == 0) *reinterpret_cast<float2*>(st + oDEC + col) = dec;
      if (fwd) {
        // pass 1: kd and v
#pragma unroll
        for (int ri = 0; ri < kRR; ++ri) {
          const int t = kRR * e + ri, o = t * kW + col;
          const float2 kv = load2(xk + t * kK + col);
          put_split(st + KD_H * kP, st + KD_L * kP, o, kv.x * exp_fast(lend.x - lsel[ri].x),
                    kv.y * exp_fast(lend.y - lsel[ri].y));
          const float2 v2 = load2(xv + t * kK + col);
          if (kSplitV) {
            put_split(st + V_H * kP, st + V_L * kP, o, v2.x, v2.y);
          } else {
            *reinterpret_cast<float2*>(st + V_H * kP + o) = v2;
          }
        }
      } else {
        // pass 2: r_f, k_f, kd, dy, v; the row sums r u k and dy . v
        float bon[kRR];
#pragma unroll
        for (int ri = 0; ri < kRR; ++ri) {
          const int t = kRR * e + ri, x = t * kK + col, o = t * kW + col;
          const float2 w = ld2(xw + x);
          const float2 r2 = load2(xr + x), k2 = load2(xk + x), v2 = load2(xv + x);
          const float2 d2 = ld2(xdy + x);
          const float lx[2] = {lsel[ri].x, lsel[ri].y}, wx[2] = {w.x, w.y};
          const float le[2] = {lend.x, lend.y};
          const float rx[2] = {r2.x, r2.y}, kx[2] = {k2.x, k2.y};
          float rf[2], kf[2], kd[2];
#pragma unroll
          for (int ci = 0; ci < 2; ++ci) {
            nxt.er[ri][ci] = exp_fast(lx[ci] - wx[ci]);
            nxt.en[ri][ci] = exp_fast(-lx[ci]);
            nxt.ek[ri][ci] = exp_fast(le[ci] - lx[ci]);
            nxt.rr[ri][ci] = rx[ci];
            nxt.kk[ri][ci] = kx[ci];
            rf[ci] = rx[ci] * nxt.er[ri][ci];
            kf[ci] = kx[ci] * nxt.en[ri][ci];
            kd[ci] = kx[ci] * nxt.ek[ri][ci];
          }
          put_split(st + RF_H * kP, st + RF_L * kP, o, rf[0], rf[1]);
          put_split(st + KF_H * kP, st + KF_L * kP, o, kf[0], kf[1]);
          put_split(st + KD_H * kP, st + KD_L * kP, o, kd[0], kd[1]);
          put_split(st + DY_H * kP, st + DY_L * kP, o, d2.x, d2.y);
          if (kSplitV) {
            put_split(st + V_H * kP, st + V_L * kP, o, v2.x, v2.y);
          } else {
            *reinterpret_cast<float2*>(st + V_H * kP + o) = v2;
          }
          bon[ri] = rx[0] * uc.x * kx[0] + rx[1] * uc.y * kx[1];
          nxt.dbon[ri] = d2.x * v2.x + d2.y * v2.y;
        }
        // over the 64 columns by a fixed tree (every lane gets the same bits)
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
#pragma unroll
          for (int ri = 0; ri < kRR; ++ri) {
            bon[ri] += __shfl_xor_sync(0xffffffffu, bon[ri], off);
            nxt.dbon[ri] += __shfl_xor_sync(0xffffffffu, nxt.dbon[ri], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int ri = 0; ri < kRR; ++ri) st[oBON + kRR * e + ri] = bon[ri];
        }
        nxt.dec = dec;
      }
      mbar_arrive(bar(PREP_FULL + (q & 1)));    // the chunk's operands are ready
      rows_sync();                              // its raw stage is read
      if (et == 0) issue(q + kRawStages<T>);
      if (!fwd) {
        if (q > n1) epilogue(q - n1 - 1, cur);
        cur = nxt;
      }
    }
    epilogue(nc - 1, cur);
    // du: this thread's columns over its rows, then the rows warps in order
    rows_sync();
    *reinterpret_cast<float2*>(f + oTmp + e * kK + col) = make_float2(du_acc[0], du_acc[1]);
    rows_sync();
    if (et < kK) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kC / kRR; ++w) s += f[oTmp + w * kK + et];
      a.du_part[bh * kK + et] = s;
    }
    if (et == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  if (warp < 4) {
    // ==== state warps: S and G, rows c0 .. c0 + 15 ============================
    // tile nt holds rows c0 + g, c0 + g + 8 by columns w = 8 nt + 2 t4, + 1
    const int c0 = 16 * warp;
    float* states = a.states + bh * nc * kK * kK;
    float sv[8][4], gv[8][4];
    {
      const float* s0 = a.s0 ? a.s0 + bh * kK * kK : nullptr;
      const float* gf = a.ds_fin ? a.ds_fin + bh * kK * kK : nullptr;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = (c0 + g) * kK + 8 * nt + 2 * t4;
        const float2 s_a = s0 ? ld2(s0 + o) : make_float2(0.f, 0.f);
        const float2 s_b = s0 ? ld2(s0 + o + 8 * kK) : make_float2(0.f, 0.f);
        const float2 g_a = gf ? ld2(gf + o) : make_float2(0.f, 0.f);
        const float2 g_b = gf ? ld2(gf + o + 8 * kK) : make_float2(0.f, 0.f);
        sv[nt][0] = s_a.x; sv[nt][1] = s_a.y; sv[nt][2] = s_b.x; sv[nt][3] = s_b.y;
        gv[nt][0] = g_a.x; gv[nt][1] = g_a.y; gv[nt][2] = g_b.x; gv[nt][3] = g_b.y;
      }
    }
    // G's transposed copy j, which the product warps read for kd G
    auto write_gt = [&](int j) {
      float* GT = gt(j);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int w = 8 * nt + 2 * t4;
        GT[w * kW + c0 + g] = gv[nt][0];
        GT[(w + 1) * kW + c0 + g] = gv[nt][1];
        GT[w * kW + c0 + g + 8] = gv[nt][2];
        GT[(w + 1) * kW + c0 + g + 8] = gv[nt][3];
      }
      mbar_arrive(bar(GT_FULL + (j & 1)));
    };
    write_gt(0);                                // the final state's gradient
    for (int q = 0; q < items; ++q) {
      const int n = chunk(q);
      const float* st = stage(q);
      mbar_wait(bar(PREP_FULL + (q & 1)), (q >> 1) & 1);
      if (q < n1) {
        // S at chunk n's start, in register order, to the scratch
        float* sc = states + static_cast<int64_t>(n) * kK * kK;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float4*>(sc + ((warp * 8 + nt) * 32 + lane) * 4) =
              make_float4(sv[nt][0], sv[nt][1], sv[nt][2], sv[nt][3]);
        // S = diag(e^{L_end}) S + kd^T v: A = kd^T (kept [j][c]), B = v ([j][w])
        const float da = st[oDEC + c0 + g], db = st[oDEC + c0 + g + 8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          sv[nt][0] *= da; sv[nt][1] *= da; sv[nt][2] *= db; sv[nt][3] *= db;
        }
#pragma unroll
        for (int kj = 0; kj < 2; ++kj) {
          uint32_t ah[4], al[4];
          a_cols(st + KD_H * kP, st + KD_L * kP, kW, c0, 8 * kj, g, t4, ah, al);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            uint32_t bv[4];
            b_cols(st + V_H * kP, st + V_L * kP, kW, 8 * nt, 8 * kj, g, t4, bv);
            mma(sv[nt], ah, bv[0], bv[1]);
            mma(sv[nt], al, bv[0], bv[1]);
            if (kSplitV) mma(sv[nt], ah, bv[2], bv[3]);
          }
        }
        mbar_arrive(bar(PREP_EMPTY + (q & 1)));
        continue;
      }
      const int i = q - n1;
      // dr_f's state term (dy S_prev^T)^T = S_prev dy^T and dkd^T = G v^T,
      // rows c0 .. c0 + 15 by the chunk's 16 rows, over all 64 columns w
      float p1[2][4] = {}, p2[2][4] = {};
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t sh[4], sl[4], gh[4], gl[4];
        const int perm[4] = {0, 2, 1, 3};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          split(sv[ks][perm[x]], sh[x], sl[x]);
          split(gv[ks][perm[x]], gh[x], gl[x]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bd[4], bv[4];
          b_rows(st + DY_H * kP, st + DY_L * kP, kW, 8 * nt, 8 * ks, g, t4, bd);
          b_rows(st + V_H * kP, st + V_L * kP, kW, 8 * nt, 8 * ks, g, t4, bv);
          mma3(p1[nt], sh, sl, bd);
          mma(p2[nt], gh, bv[0], bv[1]);
          mma(p2[nt], gl, bv[0], bv[1]);
          if (kSplitV) mma(p2[nt], gh, bv[2], bv[3]);
        }
      }
      // sum_w S_prev G for rows c0 + g, c0 + g + 8
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        ls0 += sv[nt][0] * gv[nt][0] + sv[nt][1] * gv[nt][1];
        ls1 += sv[nt][2] * gv[nt][2] + sv[nt][3] * gv[nt][3];
      }
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
      // to the epilogue as [row t][c], once it has read the last chunk's
      if (i >= 1) mbar_wait(bar(RES_EMPTY), (i - 1) & 1);
      if (t4 == 0) {
        res[oLSG + c0 + g] = ls0;
        res[oLSG + c0 + g + 8] = ls1;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int t = 8 * nt + 2 * t4 + x;
          res[DRFS * kP + t * kW + c0 + g] = p1[nt][x];
          res[DRFS * kP + t * kW + c0 + g + 8] = p1[nt][2 + x];
          res[DKD * kP + t * kW + c0 + g] = p2[nt][x];
          res[DKD * kP + t * kW + c0 + g + 8] = p2[nt][2 + x];
        }
      }
      mbar_arrive(bar(RES_FULL));
      // the previous chunk's S_prev, a chunk ahead of its use
      if (n > 0) {
        const float* sc = states + static_cast<int64_t>(n - 1) * kK * kK;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 x = *reinterpret_cast<const float4*>(
              sc + ((warp * 8 + nt) * 32 + lane) * 4);
          sv[nt][0] = x.x; sv[nt][1] = x.y; sv[nt][2] = x.z; sv[nt][3] = x.w;
        }
      }
      // G <- diag(e^{L_end}) G + r_f^T dy: A = r_f^T (kept [t][c]), B = dy ([t][w])
      const float da = st[oDEC + c0 + g], db = st[oDEC + c0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        gv[nt][0] *= da; gv[nt][1] *= da; gv[nt][2] *= db; gv[nt][3] *= db;
      }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t ah[4], al[4];
        a_cols(st + RF_H * kP, st + RF_L * kP, kW, c0, 8 * kt, g, t4, ah, al);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t bd[4];
          b_cols(st + DY_H * kP, st + DY_L * kP, kW, 8 * nt, 8 * kt, g, t4, bd);
          mma3(gv[nt], ah, al, bd);
        }
      }
      mbar_arrive(bar(PREP_EMPTY + (q & 1)));
      if (n > 0) {
        // G for the chunk before, once the product warps have read the copy
        // two chunks back from that buffer
        if (i + 1 >= 2) mbar_wait(bar(GT_EMPTY + ((i + 1) & 1)), ((i - 1) >> 1) & 1);
        write_gt(i + 1);
      }
    }
    if (a.ds0) {
      float* out = a.ds0 + bh * kK * kK;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = (c0 + g) * kK + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(out + o) = make_float2(gv[nt][0], gv[nt][1]);
        *reinterpret_cast<float2*>(out + o + 8 * kK) = make_float2(gv[nt][2], gv[nt][3]);
      }
    }
    return;
  }

  // ==== product warps: A, dA, then dA k_f, dA^T r_f, dv ======================
  const int o = warp - 4;                       // columns 16 o .. 16 o + 15
  for (int q = 0; q < items; ++q) {
    const float* st = stage(q);
    mbar_wait(bar(PREP_FULL + (q & 1)), (q >> 1) & 1);
    if (q < n1) {
      mbar_arrive(bar(PREP_EMPTY + (q & 1)));
      continue;
    }
    const int i = q - n1;
    float q3[2][4] = {}, q4[2][4] = {}, q5[2][3][4] = {};
    product_sync();                             // the last chunk's A and dA are read
    // warps 4, 5: A's columns 8 o ..; warps 6, 7: dA's columns 8 (o - 2) ..
    const int n0 = 8 * (o & 1);
    float dd[3][4] = {};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t ah[4], al[4], bb[4];
      if (o < 2) {
        a_rows(st + RF_H * kP, st + RF_L * kP, kW, 0, 8 * ks, g, t4, ah, al);
        b_rows(st + KF_H * kP, st + KF_L * kP, kW, n0, 8 * ks, g, t4, bb);
        mma3s(dd, ah, al, bb);
      } else {
        a_rows(st + DY_H * kP, st + DY_L * kP, kW, 0, 8 * ks, g, t4, ah, al);
        b_rows(st + V_H * kP, st + V_L * kP, kW, n0, 8 * ks, g, t4, bb);
        mma(dd[0], ah, bb[0], bb[1]);
        mma(dd[2], al, bb[0], bb[1]);
        if (kSplitV) mma(dd[1], ah, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = g + 8 * hr, j = n0 + 2 * t4;
      float ev[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        ev[x] = j + x < t ? sum3(dd, 2 * hr + x)
              : (o < 2 && j + x == t) ? st[oBON + t] : 0.f;
      }
      if (o < 2) {
        put_split(small(AP_H), small(AP_L), t * kN + j, ev[0], ev[1]);
      } else {
        put_split(small(DA_H), small(DA_L), t * kN + j, ev[0], ev[1]);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float hi = tf32_rna(ev[x]);
          small(DAT_H)[(j + x) * kN + t] = hi;
          small(DAT_L)[(j + x) * kN + t] = ev[x] - hi;
        }
      }
    }
    product_sync();                             // A and dA are complete
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t a3h[4], a3l[4], a4h[4], a4l[4], a5h[4], a5l[4];
      a_cols(small(DAT_H), small(DAT_L), kN, 0, 8 * kt, g, t4, a3h, a3l);
      a_cols(small(DA_H), small(DA_L), kN, 0, 8 * kt, g, t4, a4h, a4l);
      a_cols(small(AP_H), small(AP_L), kN, 0, 8 * kt, g, t4, a5h, a5l);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int n0 = 16 * o + 8 * x;
        uint32_t bk[4], br[4], bd[4];
        b_cols(st + KF_H * kP, st + KF_L * kP, kW, n0, 8 * kt, g, t4, bk);
        mma3(q3[x], a3h, a3l, bk);
        b_cols(st + RF_H * kP, st + RF_L * kP, kW, n0, 8 * kt, g, t4, br);
        mma3(q4[x], a4h, a4l, br);
        b_cols(st + DY_H * kP, st + DY_L * kP, kW, n0, 8 * kt, g, t4, bd);
        mma3s(q5[x], a5h, a5l, bd);
      }
    }
    // dv's kd G, once the state warps have left G for this chunk
    mbar_wait(bar(GT_FULL + (i & 1)), (i >> 1) & 1);
    const float* GT = gt(i);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t ah[4], al[4];
      a_rows(st + KD_H * kP, st + KD_L * kP, kW, 0, 8 * ks, g, t4, ah, al);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float2 gg = ld2(GT + (16 * o + 8 * x + g) * kW + 8 * ks + 2 * t4);
        uint32_t bg[4];
        split(gg.x, bg[0], bg[2]);
        split(gg.y, bg[1], bg[3]);
        mma3s(q5[x], ah, al, bg);
      }
    }
    mbar_arrive(bar(GT_EMPTY + (i & 1)));
    if (i >= 1) mbar_wait(bar(RES_EMPTY), (i - 1) & 1);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int c = 16 * o + 8 * x + 2 * t4;
      *reinterpret_cast<float2*>(res + DRFL * kP + g * kW + c) = make_float2(q3[x][0], q3[x][1]);
      *reinterpret_cast<float2*>(res + DRFL * kP + (g + 8) * kW + c) =
          make_float2(q3[x][2], q3[x][3]);
      *reinterpret_cast<float2*>(res + DKF * kP + g * kW + c) = make_float2(q4[x][0], q4[x][1]);
      *reinterpret_cast<float2*>(res + DKF * kP + (g + 8) * kW + c) =
          make_float2(q4[x][2], q4[x][3]);
      *reinterpret_cast<float2*>(res + DV * kP + g * kW + c) =
          make_float2(sum3(q5[x], 0), sum3(q5[x], 1));
      *reinterpret_cast<float2*>(res + DV * kP + (g + 8) * kW + c) =
          make_float2(sum3(q5[x], 2), sum3(q5[x], 3));
    }
    mbar_arrive(bar(RES_FULL));
    mbar_arrive(bar(PREP_EMPTY + (q & 1)));
  }
}

// du[h][c] = sum over b of du_part[b][h][c], in order b = 0, 1, ...
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ part,
                                   float* __restrict__ du, int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * kK) return;
  float acc = part[i];
  for (int b = 1; b < B; ++b) acc += part[static_cast<int64_t>(b) * H * kK + i];
  du[i] = acc;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query (no link to libcuda)
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
           const float* dy, void* dr, void* dk, void* dv, void* dlogw, const Args& a,
           int B, Strides rs, Strides ks, Strides vs, Strides ws, cudaStream_t stream) {
  const int S = a.S, H = a.H;
  // the encoder is a libcuda call and needs a current context, which a
  // thread that has made no runtime call yet (autograd's, say) lacks:
  // setting the current device makes its primary context current
  int device;
  if (cudaGetDevice(&device) != cudaSuccess || cudaSetDevice(device) != cudaSuccess)
    return -3;
  // dy and the outputs are contiguous
  const Strides ds{static_cast<int64_t>(S) * H * kK, static_cast<int64_t>(H) * kK, kK};
  Maps maps;
  if (!encode<T>(&maps.r, r, B, S, H, rs) || !encode<T>(&maps.k, k, B, S, H, ks) ||
      !encode<T>(&maps.v, v, B, S, H, vs) || !encode<float>(&maps.w, logw, B, S, H, ws) ||
      !encode<float>(&maps.dy, dy, B, S, H, ds) || !encode<T>(&maps.dr, dr, B, S, H, ds) ||
      !encode<T>(&maps.dk, dk, B, S, H, ds) || !encode<T>(&maps.dv, dv, B, S, H, ds) ||
      !encode<float>(&maps.dl, dlogw, B, S, H, ds))
    return -2;
  constexpr int bytes = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<T><<<dim3(H, B), kThreads, bytes, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Gradients of wkv6 (see the header). r, k, v (dtype 0 f32, 1 f16, 2 bf16)
// and logw f32 through their (batch, seq, head) strides (elements, 16-byte
// multiples), the last axis contiguous and the start 16-byte aligned; u
// (H, 64), s0 and ds_fin (B, H, 64, 64) f32 (either may be null: zero); dy
// (B, S, H, 64) f32 contiguous and 16-byte aligned. Writes dr, dk, dv (the
// inputs' dtype) and dlogw (f32), all (B, S, H, 64) contiguous; du_part
// (B, H, 64) and du (H, 64) f32; ds0 (B, H, 64, 64) f32 unless null.
// states: scratch of B H ceil(S/16) x 64 x 64 f32. Two launches on
// `stream`: the walk, then the sum of du over the batch. Returns 0 on
// success, else the CUDA error code of a launch, -1 for an unknown type
// code, -2 when a TMA tensor map cannot be encoded, or -3 when the current
// device's context cannot be made current.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* logw, const void* u, const void* s0,
                               const void* dy, const void* ds_fin, void* dr,
                               void* dk, void* dv, void* dlogw, void* du_part,
                               void* du, void* ds0, void* states, int dtype,
                               int B, int S, int H, int64_t r_sb, int64_t r_ss,
                               int64_t r_sh, int64_t k_sb, int64_t k_ss,
                               int64_t k_sh, int64_t v_sb, int64_t v_ss,
                               int64_t v_sh, int64_t w_sb, int64_t w_ss,
                               int64_t w_sh, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(u), static_cast<const float*>(s0),
               static_cast<const float*>(ds_fin), static_cast<float*>(du_part),
               static_cast<float*>(ds0), static_cast<float*>(states), S, H};
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      ws{w_sb, w_ss, w_sh};
  const float* lw = static_cast<const float*>(logw);
  const float* g = static_cast<const float*>(dy);
  int rc;
  switch (dtype) {
    case 0: rc = launch<float>(r, k, v, lw, g, dr, dk, dv, dlogw, a, B, rs, ks, vs, ws, st);
      break;
    case 1: rc = launch<__half>(r, k, v, lw, g, dr, dk, dv, dlogw, a, B, rs, ks, vs, ws, st);
      break;
    case 2:
      rc = launch<__nv_bfloat16>(r, k, v, lw, g, dr, dk, dv, dlogw, a, B, rs, ks, vs, ws, st);
      break;
    default: return -1;
  }
  if (rc != 0) return rc;
  wkv6_bwd_du_kernel<<<(H * kK + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), B, H);
  return static_cast<int>(cudaGetLastError());
}
