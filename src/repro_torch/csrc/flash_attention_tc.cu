// Flash attention, forward, for f16 and bf16 inputs on Hopper's tensor
// cores: o = softmax(q k^T / sqrt(D) [causal]) v, products on wgmma, tiles
// brought in by TMA.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:62)
// for 16-bit inputs; f32 inputs take flash_attention.cu. It computes what
// that kernel's header states: scores in f32 scaled by 1/sqrt(D); the
// causal mask q_pos >= k_pos from global positions, masked scores set to the
// -1e30 sentinel; running max m, sum l and accumulator acc in f32, rescaled
// by corr = exp(m_prev - m_new) at each key tile; the output
// acc / max(l, 1e-30), rounded once to q's type; with a non-null lse, each
// row's m + log(l) in f32 (B, Hq, Sq), which the backward consumes. It keeps
// that kernel's other properties: strided q, k, v (a KV-cache prefix is read
// in place), GQA by head index (q head h reads kv head h / (Hq / Hkv)),
// ragged Sq and Sk, causal key tiles above the diagonal skipped (exact, for
// the reason flash_attention.cu gives), and the longest query tiles first.
//
// Arithmetic. S = q k^T runs as wgmma m64n64k16 with 16-bit operands and
// f32 sums, both operands from shared memory. P = exp(S - m) is formed in
// f32 registers and carried to P.V at f32-like precision without f32
// products: P_hi = round(P) and P_lo = round(P - P_hi), both in the input
// type, and acc += P_hi V + P_lo V (two wgmma m64nDk16 with A from
// registers). That keeps about 16 bits of P in bf16 and 22 in f16, where one
// rounding keeps 8 and 11; ref.flash_attention_ref(..., p_dtype=dtype)
// emulates it. The f32 accumulator fragment of S is, element for element,
// the A fragment of the next product (rows 16 w + g and + 8 of warp w, key
// pairs 2 t, 2 t + 1 of each 8-key chunk), so P goes from the score
// registers to the tensor cores with no shuffle and no trip through shared
// memory. The softmax update (row max and sum across the four threads of a
// row, the rescale of acc) stays in f32 registers; the row max is taken on
// the raw scores and each p is one ex2 of fma(s, log2(e)/sqrt(D), -max),
// flushing results under 2^-126 to 0.
//
// Blocks: one per SM, each working through a share of the items (query
// tile, batch, q head), the last (longest) query tiles first; block x takes
// items x, x + grid, ... Three consumer warpgroups (two at D = 128) own 64
// query rows of an item each; one thread of a producer warpgroup issues the
// TMA loads: each item's q tile, then its K and V tiles of 64 keys into a
// ring of four stages, each stage with a "full" mbarrier (the TMA's bytes)
// and an "empty" one (every consumer thread arrives when its products have
// read the stage). The ring runs on across items and q has its own
// full/empty pair, so the next item's copies start while this one's last
// tiles and outputs are computed. The producer gives back registers
// (setmaxnreg) so each consumer thread holds 160 (240 at D = 128) without
// spilling. Within a warpgroup, S of tile t + 1 is issued before the
// softmax of tile t and P.V of tile t runs during the softmax of tile
// t + 1; across warpgroups, one's softmax overlaps another's products. A
// warpgroup whose rows see no key of a tile under the causal mask waits for
// the tile and releases it without computing.
//
// Shared memory holds 16-bit tiles in the swizzled layouts the wgmma
// descriptors name, written that way by TMA: rows of 64 elements (128
// bytes) with the 128-byte swizzle for D = 64 and D = 128 (D = 128 as two
// 64-column panels), rows of 32 bytes with the 32-byte swizzle for D = 16.
// K is the K-major B operand of S = q k^T as stored; V is the B operand of
// P.V in its stored MN-major layout (the transpose bit of wgmma). Rows past
// Sq or Sk come in as zeros (TMA's out-of-bounds fill); keys past Sk are
// masked to the sentinel, and rows past Sq are not written. Shared memory:
// 88 KB at D = 64, 160 KB at D = 128, 22 KB at D = 16.
//
// TMA tensor maps are encoded on the host for each call from the caller's
// strides (4-D: D, S, H, B), through cudaGetDriverEntryPoint (no link to
// the driver library), and passed as __grid_constant__ parameters. Bases
// and strides must be 16-byte aligned.
//
// Bound: operations. A causal call multiplies S(S+1)/2 (query, key) pairs
// twice over D (4 B Hq D S(S+1)/2 flops): 17.2 GFLOP, 0.0174 ms at the bf16
// tensor-core rate, at full tinyllama-1.1b's prefill shape. The split of P
// makes that three products, 0.026 ms. What holds this version above it,
// as far as runs with parts of the work switched off can tell (PERF.md):
// the m64n64k16 products issue well below the tensor cores' peak rate, and
// each element's ex2 and two conversions take the quarter-rate units.

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kBK = 64;                    // keys per tile
constexpr int kStages = 4;                 // K/V tiles in flight
static_assert(kStages >= 3, "S of tile t + 1 is waited for before tile t - 1 is released");
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry for head size D. A tile is kPanels panels of
// kCols columns, each row of a panel kRowBytes long.
template <int D>
struct Geo {
  static constexpr int kWGs = D == 128 ? 2 : 3;      // consumer warpgroups
  static constexpr int kBQ = 64 * kWGs;              // query rows per block
  static constexpr int kConsumers = 128 * kWGs;
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  // registers per thread after the split: the producer gives back what the
  // consumers take (65,536 in all)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kWGs == 3 ? 160 : 240;
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kPanels = D / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr uint32_t kLayout = D < 64 ? 3 : 1;   // wgmma: 3 = 32B, 1 = 128B swizzle
  static constexpr int kAtom = 8 * kRowBytes;           // 8 rows: the swizzle's repeat
  static constexpr int kQPanel = kBQ * kRowBytes;
  static constexpr int kKPanel = kBK * kRowBytes;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;        // one K or one V tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes
                               + (2 * kStages + 2) * 8;
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, its bytes counted on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 2^x in one instruction; results under 2^-126 flush to 0 (a p that small
// adds nothing next to a row sum of at least 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N of this warpgroup's commit groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers in program order around the asynchronous products: the
// compiler may not move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(x[i][j]) :: "memory");
}

// the accumulator registers of one thread: placeholders, operands
#define WG_D8_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_D8_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7])
#define WG_D32_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define WG_D32_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31])
#define WG_D64_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_D64_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

template <typename T> constexpr bool kIsHalf = std::is_same<T, __half>::value;

// d (64 x 64 f32) = [d +] A B^T, A (64 x 16) and B (64 x 16) K-major in
// shared memory; scale_d = 0 overwrites d
#define WG_SS_N64(TY)                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "    \
               WG_D32_REGS ", %32, %33, p, 1, 1, 0, 0;\n}\n"                  \
               : WG_D32_OPS(d)                                               \
               : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (kIsHalf<T>) WG_SS_N64("f16"); else WG_SS_N64("bf16");
}

// d (64 x N f32) += A B, A (64 x 16) from registers, B (16 x N) MN-major in
// shared memory (the transpose bit)
#define WG_RS(N, REGS, OPS, A0, A1, A2, A3, DESC, ONE, TY)                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" ONE ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " "  \
               REGS ", {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" DESC          \
               ", p, 1, 1, 1;\n}\n"                                          \
               : OPS(d)                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsHalf<T>)
    WG_RS("16", WG_D8_REGS, WG_D8_OPS, "8", "9", "10", "11", "12", "13", "f16");
  else
    WG_RS("16", WG_D8_REGS, WG_D8_OPS, "8", "9", "10", "11", "12", "13", "bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsHalf<T>)
    WG_RS("64", WG_D32_REGS, WG_D32_OPS, "32", "33", "34", "35", "36", "37", "f16");
  else
    WG_RS("64", WG_D32_REGS, WG_D32_OPS, "32", "33", "34", "35", "36", "37", "bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsHalf<T>)
    WG_RS("128", WG_D64_REGS, WG_D64_OPS, "64", "65", "66", "67", "68", "69", "f16");
  else
    WG_RS("128", WG_D64_REGS, WG_D64_OPS, "64", "65", "66", "67", "68", "69", "bf16");
}

// x0, x1 as P_hi = round(x) and P_lo = round(x - P_hi), each a packed pair
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  float h0, h1;
  if constexpr (kIsHalf<T>) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&hi));
    h0 = f.x;
    h1 = f.y;
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
    h0 = f.x;
    h1 = f.y;
  }
  lo = pack2<T>(x0 - h0, x1 - h1);
}

// ---- the kernel ---------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, T* __restrict__ o,
                float* __restrict__ lse, int B, int Sq, int Sk, int Hq, int group,
                int causal, int q_offset, float scale_log2) {
  using G = Geo<D>;
  constexpr int kBQ = G::kBQ, kConsumers = G::kConsumers;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  const uint32_t sk = sq + G::kQBytes;                            // kStages K tiles
  const uint32_t sv = sk + kStages * G::kTileBytes;               // kStages V tiles
  const uint32_t bars = sv + kStages * G::kTileBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t qbar = bars + 16u * kStages;

  const uint32_t qempty = qbar + 8u;
  // The work items are the (query tile, batch, q head) triples, the last
  // (longest) query tiles first; block x takes items x, x + gridDim.x, ...
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int n_items = n_qt * B * Hq;
  // item i: its head, batch, first query row and its block's key tiles
  auto item = [&](int i, int& h, int& b, int& q0, int& n_tiles) {
    const int bh = i % (B * Hq);
    h = bh % Hq;
    b = bh / Hq;
    q0 = (n_qt - 1 - i / (B * Hq)) * kBQ;
    int k_end = Sk;                  // causal: keys past the tile's last row
    if (causal) k_end = min(Sk, q_offset + min(q0 + kBQ, Sq));
    n_tiles = (k_end + kBK - 1) / kBK;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_init(qempty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup: one thread issues every copy. K/V tiles run
    // through the ring in one sequence over the block's items (tile count
    // tg), so the next item's copies start as soon as stages free up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(G::kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int tg = 0, it = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++it) {
        int h, b, q0, n_tiles;
        item(i, h, b, q0, n_tiles);
        const int hk = h / group;
        mbar_wait(qempty, (it & 1) ^ 1);       // the last item's S is done
        mbar_expect_tx(qbar, G::kQBytes);
        for (int p = 0; p < G::kPanels; ++p)
          tma_load(sq + p * G::kQPanel, &map_q, qbar, p * G::kCols, q0, h, b);
        for (int t = 0; t < n_tiles; ++t, ++tg) {
          const int s = tg % kStages;
          mbar_wait(empty(s), ((tg / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * G::kTileBytes);
          for (int p = 0; p < G::kPanels; ++p) {
            const uint32_t off = s * G::kTileBytes + p * G::kKPanel;
            tma_load(sk + off, &map_k, full(s), p * G::kCols, t * kBK, hk, b);
            tma_load(sv + off, &map_v, full(s), p * G::kCols, t * kBK, hk, b);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(G::kConsumerRegs));
  // a consumer: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each
  // item; this thread rows r0 and r0 + 8, key (and output) columns 8 j +
  // 2 c, + 1
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const uint32_t qa = sq + 64 * wg * G::kRowBytes;       // this warpgroup's rows
  float acc[D / 2], sa[kBK / 2], sb[kBK / 2];   // sa, sb: S of two tiles
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sa[i] = sb[i] = 0.f;
  int tg = 0, it = 0;              // the ring's tile count and the item count
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++it) {
    int h, b, q0, n_tiles;
    item(i, h, b, q0, n_tiles);
    const int wg_row = q0 + 64 * wg;
    const int r0 = wg_row + 16 * warp + (lane >> 2);
    int my_tiles = 0;              // key tiles this warpgroup's rows see
    if (wg_row < Sq) {
      int my_end = Sk;
      if (causal) my_end = min(Sk, q_offset + min(wg_row + 64, Sq));
      my_tiles = (my_end + kBK - 1) / kBK;
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    // running max of the raw scores (log2 e / sqrt(D) applied in the
    // exponent) and this thread's share of the running sum, for rows r0
    // and r0 + 8
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    auto stage = [&](int t) { return (tg + t) % kStages; };
    auto parity = [&](int t) { return ((tg + t) / kStages) & 1; };

    // issues S = q k^T of tile t into s (one commit group)
    auto issue_s = [&](float (&s)[kBK / 2], int t) {
      const uint32_t tk = sk + stage(t) * G::kTileBytes;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = 16 * kk;
        wgmma_ss<T>(s,
                    desc(qa + (col / G::kCols) * G::kQPanel + (col % G::kCols) * 2, 16,
                         G::kAtom, G::kLayout),
                    desc(tk + (col / G::kCols) * G::kKPanel + (col % G::kCols) * 2, 16,
                         G::kAtom, G::kLayout),
                    kk > 0);
      }
      wgmma_commit();
    };

    // Tile t, whose S is in cur. With `more`, S of tile t + 1 is already
    // in flight into nxt and is waited for at the end, so it runs during
    // this tile's softmax; P.V of tile t runs during the next tile's
    // softmax.
    auto step = [&](float (&cur)[kBK / 2], float (&nxt)[kBK / 2], int t, bool more) {
      const int k0 = t * kBK;
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q_offset + wg_row);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = k0 + 8 * j + 2 * c + (e & 1);
            if (key >= Sk || (causal && q_offset + r0 + 8 * (e >> 1) < key))
              cur[4 * j + e] = kNegInf;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], cur[4 * j + e]);
        }
      float corr[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2_ftz((m[r] - m_new) * scale_log2);
        m[r] = m_new;
        ms[r] = m_new * scale_log2;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        const float p = exp2_ftz(fmaf(cur[j], scale_log2, -ms[(j >> 1) & 1]));
        cur[j] = p;
        l[(j >> 1) & 1] += p;
      }
      uint32_t a_hi[kBK / 16][4], a_lo[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(cur[8 * kk + 2 * r], cur[8 * kk + 2 * r + 1], a_hi[kk][r], a_lo[kk][r]);

      // tile t - 1's P.V must be done before acc is rescaled (groups
      // complete in order; S of tile t + 1 may still run); then its stage
      // is free
      if (more) wgmma_wait<1>(); else wgmma_wait<0>();
      fence_regs(acc);
      if (t > 0) mbar_arrive(empty(stage(t - 1)));
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j >> 1) & 1];

      // acc += P_hi V + P_lo V over the tile's keys in steps of 16
      const uint32_t tv = sv + stage(t) * G::kTileBytes;
      fence_regs(acc);
      fence_regs(a_hi);
      fence_regs(a_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<T>(acc, a_hi[kk],
                    desc(tv + 16 * kk * G::kRowBytes, G::kKPanel, G::kAtom, G::kLayout));
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<T>(acc, a_lo[kk],
                    desc(tv + 16 * kk * G::kRowBytes, G::kKPanel, G::kAtom, G::kLayout));
      wgmma_commit();
      if (more) {
        wgmma_wait<1>();            // S of tile t + 1
        fence_regs(nxt);
      }
    };

    mbar_wait(qbar, it & 1);
    if (my_tiles > 0) {
      mbar_wait(full(stage(0)), parity(0));
      issue_s(sa, 0);
      wgmma_wait<0>();
      fence_regs(sa);
    }
    // two tiles an iteration, so the S registers swap roles without
    // copies; a stage is waited for just before S of its tile is issued
    auto run = [&](float (&cur)[kBK / 2], float (&nxt)[kBK / 2], int t) {
      const bool more = t + 1 < my_tiles;
      if (more) {
        mbar_wait(full(stage(t + 1)), parity(t + 1));
        issue_s(nxt, t + 1);
      }
      step(cur, nxt, t, more);
    };
    for (int t = 0; t < my_tiles; t += 2) {
      run(sa, sb, t);
      if (t + 1 < my_tiles) run(sb, sa, t + 1);
    }
    mbar_arrive(qempty);           // every S of this item has read q
    if (my_tiles > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(stage(my_tiles - 1)));
    }
    // the item's tiles past this warpgroup's rows: released unread, in order
    for (int t = my_tiles; t < n_tiles; ++t) {
      mbar_wait(full(stage(t)), parity(t));
      mbar_arrive(empty(stage(t)));
    }
    tg += n_tiles;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r0 + 8 * r;
      if (row >= Sq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      if (lse != nullptr && c == 0)
        lse[(static_cast<int64_t>(b) * Hq + h) * Sq + row] =
            m[r] * scale_log2 * kLn2 + logf(den);
      T* out = o + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * c) =
            pack2<T>(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    }
  }
}

// ---- host ---------------------------------------------------------------

struct Strides {
  int64_t b, s, h;              // in elements; 0 for an axis of size 1
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime
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

// a (B, S, H, D) tensor as a 4-D map (D, S, H, B), boxes of one panel by
// `rows` rows; an axis of size 1 gets its contiguous stride (never stepped)
template <typename T, int D>
bool encode(CUtensorMap* map, const void* base, int B, int S, int H, Strides st,
            int rows) {
  using G = Geo<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int64_t e = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(e * (st.s ? st.s : static_cast<int64_t>(H) * D)),
      static_cast<cuuint64_t>(e * (st.h ? st.h : D)),
      static_cast<cuuint64_t>(e * (st.b ? st.b : static_cast<int64_t>(S) * H * D))};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kCols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        D < 64 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, Strides qs, Strides ks,
           Strides vs, int causal, int q_offset, cudaStream_t stream) {
  constexpr int kSmem = Geo<D>::kSmem;
  constexpr int kBQ = Geo<D>::kBQ;
  const int64_t n_items = static_cast<int64_t>((Sq + kBQ - 1) / kBQ) * B * Hq;
  if (n_items > 0x7fffffff) return -3;
  int dev = 0, n_sm = 0;
  // the encoder below is a libcuda call and needs a current context, which
  // a thread that has made no runtime call yet (autograd's, say) lacks:
  // setting the current device makes its primary context current
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap mq, mk, mv;
  if (!encode<T, D>(&mq, q, B, Sq, Hq, qs, kBQ) || !encode<T, D>(&mk, k, B, Sk, Hkv, ks, kBK)
      || !encode<T, D>(&mv, v, B, Sk, Hkv, vs, kBK))
    return -5;
  // above 48 KB a block's dynamic shared memory must be allowed per kernel
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // one block per SM (its shared memory and registers allow no second),
  // each working through its share of the items
  const int grid = static_cast<int>(n_items < n_sm ? n_items : n_sm);
  flash_tc_kernel<T, D><<<grid, Geo<D>::kThreads, kSmem, stream>>>(
      mq, mk, mv, static_cast<T*>(o), lse, B, Sq, Sk, Hq, Hq / Hkv, causal, q_offset,
      kLog2e / sqrtf(static_cast<float>(D)));
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


// q: (B, Sq, Hq, D), k and v: (B, Sk, Hkv, D), f16 (`dtype` 1) or bf16 (2),
// each with the given batch, sequence and head strides (elements; 0 for an
// axis of size 1) and a contiguous last axis, bases and strides 16-byte
// aligned; o: (B, Sq, Hq, D) contiguous; lse: null, or (B, Hq, Sq) f32 for
// each row's log-sum-exp. Query row r sits at global position q_offset + r,
// key j at j. Returns 0 on success, else the CUDA error code of the launch,
// -1 for a type other than f16 and bf16, -2 for an unsupported D, -3 for a
// grid too large, -5 when a TMA tensor map cannot be encoded.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int causal, int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 1: return dispatch_dim<__half>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, causal, q_offset, s);
    case 2: return dispatch_dim<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, causal, q_offset, s);
    default: return -1;
  }
}
