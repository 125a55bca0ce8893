// wkv6, the RWKV-6 time-mix recurrence, forward, chunked, all arithmetic f32.
//
// Replaces wkv6_pallas (src/repro/kernels/wkv6.py:65) and computes what its
// _wkv_kernel computes, per head with a (K x K) state S and w_t = e^{logw_t}:
//   y_t = r_t (diag(u) k_t^T v_t + S_{t-1});  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// in chunks of 16 rows. Within a chunk, with L the cumulative sum of logw
// from the chunk's start (L_incl includes row t, L_excl = L_incl - logw):
//   r_f = r e^{L_excl},  k_f = k e^{-L_incl}
//   y   = tril(r_f k_f^T, -1) v + (r u k^T)_tt v_t + r_f S_prev
//   S   = diag(e^{L_end}) S_prev + (k e^{L_end - L_incl})^T v
// The exponents reach +-80 only because logw >= LOG_W_MIN = -5 and a chunk
// has at most 16 rows (src/repro/models/rwkv6.py:32-36); this kernel keeps
// that contract and never enlarges the chunk.
//
// The Pallas kernel walks a sequential grid (batch x head, chunk) and carries
// S from one chunk to the next in VMEM scratch. Blocks on Hopper run in
// parallel and in no order, so here a loop over the chunks inside one block
// takes the place of the sequential axis, with S in shared memory. Value
// column w of the state is independent of the others (y[:, w] needs only
// S[:, w] and v[:, w]), so one block owns (batch, head, 16 of the 64 value
// columns): 4 B H blocks, 640 at rwkv6-3b's B=4, H=40, where 160 (batch,
// head) blocks would fill the 132 SMs only 1.2 times. Each of a head's four
// blocks computes the chunk's 16 x 16 scores itself. What else differs from
// the Pallas kernel, and why:
//   - State in and out. The Pallas kernel starts from zero and returns no
//     state; serving needs both, so the kernel reads s0 (or zero when it is
//     null) and writes the final state. A block reads its part of the state
//     before it writes it and no other block touches it, so s_fin may be s0
//     itself (the layer's cache, updated in place).
//   - Ragged S. The last chunk may be shorter; its rows past S are zero in
//     shared memory and never read from or written to device memory, and
//     the decay to the chunk's end is that of its last valid row. S = 1 (a
//     decode step) is one chunk of one row. The Pallas kernel asserts
//     S % 16 == 0.
//   - Layout. r, k, v and logw are read in place through their (B, S, H, K)
//     batch, sequence and head strides (the last axis contiguous), where
//     wkv6_pallas copies them to (B H, S, K) first. y is written as
//     (B, S, H, K) f32, contiguous.
//   - Types. r, k and v are f32, f16 or bf16, widened to f32 as they are
//     loaded; logw, u, y and the state are f32. No atomics: every output has
//     one writer, so a run repeats bit for bit.
//
// Bound: bytes, with operations level. Each input is read once and y and
// the state written once: at B=4, S=1024, H=40, K=64 with bf16 r, k, v that
// is 152 MB, 0.0454 ms at 3.35 TB/s. The products the function needs, per
// chunk of c rows and head, are the scores' lower triangle with the bonus
// on its diagonal and their product with v (c (c+1)/2 dot products of K
// each), then r_f S_prev and k^T v (c x K x K each): 3.04 GFLOP there,
// 0.0454 ms at the 67 TFLOP/s f32 rate of the CUDA cores (the exps and the
// state's decay add about 4%). So without tensor cores this kernel cannot
// go below about 0.045 ms. A decode step (S = 1) moves the 5.2 MB of state
// in and out (bytes bound it, 0.0016 ms); its launch latency dominates.
//
// Threads: 128 per block. Per chunk: (A) all threads load the chunk's r, k,
// logw rows (16 x 64) and v's 16 x 16 slice into shared memory as f32; (B)
// thread c < 64 walks column c down the rows for the cumulative sums and
// forms r_f, k_f, the decay to the end and r u k; (C) each thread forms two
// of the 16 x 16 scores, the diagonal holding the bonus sum; (D) each thread
// forms two of the chunk's 16 x 16 outputs and stores them; (E) each thread
// decays and updates eight of the 64 x 16 state entries. Rows of the
// 16 x 64 arrays are padded to 65 floats, so the 16 different rows read in
// (C) fall in different banks.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kK = 64;          // head size (HEAD_K)
constexpr int kC = 16;          // rows per chunk (WKV_CHUNK)
constexpr int kW = 16;          // value columns a block owns
constexpr int kThreads = 128;
constexpr int kLd = kK + 1;     // padded row stride of the 16 x 64 arrays
constexpr int kLdA = kC + 1;    // padded row stride of the scores

struct Strides {
  int64_t b, s, h;              // in elements; the last axis is contiguous
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* s_fin, int S, int H, Strides rs,
            Strides ks, Strides vs, Strides ws) {
  __shared__ float s_r[kC * kLd];     // r, then r_f
  __shared__ float s_k[kC * kLd];     // k, then k_f
  __shared__ float s_lw[kC * kLd];    // logw
  __shared__ float s_kd[kC * kLd];    // k e^{L_end - L_incl}
  __shared__ float s_b[kC * kLd];     // r u k, summed over a row for the bonus
  __shared__ float s_v[kC * kW];      // v's columns of this block
  __shared__ float s_a[kC * kLdA];    // scores, the bonus on the diagonal
  __shared__ float s_st[kK * kW];     // the state's columns of this block
  __shared__ float s_dec[kK];         // e^{L_end}
  __shared__ float s_u[kK];

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kW;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h + col0;
  const float* wb = logw + b * ws.b + h * ws.h;
  const int64_t st_base = (static_cast<int64_t>(b) * H + h) * kK * kK + col0;

  if (tid < kK) s_u[tid] = u[h * kK + tid];
  for (int e = tid; e < kK * kW; e += kThreads) {
    const int c = e / kW, w = e % kW;
    s_st[e] = s0 == nullptr ? 0.f : s0[st_base + c * kK + w];
  }

  for (int t0 = 0; t0 < S; t0 += kC) {
    const int n = min(kC, S - t0);  // valid rows of this chunk
    __syncthreads();                // the last chunk's arrays are read

    // (A) load; rows at or past n are zero and read nothing
    for (int e = tid; e < kC * kK; e += kThreads) {
      const int t = e / kK, c = e % kK;
      float rv = 0.f, kv = 0.f, lv = 0.f;
      if (t < n) {
        const int64_t pos = t0 + t;
        rv = to_f32(rb[pos * rs.s + c]);
        kv = to_f32(kb[pos * ks.s + c]);
        lv = wb[pos * ws.s + c];
      }
      s_r[t * kLd + c] = rv;
      s_k[t * kLd + c] = kv;
      s_lw[t * kLd + c] = lv;
    }
    for (int e = tid; e < kC * kW; e += kThreads) {
      const int t = e / kW, w = e % kW;
      s_v[e] = t < n ? to_f32(vb[static_cast<int64_t>(t0 + t) * vs.s + w]) : 0.f;
    }
    __syncthreads();

    // (B) column c: cumulative log decay and the factors built on it
    if (tid < kK) {
      const int c = tid;
      const float uc = s_u[c];
      float cum[kC], kv[kC];
      float acc = 0.f, last = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float excl = acc;
        acc += s_lw[t * kLd + c];
        cum[t] = acc;
        if (t == n - 1) last = acc;   // the last valid row's, not row 15's
        const float rv = s_r[t * kLd + c];
        kv[t] = s_k[t * kLd + c];
        s_b[t * kLd + c] = rv * uc * kv[t];
        s_r[t * kLd + c] = rv * expf(excl);
        s_k[t * kLd + c] = kv[t] * expf(-acc);
      }
#pragma unroll
      for (int t = 0; t < kC; ++t) s_kd[t * kLd + c] = kv[t] * expf(last - cum[t]);
      s_dec[c] = expf(last);
    }
    __syncthreads();

    // (C) scores: strictly lower r_f k_f^T, and the bonus r_t . (u k_t) on
    // the diagonal
    for (int e = tid; e < kC * kC; e += kThreads) {
      const int t = e / kC, j = e % kC;
      float a = 0.f;
      if (j < t) {
#pragma unroll 16
        for (int c = 0; c < kK; ++c) a = fmaf(s_r[t * kLd + c], s_k[j * kLd + c], a);
      } else if (j == t) {
#pragma unroll 16
        for (int c = 0; c < kK; ++c) a += s_b[t * kLd + c];
      }
      s_a[t * kLdA + j] = a;
    }
    __syncthreads();

    // (D) y = scores v + r_f S_prev, for this block's columns
    for (int e = tid; e < kC * kW; e += kThreads) {
      const int t = e / kW, w = e % kW;
      float a = 0.f;
      for (int j = 0; j <= t; ++j) a = fmaf(s_a[t * kLdA + j], s_v[j * kW + w], a);
#pragma unroll 16
      for (int c = 0; c < kK; ++c) a = fmaf(s_r[t * kLd + c], s_st[c * kW + w], a);
      if (t < n)
        y[((static_cast<int64_t>(b) * S + t0 + t) * H + h) * kK + col0 + w] = a;
    }
    __syncthreads();

    // (E) S = diag(e^{L_end}) S_prev + (k e^{L_end - L_incl})^T v
    for (int e = tid; e < kK * kW; e += kThreads) {
      const int c = e / kW, w = e % kW;
      float a = s_st[e] * s_dec[c];
#pragma unroll
      for (int j = 0; j < kC; ++j) a = fmaf(s_kd[j * kLd + c], s_v[j * kW + w], a);
      s_st[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < kK * kW; e += kThreads) {
    const int c = e / kW, w = e % kW;
    s_fin[st_base + c * kK + w] = s_st[e];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* y, float* s_fin, int B,
           int S, int H, Strides rs, Strides ks, Strides vs, Strides ws,
           cudaStream_t stream) {
  const dim3 grid(kK / kW, H, B);
  wkv6_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, y, s_fin, S, H, rs, ks, vs, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, 64) of type `dtype`, logw: (B, S, H, 64) f32, each
// with the given batch, sequence and head strides (elements) and a
// contiguous last axis; u: (H, 64) f32; s0: (B, H, 64, 64) f32 or null for
// a zero state; y: (B, S, H, 64) f32 and s_fin: (B, H, 64, 64) f32, both
// contiguous (s_fin may be s0). Returns 0 on success, else the CUDA error
// code of the launch, or -1 for an unknown type code.
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
