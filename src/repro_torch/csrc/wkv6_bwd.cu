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
// version, ref.wkv6_bwd_ref, writes out the same algebra.
//
// Bound. At rwkv6-3b's training shape (B 4, S 1024, H 40, K 64, bf16 r, k,
// v): r, k, v and dr, dk, dv (bf16), logw, dy and dlogw (f32) are each
// moved once, 251.7 MB, 0.0751 ms at 3.35 TB/s. The products the function
// needs, per chunk of C rows and head: five of C x K x K multiply-adds (the
// state's recompute k^T v, since the forward keeps no state; the reverse
// walk's r_f^T dy; v G^T; kd G; dy S_prev^T), three over the scores'
// lower triangle with its diagonal (A with the bonus, dA with dy . v, A^T
// dy) and two over the strict triangle (dA k_f, dA^T r_f), each triangle
// entry K multiply-adds: 7.56 GFLOP there, 0.113 ms at the 67 TFLOP/s f32
// rate of the CUDA cores. So operations bound it. chip_smoke.py phase 15
// counts both for the shape it times.
//
// Design: simple and right first; making it fast is later work (PERF.md).
//   - One block of 256 threads per (batch, head), grid (H, B).
//   - Pass 1 walks the chunks forward and writes the state at each chunk's
//     start into a scratch the wrapper allocates (B H ceil(S/16) x 16 KB),
//     each thread holding 16 of the state's elements in registers.
//   - Pass 2 walks the chunks in reverse with G (64 x 64 f32) in shared
//     memory. Per chunk: the rows (zero past S) to shared memory; the
//     cumulative sums and exponentials, one thread a column; the scores and
//     their gradient, one thread an entry; dr, dk (a thread a column and
//     four rows) and dv (a value column and four rows), the sums over the
//     state's 64 columns from shared memory; then the dlogw scan and the
//     update of G.
//   - All arithmetic f32 on the CUDA cores. Rows of 16 x 64 tiles are 68
//     floats apart so that 16-byte reads of eight neighbouring rows fall in
//     distinct banks; G and the state are 65 apart for column reads.
//   - No atomics: every output has one writer and every sum a fixed order.
//     du leaves each block as a (batch, head) partial; a second kernel sums
//     the partials over the batch in order b = 0, 1, ... So a run repeats
//     bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kK = 64;          // head size
constexpr int kC = 16;          // rows per chunk
constexpr int kThreads = 256;
constexpr int kR = 68;          // row stride of a 16 x 64 tile, floats
constexpr int kS = 65;          // row stride of a 64 x 64 state, floats
constexpr int kTile = kC * kR;

// shared memory, in floats
constexpr int oG = 0;                       // gradient of the state after the chunk
constexpr int oSP = oG + kK * kS;           // the state before the chunk
constexpr int oT = oSP + kK * kS;           // 16 x 64 tiles, below
enum Tile { LW, R, KK, V, DY, RF, KF, KD, EE, EI, EKD, kTiles };
// LW holds logw, then L_incl, then dL_incl and its reverse cumulative sum
constexpr int oA = oT + kTiles * kTile;     // A [16][17]
constexpr int oDA = oA + kC * 17;           // dA [16][17]
constexpr int oBON = oDA + kC * 17;         // r u k of each row
constexpr int oDBON = oBON + kC;            // dy . v of each row
constexpr int oDEC = oDBON + kC;            // e^{L_end}
constexpr int oU = oDEC + kK;
constexpr int oLSG = oU + kK;               // sum_w S_prev G, per state row
constexpr int oLPART = oLSG + kK;           // sum_j dkd kd, four row groups
constexpr int oDUP = oLPART + 4 * kK;       // du, four row groups
constexpr int kSmemFloats = oDUP + 4 * kK;
constexpr int kSmemBytes = kSmemFloats * 4;

struct Strides {
  int64_t b, s, h;
};

struct Args {
  const void *r, *k, *v;
  const float *logw, *u, *s0, *dy, *ds_fin;
  void *dr, *dk, *dv;
  float *dlogw, *du_part, *ds0, *states;
  int B, S, H;
  Strides rs, ks, vs, ws;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The chunk's rows t0 .. t0+15 (zero past S) into the tiles: logw, and
// r, k, v, dy as asked. Element e of a tile is row e / 64, column e % 64.
template <typename T>
__device__ void load_chunk(const Args& a, float* sm, int b, int h, int t0,
                           bool full) {
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int e = threadIdx.x; e < kC * kK; e += kThreads) {
    const int t = e >> 6, c = e & 63, s = t0 + t, o = t * kR + c;
    float fr = 0.f, fk = 0.f, fv = 0.f, fw = 0.f, fd = 0.f;
    if (s < a.S) {
      fk = to_f32(k[b * a.ks.b + s * a.ks.s + h * a.ks.h + c]);
      fv = to_f32(v[b * a.vs.b + s * a.vs.s + h * a.vs.h + c]);
      fw = a.logw[b * a.ws.b + s * a.ws.s + h * a.ws.h + c];
      if (full) {
        fr = to_f32(r[b * a.rs.b + s * a.rs.s + h * a.rs.h + c]);
        fd = a.dy[((static_cast<int64_t>(b) * a.S + s) * a.H + h) * kK + c];
      }
    }
    sm[oT + LW * kTile + o] = fw;
    sm[oT + KK * kTile + o] = fk;
    sm[oT + V * kTile + o] = fv;
    sm[oT + R * kTile + o] = fr;
    sm[oT + DY * kTile + o] = fd;
  }
}

// Threads 0-63, one column each: L_incl (left in LW), e^{L_excl},
// e^{-L_incl}, e^{L_end - L_incl} and e^{L_end}, in the plain version's
// order of operations.
__device__ void scan_chunk(float* sm) {
  const int c = threadIdx.x;
  float* lw = sm + oT + LW * kTile;
  float acc = 0.f;
  for (int t = 0; t < kC; ++t) {
    const float w = lw[t * kR + c];
    acc += w;
    sm[oT + EE * kTile + t * kR + c] = expf(acc - w);
    sm[oT + EI * kTile + t * kR + c] = expf(-acc);
    lw[t * kR + c] = acc;
  }
  sm[oDEC + c] = expf(acc);
  for (int t = 0; t < kC; ++t)
    sm[oT + EKD * kTile + t * kR + c] = expf(acc - lw[t * kR + c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nc = (a.S + kC - 1) / kC;
  const int lane64 = tid & 63, grp = tid >> 6;    // column, row group
  float* tile[kTiles];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) tile[i] = sm + oT + i * kTile;
  float* G = sm + oG;
  float* SP = sm + oSP;
  float* states = a.states + (static_cast<int64_t>(b) * a.H + h) * nc * kK * kK;
  if (tid < kK) sm[oU + tid] = a.u[h * kK + tid];

  // -- pass 1: the state at each chunk's start, into the scratch -----------
  // thread (w = lane64, grp) holds S[c][w] for c = 16 grp + m
  const int w = lane64;
  float s[16];
  const float* s0 = a.s0 ? a.s0 + (static_cast<int64_t>(b) * a.H + h) * kK * kK
                         : nullptr;
#pragma unroll
  for (int m = 0; m < 16; ++m) s[m] = s0 ? s0[(grp * 16 + m) * kK + w] : 0.f;
  for (int n = 0; n < nc; ++n) {
    float* st = states + static_cast<int64_t>(n) * kK * kK;
#pragma unroll
    for (int m = 0; m < 16; ++m) st[(grp * 16 + m) * kK + w] = s[m];
    if (n == nc - 1) break;
    load_chunk<T>(a, sm, b, h, n * kC, false);
    __syncthreads();
    if (tid < kK) scan_chunk(sm);
    __syncthreads();
    for (int e = tid; e < kC * kK; e += kThreads) {
      const int o = (e >> 6) * kR + (e & 63);
      tile[KD][o] = tile[KK][o] * tile[EKD][o];
    }
    __syncthreads();
    float acc[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) acc[m] = 0.f;
    for (int j = 0; j < kC; ++j) {
      const float vj = tile[V][j * kR + w];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 kd = ld4(tile[KD] + j * kR + grp * 16 + 4 * q);
        acc[4 * q] += kd.x * vj;
        acc[4 * q + 1] += kd.y * vj;
        acc[4 * q + 2] += kd.z * vj;
        acc[4 * q + 3] += kd.w * vj;
      }
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) s[m] = s[m] * sm[oDEC + grp * 16 + m] + acc[m];
    __syncthreads();      // the tiles are loaded again next chunk
  }

  // -- pass 2: the chunks in reverse ----------------------------------------
  const float* dsf = a.ds_fin
      ? a.ds_fin + (static_cast<int64_t>(b) * a.H + h) * kK * kK : nullptr;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int c = grp * 16 + m;
    G[c * kS + w] = dsf ? dsf[c * kK + w] : 0.f;
  }
  float du_acc = 0.f;
  T* dr = static_cast<T*>(a.dr);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  for (int n = nc - 1; n >= 0; --n) {
    const int t0 = n * kC;
    const int nv = min(kC, a.S - t0);          // rows of the chunk inside S
    load_chunk<T>(a, sm, b, h, t0, true);
    const float* st = states + static_cast<int64_t>(n) * kK * kK;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int c = grp * 16 + m;
      SP[c * kS + w] = st[c * kK + w];
    }
    __syncthreads();
    if (tid < kK) {
      scan_chunk(sm);
    } else if (tid < kK + kC) {                 // r u k of row t
      const int t = tid - kK;
      float acc = 0.f;
      for (int c = 0; c < kK; ++c)
        acc += tile[R][t * kR + c] * sm[oU + c] * tile[KK][t * kR + c];
      sm[oBON + t] = acc;
    } else if (tid < kK + 2 * kC) {             // dy . v of row t
      const int t = tid - kK - kC;
      float acc = 0.f;
      for (int c = 0; c < kK; ++c) acc += tile[DY][t * kR + c] * tile[V][t * kR + c];
      sm[oDBON + t] = acc;
    }
    __syncthreads();
    for (int e = tid; e < kC * kK; e += kThreads) {
      const int o = (e >> 6) * kR + (e & 63);
      tile[RF][o] = tile[R][o] * tile[EE][o];
      tile[KF][o] = tile[KK][o] * tile[EI][o];
      tile[KD][o] = tile[KK][o] * tile[EKD][o];
    }
    __syncthreads();
    {   // A and dA: thread (t, j), strictly lower
      const int t = tid >> 4, j = tid & 15;
      float sa = 0.f, sd = 0.f;
      if (j < t) {
#pragma unroll 4
        for (int c = 0; c < kK; c += 4) {
          sa += dot4(ld4(tile[RF] + t * kR + c), ld4(tile[KF] + j * kR + c));
          sd += dot4(ld4(tile[DY] + t * kR + c), ld4(tile[V] + j * kR + c));
        }
      }
      sm[oA + t * 17 + j] = sa;
      sm[oDA + t * 17 + j] = sd;
    }
    __syncthreads();

    // dr, dk and the decay's terms: thread (column c, rows 4 grp + i)
    const int c = lane64;
    float drf[4] = {0.f, 0.f, 0.f, 0.f}, dkd[4] = {0.f, 0.f, 0.f, 0.f};
    float dkf[4] = {0.f, 0.f, 0.f, 0.f}, dle[4];
    float lsg = 0.f;
    for (int x = 0; x < kK; x += 4) {
      float sp[4], g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sp[q] = SP[c * kS + x + q];
        g[q] = G[c * kS + x + q];
        lsg += sp[q] * g[q];
      }
      const float4 sp4 = make_float4(sp[0], sp[1], sp[2], sp[3]);
      const float4 g4 = make_float4(g[0], g[1], g[2], g[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * grp + i;
        drf[i] += dot4(ld4(tile[DY] + t * kR + x), sp4);
        dkd[i] += dot4(ld4(tile[V] + t * kR + x), g4);
      }
    }
    for (int j = 0; j < kC; ++j) {
      const float kfj = tile[KF][j * kR + c], rfj = tile[RF][j * kR + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * grp + i;
        drf[i] += sm[oDA + t * 17 + j] * kfj;
        dkf[i] += sm[oDA + j * 17 + t] * rfj;
      }
    }
    float kdsum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * grp + i, o = t * kR + c;
      const float rr = tile[R][o], kk = tile[KK][o], db = sm[oDBON + t];
      const float ub = db * sm[oU + c];
      const float gr = drf[i] * tile[EE][o] + ub * kk;
      const float gk = dkf[i] * tile[EI][o] + dkd[i] * tile[EKD][o] + ub * rr;
      du_acc += db * rr * kk;
      dle[i] = drf[i] * tile[RF][o];
      tile[LW][o] = dle[i] - dkf[i] * tile[KF][o] - dkd[i] * tile[KD][o];
      kdsum += dkd[i] * tile[KD][o];
      if (t < nv) {
        const int64_t go = ((static_cast<int64_t>(b) * a.S + t0 + t) * a.H + h) * kK + c;
        dr[go] = from_f32<T>(gr);
        dk[go] = from_f32<T>(gk);
      }
    }
    sm[oLPART + grp * kK + c] = kdsum;
    if (grp == 0) sm[oLSG + c] = lsg;

    {   // dv: thread (value column w, rows 4 grp + i)
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      for (int x = 0; x < kK; x += 4) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = G[(x + q) * kS + w];
        const float4 g4 = make_float4(g[0], g[1], g[2], g[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] += dot4(ld4(tile[KD] + (4 * grp + i) * kR + x), g4);
      }
      for (int t = 0; t < kC; ++t) {
        const float dyt = tile[DY][t * kR + w];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] += sm[oA + t * 17 + 4 * grp + i] * dyt;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * grp + i;
        gv[i] += sm[oBON + j] * tile[DY][j * kR + w];
        if (j < nv)
          dv[((static_cast<int64_t>(b) * a.S + t0 + j) * a.H + h) * kK + w] =
              from_f32<T>(gv[i]);
      }
    }
    __syncthreads();

    // dL_incl's reverse cumulative sum down each column, dL_end at the
    // last row; then G for the chunk before
    if (tid < kK) {
      float* tot = tile[LW];
      const float lend = sm[oDEC + tid] * sm[oLSG + tid]
          + (((sm[oLPART + tid] + sm[oLPART + kK + tid]) + sm[oLPART + 2 * kK + tid])
             + sm[oLPART + 3 * kK + tid]);
      float run = tot[(kC - 1) * kR + tid] + lend;
      tot[(kC - 1) * kR + tid] = run;
      for (int t = kC - 2; t >= 0; --t) {
        run += tot[t * kR + tid];
        tot[t * kR + tid] = run;
      }
    }
    {
      float acc[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) acc[m] = 0.f;
      for (int t = 0; t < kC; ++t) {
        const float dyt = tile[DY][t * kR + w];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 rf = ld4(tile[RF] + t * kR + grp * 16 + 4 * q);
          acc[4 * q] += rf.x * dyt;
          acc[4 * q + 1] += rf.y * dyt;
          acc[4 * q + 2] += rf.z * dyt;
          acc[4 * q + 3] += rf.w * dyt;
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int cc = grp * 16 + m;
        G[cc * kS + w] = G[cc * kS + w] * sm[oDEC + cc] + acc[m];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * grp + i;
      if (t < nv)
        a.dlogw[((static_cast<int64_t>(b) * a.S + t0 + t) * a.H + h) * kK + c] =
            tile[LW][t * kR + c] - dle[i];
    }
    __syncthreads();      // the tiles are loaded again next chunk
  }

  if (a.ds0) {
    float* out = a.ds0 + (static_cast<int64_t>(b) * a.H + h) * kK * kK;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int c = grp * 16 + m;
      out[c * kK + w] = G[c * kS + w];
    }
  }
  sm[oDUP + grp * kK + lane64] = du_acc;
  __syncthreads();
  if (tid < kK)
    a.du_part[(static_cast<int64_t>(b) * a.H + h) * kK + tid] =
        ((sm[oDUP + tid] + sm[oDUP + kK + tid]) + sm[oDUP + 2 * kK + tid])
        + sm[oDUP + 3 * kK + tid];
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

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  wkv6_bwd_kernel<T><<<dim3(a.H, a.B), kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Gradients of wkv6 (see the header). r, k, v (dtype 0 f32, 1 f16, 2 bf16)
// and logw f32 through their (batch, seq, head) strides, the last axis
// contiguous; u (H, 64), s0 and ds_fin (B, H, 64, 64) f32 (either may be
// null: zero); dy (B, S, H, 64) f32 contiguous. Writes dr, dk, dv (the
// inputs' dtype) and dlogw (f32), all (B, S, H, 64) contiguous; du_part
// (B, H, 64) and du (H, 64) f32; ds0 (B, H, 64, 64) f32 unless null.
// states: scratch of B H ceil(S/16) x 64 x 64 f32. Two launches on
// `stream`: the walk, then the sum of du over the batch.
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
  Args a{r, k, v,
         static_cast<const float*>(logw), static_cast<const float*>(u),
         static_cast<const float*>(s0), static_cast<const float*>(dy),
         static_cast<const float*>(ds_fin), dr, dk, dv,
         static_cast<float*>(dlogw), static_cast<float*>(du_part),
         static_cast<float*>(ds0), static_cast<float*>(states), B, S, H,
         {r_sb, r_ss, r_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
         {w_sb, w_ss, w_sh}};
  int rc;
  switch (dtype) {
    case 0: rc = launch<float>(a, st); break;
    case 1: rc = launch<__half>(a, st); break;
    case 2: rc = launch<__nv_bfloat16>(a, st); break;
    default: return -1;
  }
  if (rc != 0) return rc;
  wkv6_bwd_du_kernel<<<(H * kK + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), B, H);
  return static_cast<int>(cudaGetLastError());
}
