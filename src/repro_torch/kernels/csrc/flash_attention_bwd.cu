// Flash attention backward: dq, dk, dv of flash_attention.cu's forward,
// for its masks (causal with queries aligned to the end of the keys, a
// sliding window, any Lq <= Lk, GQA), bf16 or f32, D in {32, 64, 128}.
//
// The TPU package has no backward kernel: repro/train differentiates the
// jnp attention (repro/models/layers.py:_sdpa_chunked) with jax.grad.  This
// is FlashAttention-2's backward, in three launches on the caller's stream:
//
//   1. flash_bwd_dot: dsum_i = rowsum(dO_i ∘ O_i), one warp a row (f32).
//   2. flash_bwd_dkdv: one block of 64 keys of one kv head walks the query
//      tiles that see them, for each query head of its GQA group, and
//      recomputes P = exp(scale·QKᵀ - lse) from the forward's per-row
//      log-sum-exp: dV += Pᵀ dO, dS = P ∘ (dO Vᵀ - dsum), dK += dSᵀ Q.  The
//      group's heads are summed in registers, so no float atomics.
//   3. flash_bwd_dq: one block of 64 queries of one head walks the key tiles
//      it sees (the forward's loop bounds): dQ += dS K.
//
// Every result is written once by one thread, in a fixed order: a replay
// is bit for bit the same.  A row that sees no key has lse = +inf, so its
// P is 0 and it contributes nothing (its output was 0).  Tiles past Lq or
// Lk load as zero and are masked, not padded.  Tensors are read through
// (batch, head, position) strides, so the model's [B, L, H, D] layout is
// used as it is; dq, dk, dv are written through strides too.
//
// bf16 (tensor cores, mma.sync m16n8k16, f32 accumulators): the four warps
// of a block own 16 rows each.  Products whose operands are inputs (QKᵀ,
// dO Vᵀ) are exact in f32.  P and dS are f32 and enter a product as an A
// operand through shared memory as hi + lo bf16 parts (x = bf16(x) +
// bf16(x - bf16(x)), as the forward's P·V does), so every product keeps
// about f32's accuracy and the kernel matches its plain f32 version to the
// final rounding of dq, dk, dv.  That is 1.5 times the nominal tensor-core
// work of those products.  f32: the same blocks with scalar fmaf products,
// each lane computing the same fragment positions an mma would.
//
// What bounds it on an H100: at the training shape (B = 4, H = 32,
// L = 4,096, D = 64, bf16, causal) the function needs 10·D flops a visible
// query-key pair (S, dP, dV, dK, dQ: 2.5 times the forward's 4·D), 687
// GFLOP, 0.69 ms at 989 TFLOP/s; its bytes (q, k, v, o, dO read, dq, dk,
// dv written, lse) are 0.47 GB, 0.14 ms at 3.35 TB/s: operations.  This
// first kernel recomputes S and dP in both walks (14·D a pair) and splits
// P and dS (3 more products of 2·D), about twice the bound's work, loads
// fragments with plain shared-memory loads rather than ldmatrix, and does
// not overlap loads with products (no cp.async, TMA or wgmma).
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::Strides;
using repro::to_f;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kRows = 64;       // keys of a dk/dv block, queries of a dq block
constexpr int kKeys = 64;       // keys a dq step takes

struct BwdParams {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;             // [B·Hq, Lq], from the forward
  float* dsum;                  // [B·Hq, Lq], written by flash_bwd_dot
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int Hq, Hkv, G, Lq, Lk, causal, window;   // window <= 0: none
  float scale;
  int vec;                      // q, k, v, dO rows 16-byte aligned
};

// shared-memory row padding (elements): 16 bytes, so fragment loads of
// eight rows hit distinct banks and rows stay 16-byte aligned
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }

template <int D>
__host__ __device__ constexpr int q_step() { return D == 128 ? 32 : 64; }

template <typename T, int D>
constexpr size_t smem_dkdv() {
  constexpr int BR = q_step<D>(), LD = D + pad<T>(), LP = BR + pad<T>();
  constexpr int NP = sizeof(T) == 2 ? 2 : 1;   // hi and lo parts in bf16
  return sizeof(T) * (2 * kRows * LD + 2 * BR * LD) + sizeof(float) * 2 * BR +
         sizeof(T) * NP * kRows * LP;
}

template <typename T, int D>
constexpr size_t smem_dq() {
  constexpr int LD = D + pad<T>(), LP = kKeys + pad<T>();
  constexpr int NP = sizeof(T) == 2 ? 2 : 1;
  return sizeof(T) * (2 * kRows * LD + 2 * kKeys * LD) +
         sizeof(T) * NP * kRows * LP;
}

// rows [0, rows) of a matrix with D columns (row r at src + (r0 + r)·sl)
// into dst[r·ld + d]; rows at or past n as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t sl, int r0, int rows, int n,
                                          bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), DV = D / V;
    for (int i = threadIdx.x; i < rows * DV; i += kThreads) {
      const int r = i / DV, d = (i - r * DV) * V;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n)
        x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * sl + d);
      *reinterpret_cast<uint4*>(dst + r * ld + d) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      dst[r * ld + d] =
          r0 + r < n ? src[(int64_t)(r0 + r) * sl + d] : from_f<T>(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c[j] += A·B over this warp's 16 x 8·NT tile, k in [0, K): A(m, k) =
// a[m·lda + k] for the warp's rows m in [0, 16); B(k, n) = b[n·ldb + k]
// (NK) or b[k·ldb + n].  Lane (g, t) = (lane / 4, lane % 4) holds c[j] at
// rows g, g + 8 and columns 8j + 2t, 8j + 2t + 1, as mma's accumulators.
template <bool NK, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const bf16* a,
                                          int lda, const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* pa = a + g * lda + k0 + 2 * t;
    const uint32_t af[4] = {ld32(pa), ld32(pa + 8 * lda), ld32(pa + 8),
                            ld32(pa + 8 * lda + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bfr[2];
      if constexpr (NK) {
        const bf16* pb = b + (8 * j + g) * ldb + k0 + 2 * t;
        bfr[0] = ld32(pb);
        bfr[1] = ld32(pb + 8);
      } else {
        const bf16* pb = b + (k0 + 2 * t) * ldb + 8 * j + g;
        bfr[0] = pack2(pb[0], pb[ldb]);
        bfr[1] = pack2(pb[8 * ldb], pb[9 * ldb]);
      }
      repro::mma_bf16(c[j], af, bfr);
    }
  }
}

// the same product in f32 with scalar fmaf, same fragment positions
template <bool NK, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const float* a,
                                          int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * lda + k], a1 = a[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
      const float b0 = NK ? b[n * ldb + k] : b[k * ldb + n];
      const float b1 = NK ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

// P or dS (f32 fragments) in shared memory as the A operand of a product:
// hi and lo bf16 parts, or one f32 copy
template <typename T>
struct PBuf;

template <>
struct PBuf<bf16> {
  bf16 *hi, *lo;
  __device__ PBuf(void* base, int n)
      : hi(static_cast<bf16*>(base)), lo(static_cast<bf16*>(base) + n) {}
  __device__ __forceinline__ void put(int i, float x0, float x1) const {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    *reinterpret_cast<__nv_bfloat162*>(hi + i) = h;
    *reinterpret_cast<__nv_bfloat162*>(lo + i) =
        __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  }
  // c += this[row0 .. row0 + 16, 0 .. K) · B, B(k, n) = b[k·ldb + n]
  template <int NT, int K>
  __device__ __forceinline__ void gemm(float (&c)[NT][4], int row0, int ld,
                                       const bf16* b, int ldb) const {
    warp_gemm<false, NT, K>(c, hi + row0 * ld, ld, b, ldb);
    warp_gemm<false, NT, K>(c, lo + row0 * ld, ld, b, ldb);
  }
};

template <>
struct PBuf<float> {
  float* p;
  __device__ PBuf(void* base, int) : p(static_cast<float*>(base)) {}
  __device__ __forceinline__ void put(int i, float x0, float x1) const {
    *reinterpret_cast<float2*>(p + i) = make_float2(x0, x1);
  }
  template <int NT, int K>
  __device__ __forceinline__ void gemm(float (&c)[NT][4], int row0, int ld,
                                       const float* b, int ldb) const {
    warp_gemm<false, NT, K>(c, p + row0 * ld, ld, b, ldb);
  }
};

__device__ __forceinline__ void store2(bf16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}

__device__ __forceinline__ bool visible(const BwdParams& p, int qpos,
                                        int kpos) {
  return kpos < p.Lk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

template <typename T, int D>
__global__ void flash_bwd_dot(const BwdParams p, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / p.Lq, qi = row - bh * p.Lq;
  const int bi = bh / p.Hq, h = bh - bi * p.Hq;
  const T* o = static_cast<const T*>(p.o) + bi * p.so.b + h * p.so.h +
               (int64_t)qi * p.so.l;
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo.b +
                  h * p.sdo.h + (int64_t)qi * p.sdo.l;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(o[d]), to_f(dout[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) p.dsum[row] = acc;
}

// One block: 64 keys of kv head hk; warp w owns keys 16w .. 16w + 15.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const BwdParams p) {
  constexpr int BR = q_step<D>(), NQ = BR / 8, ND = D / 8;
  constexpr int LD = D + pad<T>(), LP = BR + pad<T>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);      // [64][LD]
  T* Vs = Ks + kRows * LD;                      // [64][LD]
  T* Qs = Vs + kRows * LD;                      // [BR][LD]
  T* dOs = Qs + BR * LD;                        // [BR][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + BR * LD);
  float* dsum_s = lse_s + BR;
  const PBuf<T> pb(dsum_s + BR, kRows * LP);    // [64][LP] each part

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const int bh = blockIdx.y, bi = bh / p.Hkv, hk = bh - bi * p.Hkv;
  const int k0 = blockIdx.x * kRows, off = p.Lk - p.Lq;
  load_tile<T, D>(Ks, LD, static_cast<const T*>(p.k) + bi * p.sk.b +
                  hk * p.sk.h, p.sk.l, k0, kRows, p.Lk, p.vec);
  load_tile<T, D>(Vs, LD, static_cast<const T*>(p.v) + bi * p.sv.b +
                  hk * p.sv.h, p.sv.l, k0, kRows, p.Lk, p.vec);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // the queries that see a key of this tile: qpos >= k0 (causal) and
  // qpos < k_last + window
  const int k_last = min(k0 + kRows, p.Lk) - 1;
  int q_lo = p.causal ? max(0, k0 - off) : 0;
  const int q_hi = p.window > 0 ? min(p.Lq, k_last + p.window - off) : p.Lq;
  q_lo = (q_lo / BR) * BR;

  for (int gi = 0; gi < p.G; ++gi) {
    const int hq = hk * p.G + gi;
    const T* q = static_cast<const T*>(p.q) + bi * p.sq.b + hq * p.sq.h;
    const T* dout =
        static_cast<const T*>(p.dout) + bi * p.sdo.b + hq * p.sdo.h;
    const int64_t row_base = (int64_t)(bi * p.Hq + hq) * p.Lq;
    for (int qt = q_lo; qt < q_hi; qt += BR) {
      __syncthreads();           // the last step's readers are done
      load_tile<T, D>(Qs, LD, q, p.sq.l, qt, BR, p.Lq, p.vec);
      load_tile<T, D>(dOs, LD, dout, p.sdo.l, qt, BR, p.Lq, p.vec);
      for (int i = threadIdx.x; i < BR; i += kThreads) {
        const bool in = qt + i < p.Lq;
        lse_s[i] = in ? p.lse[row_base + qt + i] : INFINITY;
        dsum_s[i] = in ? p.dsum[row_base + qt + i] : 0.f;
      }
      __syncthreads();

      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      warp_gemm<true, NQ, D>(s, Ks + r0 * LD, LD, Qs, LD);    // S = K Qᵀ
      warp_gemm<true, NQ, D>(dp, Vs + r0 * LD, LD, dOs, LD);  // dP = V dOᵀ
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const int kpos = k0 + r0 + g + 8 * (e >> 1);
          const bool ok = qt + qi < p.Lq && visible(p, qt + qi + off, kpos);
          const float pv = ok ? expf(fmaf(s[j][e], p.scale, -lse_s[qi])) : 0.f;
          s[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dsum_s[qi]);
        }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        pb.put((r0 + g) * LP + 8 * j + 2 * t, s[j][0], s[j][1]);
        pb.put((r0 + g + 8) * LP + 8 * j + 2 * t, s[j][2], s[j][3]);
      }
      __syncwarp();
      pb.template gemm<ND, BR>(dv, r0, LP, dOs, LD);         // dV += Pᵀ dO
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        pb.put((r0 + g) * LP + 8 * j + 2 * t, dp[j][0], dp[j][1]);
        pb.put((r0 + g + 8) * LP + 8 * j + 2 * t, dp[j][2], dp[j][3]);
      }
      __syncwarp();
      pb.template gemm<ND, BR>(dk, r0, LP, Qs, LD);          // dK += dSᵀ Q
    }
  }

  T* dkp = static_cast<T*>(p.dk) + bi * p.sdk.b + hk * p.sdk.h;
  T* dvp = static_cast<T*>(p.dv) + bi * p.sdv.b + hk * p.sdv.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = k0 + r0 + g + 8 * rr;
    if (row >= p.Lk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      store2(dkp + (int64_t)row * p.sdk.l + 8 * j + 2 * t,
             dk[j][2 * rr] * p.scale, dk[j][2 * rr + 1] * p.scale);
      store2(dvp + (int64_t)row * p.sdv.l + 8 * j + 2 * t, dv[j][2 * rr],
             dv[j][2 * rr + 1]);
    }
  }
}

// One block: 64 queries of query head hq; warp w owns queries 16w .. +15.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const BwdParams p) {
  constexpr int NK = kKeys / 8, ND = D / 8;
  constexpr int LD = D + pad<T>(), LP = kKeys + pad<T>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);      // [64][LD]
  T* dOs = Qs + kRows * LD;                     // [64][LD]
  T* Ks = dOs + kRows * LD;                     // [kKeys][LD]
  T* Vs = Ks + kKeys * LD;                      // [kKeys][LD]
  const PBuf<T> pb(Vs + kKeys * LD, kRows * LP);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const int bh = blockIdx.y, bi = bh / p.Hq, hq = bh - bi * p.Hq;
  const int hk = hq / p.G;
  // heavy (late) causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int off = p.Lk - p.Lq;
  load_tile<T, D>(Qs, LD, static_cast<const T*>(p.q) + bi * p.sq.b +
                  hq * p.sq.h, p.sq.l, q0, kRows, p.Lq, p.vec);
  load_tile<T, D>(dOs, LD, static_cast<const T*>(p.dout) + bi * p.sdo.b +
                  hq * p.sdo.h, p.sdo.l, q0, kRows, p.Lq, p.vec);
  const T* k = static_cast<const T*>(p.k) + bi * p.sk.b + hk * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + bi * p.sv.b + hk * p.sv.h;
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + g + 8 * rr;
    const int64_t i = (int64_t)bh * p.Lq + row;
    lse_r[rr] = row < p.Lq ? p.lse[i] : INFINITY;
    dsum_r[rr] = row < p.Lq ? p.dsum[i] : 0.f;
  }

  const int q_first = q0 + off, q_last = min(q0 + kRows, p.Lq) - 1 + off;
  int k_end = p.Lk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / kKeys) * kKeys;

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();             // Q, dO loaded; the last step's readers done
    load_tile<T, D>(Ks, LD, k, p.sk.l, kt, kKeys, p.Lk, p.vec);
    load_tile<T, D>(Vs, LD, v, p.sv.l, kt, kKeys, p.Lk, p.vec);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_gemm<true, NK, D>(s, Qs + r0 * LD, LD, Ks, LD);     // S = Q Kᵀ
    warp_gemm<true, NK, D>(dp, dOs + r0 * LD, LD, Vs, LD);   // dP = dO Vᵀ
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, row = q0 + r0 + g + 8 * rr;
        const int kpos = kt + 8 * j + 2 * t + (e & 1);
        const bool ok = row < p.Lq && visible(p, row + off, kpos);
        const float pv =
            ok ? expf(fmaf(s[j][e], p.scale, -lse_r[rr])) : 0.f;
        dp[j][e] = pv * (dp[j][e] - dsum_r[rr]);
      }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      pb.put((r0 + g) * LP + 8 * j + 2 * t, dp[j][0], dp[j][1]);
      pb.put((r0 + g + 8) * LP + 8 * j + 2 * t, dp[j][2], dp[j][3]);
    }
    __syncwarp();
    pb.template gemm<ND, kKeys>(dq, r0, LP, Ks, LD);         // dQ += dS K
  }

  T* dqp = static_cast<T*>(p.dq) + bi * p.sdq.b + hq * p.sdq.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + g + 8 * rr;
    if (row >= p.Lq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2(dqp + (int64_t)row * p.sdq.l + 8 * j + 2 * t,
             dq[j][2 * rr] * p.scale, dq[j][2 * rr + 1] * p.scale);
  }
}

template <typename T, int D>
int launch(const BwdParams& p, int B, cudaStream_t stream) {
  const int rows = B * p.Hq * p.Lq;
  flash_bwd_dot<T, D><<<(rows + 7) / 8, 256, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t s1 = smem_dkdv<T, D>(), s2 = smem_dq<T, D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, D><<<dim3((p.Lk + kRows - 1) / kRows, B * p.Hkv),
                         kThreads, s1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<T, D><<<dim3((p.Lq + kRows - 1) / kRows, B * p.Hq), kThreads,
                       s2, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const BwdParams& p, int D, int B, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, s);
    case 64: return launch<T, 64>(p, B, s);
    case 128: return launch<T, 128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* ptr, const int64_t* st, int v) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % v == 0 &&
         st[1] % v == 0 && st[2] % v == 0;
}

}  // namespace

// Gradients of o = attention(q, k, v) given dout = dL/do.  q, o, dout, dq:
// [B, Hq, Lq, D]; k, v, dk, dv: [B, Hkv, Lk, D]; all bf16 (is_bf16 = 1) or
// all f32, each read or written through strides[24] = the (batch, head,
// position) element strides of q, k, v, o, dout, dq, dk, dv in that order,
// the head dim contiguous; dq, dk, dv rows 8-byte aligned.  lse [B·Hq, Lq]
// f32 is the forward's output; dsum [B·Hq, Lq] f32 is the caller's
// scratch.  D in {32, 64, 128}; window <= 0 means none.  Three launches;
// returns the first CUDA error, 0 on success.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dsum, void* dq, void* dk,
    void* dv, int is_bf16, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, int window, const int64_t* st, void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0 || Lk <= 0) return 0;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.dsum = dsum;
  p.sq = {st[0], st[1], st[2]};
  p.sk = {st[3], st[4], st[5]};
  p.sv = {st[6], st[7], st[8]};
  p.so = {st[9], st[10], st[11]};
  p.sdo = {st[12], st[13], st[14]};
  p.sdq = {st[15], st[16], st[17]};
  p.sdk = {st[18], st[19], st[20]};
  p.sdv = {st[21], st[22], st[23]};
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.window = window;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  const int v16 = is_bf16 ? 8 : 4;      // elements in 16 bytes
  p.vec = aligned(q, st, v16) && aligned(k, st + 3, v16) &&
          aligned(v, st + 6, v16) && aligned(dout, st + 12, v16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(p, D, B, s) : dispatch<float>(p, D, B, s);
}
