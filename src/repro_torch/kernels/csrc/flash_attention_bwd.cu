// Flash attention backward: dq, dk, dv of flash_attention.cu's forward,
// for its masks (causal with queries aligned to the end of the keys, a
// sliding window, or none), any Lq and Lk (unmasked: the encoder's
// self-attention, cross-attention, Lq > Lk; causal with Lq > Lk: the
// first Lq - Lk rows see no key), GQA, bf16 or f32, D in {32, 64, 128}.
//
// The TPU package has no backward kernel: repro/train differentiates the
// jnp attention (repro/models/layers.py:_sdpa_chunked) with jax.grad.  This
// is FlashAttention's backward, in three launches on the caller's stream,
// on one of two routes the wrapper picks (kernel.py: bwd_tc_route):
//
//   1. flash_bwd_dot: dsum_i = rowsum(dO_i ∘ O_i), one warp a row (f32).
//   2. dk/dv: one block of keys of one kv head walks the query tiles that
//      see them, for each query head of its GQA group, and recomputes
//      P = exp(scale·QKᵀ - lse) from the forward's per-row log-sum-exp:
//      dV += Pᵀ dO, dS = P ∘ (dO Vᵀ - dsum), dK += dSᵀ Q.  The group's
//      heads are summed in registers, so no float atomics.
//   3. dq: one block of queries of one head walks the key tiles it sees
//      (the forward's loop bounds): dQ += dS K.
//
// Every result is written once by one thread, in a fixed order: a replay
// is bit for bit the same.  A row that sees no key has lse = +inf, so its
// P is 0 and it contributes nothing (its output was 0).  Tensors are read
// through (batch, head, position) strides, so the model's [B, L, H, D]
// layout is used as it is; dq, dk, dv are written through strides too.
//
// P and dS are f32 and enter the products dV, dK, dQ as an A operand in
// hi + lo bf16 parts (x = bf16(x) + bf16(x - bf16(x)), as the forward's
// P·V does): with one bf16 part each the kernel would break the
// per-element limit its plain f32 version is held to (2^-7 |want| +
// 2^-10 max|want|), so every product keeps about f32's accuracy and the
// kernel matches its plain version to the final rounding of dq, dk, dv.
// Products whose operands are inputs (QKᵀ, dO Vᵀ) are exact in f32.
//
// Tensor-core route (bf16, D 64 or 128, Lq and Lk at least 64):
// flash_bwd_dkdv_wgmma and flash_bwd_dq_wgmma, after FlashAttention-3's
// backward (Shah et al., 2024, §3) in its deterministic two-walk form.  A
// block has two consumer warpgroups; its fixed tiles (K and V of 128 keys;
// Q and dO of 128 queries) are loaded once and a ring of kBwdStages
// streamed tiles (Q, dO and their rows' lse and dsum; K and V) is kept
// full with TMA, mbarriers signalling arrival and release, so the next
// tiles are in flight while the current one computes.  Products run on
// wgmma from 128-byte-swizzled shared memory.  In dk/dv a warpgroup takes
// 64 keys and computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, so Pᵀ and dSᵀ sit in its
// registers as the A operand of dV += Pᵀ dO and dK += dSᵀ Q (two
// register-A wgmmas each, hi and lo) against the Q and dO tiles read
// MN-major; ring tiles are 32 queries, which keeps dK, dV, Sᵀ, dPᵀ and
// both tiles' fragments in registers.  In dq a warpgroup takes 64 queries
// as the forward does.  Both overlap inside a warpgroup as the forward
// does: the next tile's S and dP are issued with this tile's gradient
// products, and P and dS are computed while those run; exp is one ex2 on
// the special-function unit.  Two walks (and not one walk that also sums
// dQ across key blocks) keep determinism free: dQ needs no ordered
// cross-block sum.  The cost is S and dP computed twice, 20·D flops a
// visible pair against the function's 10·D (the hi + lo split adds 3 of
// those products' 2·D).
//
// mma.sync route (bf16 D 32, f32 any D, or fewer than 64 queries or
// keys): flash_bwd_dkdv and flash_bwd_dq, blocks of 64 with four warps of
// 16 rows, P and dS through shared memory as hi + lo (bf16) or f32 (f32:
// scalar fmaf at the fragment positions an mma would compute).
//
// What bounds it on an H100: at the training shape (B = 4, H = 32,
// L = 4,096, D = 64, bf16, causal) the function needs 10·D flops a visible
// query-key pair (S, dP, dV, dK, dQ: 2.5 times the forward's 4·D), 687
// GFLOP, 0.69 ms at 989 TFLOP/s; its bytes (q, k, v, o, dO read, dq, dk,
// dv written, lse) are 0.47 GB, 0.14 ms at 3.35 TB/s: operations.  The
// tensor-core route does twice the bound's work (two walks, the split),
// 1.4 ms at the peak rate.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

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

// dsum_i = rowsum(dO_i ∘ O_i), one warp a row, into rows of ld entries
// (ld >= Lq; entries past Lq get 0).  With lse2 (the tensor-core route) it
// also writes lse·log2(e) there, +inf past Lq, so the TMA ring reads whole
// tiles of both.
template <typename T, int D>
__global__ void flash_bwd_dot(const BwdParams p, int ld, float* lse2,
                              int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / ld, qi = row - bh * ld;
  if (qi >= p.Lq) {
    if (lane == 0) {
      p.dsum[row] = 0.f;
      lse2[row] = INFINITY;      // only the padded tensor-core buffers
    }
    return;
  }
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
  if (lane == 0) {
    p.dsum[row] = acc;
    if (lse2 != nullptr)
      lse2[row] = p.lse[(int64_t)bh * p.Lq + qi] * 1.4426950408889634f;
  }
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
  flash_bwd_dot<T, D><<<(rows + 7) / 8, 256, 0, stream>>>(p, p.Lq, nullptr,
                                                          rows);
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

// ------------------------------------------------- tensor-core route --
namespace {

using repro::TmaTensor;
using repro::bulk_load;
using repro::desc_kmajor;
using repro::desc_mnmajor;
using repro::encode;
using repro::fence_regs;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;
using repro::tma_load;
using repro::to_frags;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_pv;
using repro::wgmma_wait0;
using repro::wgmma_wait1;

constexpr int kBwdStages = 3;     // depth of the ring of streamed tiles
constexpr int kBlockRows = 128;   // keys of a dk/dv block, queries of a dq
                                  // block: 64 a warpgroup
constexpr int kKeyTile = 64;      // keys a dq step takes
constexpr float kLog2e = 1.4426950408889634f;

struct TcBwdParams {
  TmaTensor q, dout;              // boxes of 64 positions (dq's fixed tiles)
  TmaTensor qt, dot;              // boxes of kBQ (dk/dv's ring)
  TmaTensor k, v;                 // boxes of 64 positions
  void *dq, *dk, *dv;
  const float* lse2;              // [B·Hq, Lqp]: lse·log2(e), +inf past Lq
  const float* dsum;              // [B·Hq, Lqp]: 0 past Lq
  Strides sdq, sdk, sdv;
  int Hq, Hkv, G, Lq, Lk, Lqp, causal, window;
  float scale;
};

constexpr int kBQ = 32;           // queries of a dk/dv ring tile

// The block's shape.  At D = 64 both kernels fit in the 168 registers a
// thread of a three-warpgroup block gets (ptxas allots registers by the
// launch bound; setmaxnreg does not raise that), so a producer warpgroup
// (one thread of it) keeps the ring full on its own.  At D = 128 dK, dV
// or dQ take 64 more registers: the block is the two consumer warpgroups
// (255 registers a thread) and thread 0 issues the loads, each stage's
// next tile once both warpgroups have released it.
template <int D>
__host__ __device__ constexpr bool producer_wg() { return D == 64; }
template <int D>
__host__ __device__ constexpr int bwd_threads() {
  return producer_wg<D>() ? 384 : 256;
}

template <int D>
constexpr size_t dkdv_smem() {
  // alignment slack; K, V [128 x D]; the ring of (Q, dO) [BQ x D]; the
  // ring's lse2 and dsum; the barriers
  return 1024 + (size_t)2 * (D / 64) * kBlockRows * 128 +
         (size_t)kBwdStages * 2 * (D / 64) * kBQ * 128 +
         (size_t)kBwdStages * 2 * kBQ * 4 + 8 * (2 * kBwdStages + 1);
}

template <int D>
constexpr size_t dq_smem() {
  // alignment slack; Q, dO [128 x D]; the ring of (K, V) [64 x D]; barriers
  return 1024 + (size_t)2 * (D / 64) * kBlockRows * 128 +
         (size_t)kBwdStages * 2 * (D / 64) * kKeyTile * 128 +
         8 * (2 * kBwdStages + 1);
}

// S (m64 x 8 NK) (+)= A·B from shared memory, K-major both
template <int NK>
__device__ __forceinline__ void wgmma_ss(float (&d)[4 * NK], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<4>(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  repro::wgmma_ss_n32(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  repro::wgmma_ss_n64(d, da, db, scale_d);
}

// the rows and columns of an m64 x N accumulator, each thread's two rows
// (g, g + 8 in its warp's 16) and its columns 8 j + 2 c, 8 j + 2 c + 1
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i, int c) {
  return 8 * (i >> 2) + 2 * c + (i & 1);
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t sl,
                                           int row0, int n,
                                           const float (&x)[D / 2],
                                           float scale) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * sl + 8 * j +
                                         2 * ((threadIdx.x & 31) & 3)) =
          __floats2bfloat162_rn(x[4 * j + 2 * rr] * scale,
                                x[4 * j + 2 * rr + 1] * scale);
  }
}

// One block: 128 keys of kv head hk, 64 a consumer warpgroup.  The
// producer loads K and V once and streams (Q, dO, lse2, dsum) tiles of BQ
// queries of each query head of the GQA group through the ring.
template <int D>
__global__ void __launch_bounds__(bwd_threads<D>(), 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ TcBwdParams p) {
  constexpr int NSUB = D / 64;            // 64-column boxes a row
  constexpr int BQ = kBQ;
  constexpr int NK = BQ / 8;              // n8 column tiles of Sᵀ
  constexpr int NS = BQ / 2;              // Sᵀ accumulators a thread
  constexpr int NO = D / 2;               // dK, dV accumulators a thread
  constexpr uint32_t kKSub = kBlockRows * 128;   // one K or V box column
  constexpr uint32_t kQSub = BQ * 128;           // one Q or dO box column
  constexpr uint32_t kStageBytes = 2 * NSUB * kQSub;
  constexpr uint32_t kStatBytes = 2 * BQ * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = sm;                               // NSUB x [128][64]
  uint8_t* Vs = Ks + NSUB * kKSub;
  uint8_t* ring = Vs + NSUB * kKSub;              // stage: Q NSUB x [BQ][64], dO
  float* stat = reinterpret_cast<float*>(ring + kBwdStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + kBwdStages * 2 * BQ);
  uint64_t* empty = full + kBwdStages;
  uint64_t* kvbar = empty + kBwdStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, bi = bh / p.Hkv, hk = bh - bi * p.Hkv;
  const int k0 = blockIdx.x * kBlockRows, off = p.Lk - p.Lq;
  // the queries that see a key of this block: qpos >= k0 (causal) and
  // qpos < k_last + window
  const int k_last = min(k0 + kBlockRows, p.Lk) - 1;
  int q_lo = p.causal ? max(0, k0 - off) : 0;
  const int q_hi = p.window > 0 ? min(p.Lq, k_last + p.window - off) : p.Lq;
  q_lo = (q_lo / BQ) * BQ;
  const int per_head = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_tiles = p.G * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage t % kBwdStages <- tile t: Q and dO of query head hk·G + t /
  // per_head, its rows' lse2 and dsum
  auto load_stage = [&](int t) {
    const int st = t % kBwdStages;
    mbar_expect_tx(&full[st], kStageBytes + kStatBytes);
    const int hq = hk * p.G + t / per_head;
    const int qt = q_lo + (t % per_head) * BQ;
    uint8_t* Qs = ring + st * kStageBytes;
    for (int s = 0; s < NSUB; ++s) {
      tma_load(Qs + s * kQSub, p.qt, &full[st], 64 * s, hq, qt, bi);
      tma_load(Qs + (NSUB + s) * kQSub, p.dot, &full[st], 64 * s, hq, qt,
               bi);
    }
    const int64_t row = (int64_t)(bi * p.Hq + hq) * p.Lqp + qt;
    bulk_load(stat + st * 2 * BQ, p.lse2 + row, BQ * 4, &full[st]);
    bulk_load(stat + st * 2 * BQ + BQ, p.dsum + row, BQ * 4, &full[st]);
  };
  const bool loader = producer_wg<D>() ? warp == 8 && lane == 0
                                       : threadIdx.x == 0;
  if (loader) {
    mbar_expect_tx(kvbar, 2 * NSUB * kKSub);
    for (int s = 0; s < NSUB; ++s)
      for (int half = 0; half < 2; ++half) {
        tma_load(Ks + s * kKSub + half * 8192, p.k, kvbar, 64 * s, hk,
                 k0 + 64 * half, bi);
        tma_load(Vs + s * kKSub + half * 8192, p.v, kvbar, 64 * s, hk,
                 k0 + 64 * half, bi);
      }
    const int first = producer_wg<D>() ? n_tiles : min(kBwdStages, n_tiles);
    for (int t = 0; t < first; ++t) {
      // the first round of stages passes at once
      mbar_wait(&empty[t % kBwdStages], ((t / kBwdStages) & 1) ^ 1);
      load_stage(t);
    }
  }
  if (warp >= 8) return;          // the producer warpgroup
  // without one, tile t's stage is refilled by thread 0 once released
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(&empty[t % kBwdStages]);
    if (!producer_wg<D>() && threadIdx.x == 0 && t + kBwdStages < n_tiles) {
      mbar_wait(&empty[t % kBwdStages], (t / kBwdStages) & 1);
      load_stage(t + kBwdStages);
    }
  };

  // consumers: warpgroup w takes keys [kw0, kw0 + 64); a thread holds keys
  // kw0 + 16 wl + g and + 8 of them, Sᵀ accumulator i at query column
  // acc_col(i)
  const int w = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  const int kw0 = k0 + 64 * w;
  const int krow = kw0 + 16 * wl + g;
  const uint32_t k_addr = smem_u32(Ks) + w * 8192;
  const uint32_t v_addr = smem_u32(Vs) + w * 8192;
  const float sl2 = p.scale * kLog2e;
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;

  // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for tile t, once it has arrived; committed
  auto issue_sdp = [&](float (&s)[NS], float (&dp)[NS], int t) {
    const int st = t % kBwdStages;
    mbar_wait(&full[st], (t / kBwdStages) & 1);
    const uint32_t q_addr = smem_u32(ring + st * kStageBytes);
    const uint32_t do_addr = q_addr + NSUB * kQSub;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<NK>(s, desc_kmajor(k_addr + (kk / 4) * kKSub + (kk % 4) * 32),
                   desc_kmajor(q_addr + (kk / 4) * kQSub + (kk % 4) * 32),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<NK>(dp, desc_kmajor(v_addr + (kk / 4) * kKSub + (kk % 4) * 32),
                   desc_kmajor(do_addr + (kk / 4) * kQSub + (kk % 4) * 32),
                   kk > 0);
    wgmma_commit();
  };
  // Pᵀ = exp(scale Sᵀ - lse) in s, dSᵀ = Pᵀ ∘ (dPᵀ - dsum) in dp; the masks
  // only where the tile cuts the diagonal or the window's edge (queries
  // past Lq have lse2 = +inf, so P = 0 there)
  auto grad_s = [&](float (&s)[NS], float (&dp)[NS], int t) {
    const int st = t % kBwdStages;
    const float* ls = stat + st * 2 * BQ;
    const float* ds = ls + BQ;
    const int qa = q_lo + (t % per_head) * BQ + off;
    const bool edge = (p.causal && kw0 + 63 > qa) ||
                      (p.window > 0 && kw0 <= qa + BQ - 1 - p.window);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = acc_col(i, c);
      float pv = repro::ex2(fmaf(s[i], sl2, -ls[col]));
      if (edge) {
        const int kpos = krow + acc_row(i), qpos = qa + col;
        if ((p.causal && kpos > qpos) ||
            (p.window > 0 && kpos <= qpos - p.window))
          pv = 0.f;
      }
      dp[i] = pv * (dp[i] - ds[col]);
      s[i] = pv;
    }
  };
  // dV += Pᵀ dO and dK += dSᵀ Q for the tile in stage st, Q and dO read
  // MN-major; committed
  auto issue_dkdv = [&](const uint32_t (&phi)[NK / 2][4],
                        const uint32_t (&plo)[NK / 2][4],
                        const uint32_t (&dhi)[NK / 2][4],
                        const uint32_t (&dlo)[NK / 2][4], int st) {
    const uint32_t q_addr = smem_u32(ring + st * kStageBytes);
    const uint32_t do_addr = q_addr + NSUB * kQSub;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const uint64_t bdo = desc_mnmajor(do_addr + kk * 2048, BQ);
      const uint64_t bq = desc_mnmajor(q_addr + kk * 2048, BQ);
      wgmma_pv<D>(dv, phi[kk], bdo);
      wgmma_pv<D>(dv, plo[kk], bdo);
      wgmma_pv<D>(dk, dhi[kk], bq);
      wgmma_pv<D>(dk, dlo[kk], bq);
    }
    wgmma_commit();
  };

  // the forward's overlap: Sᵀ_t, dPᵀ_t and tile t-1's dV, dK products are
  // issued together; Pᵀ_t and dSᵀ_t are computed while those run
  mbar_wait(kvbar, 0);
  if (n_tiles > 0) {
    float s[NS], dp[NS];
    uint32_t phi[NK / 2][4], plo[NK / 2][4], dhi[NK / 2][4], dlo[NK / 2][4];
    issue_sdp(s, dp, 0);
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    grad_s(s, dp, 0);
    to_frags<NK>(s, phi, plo);
    to_frags<NK>(dp, dhi, dlo);
    for (int t = 1; t < n_tiles; ++t) {
      issue_sdp(s, dp, t);
      issue_dkdv(phi, plo, dhi, dlo, (t - 1) % kBwdStages);
      wgmma_wait1();             // Sᵀ_t, dPᵀ_t done; dV, dK may still run
      fence_regs(s);
      fence_regs(dp);
      grad_s(s, dp, t);
      wgmma_wait0();
      fence_regs(dk);
      fence_regs(dv);
      release(t - 1);
      to_frags<NK>(s, phi, plo);
      to_frags<NK>(dp, dhi, dlo);
    }
    issue_dkdv(phi, plo, dhi, dlo, (n_tiles - 1) % kBwdStages);
    wgmma_wait0();
    fence_regs(dk);
    fence_regs(dv);
    release(n_tiles - 1);
  }

  store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + bi * p.sdk.b +
                    hk * p.sdk.h,
                p.sdk.l, krow, p.Lk, dk, p.scale);
  store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + bi * p.sdv.b +
                    hk * p.sdv.h,
                p.sdv.l, krow, p.Lk, dv, 1.f);
}

// One block: 128 queries of query head hq, 64 a consumer warpgroup.  The
// producer loads Q and dO once and keeps a ring of K/V tiles of 64 keys
// full, as the forward's does.
template <int D>
__global__ void __launch_bounds__(bwd_threads<D>(), 1)
    flash_bwd_dq_wgmma(const __grid_constant__ TcBwdParams p) {
  constexpr int NSUB = D / 64;
  constexpr int NO = D / 2;
  constexpr uint32_t kRowBytes = kBlockRows * D * 2;     // Q or dO
  constexpr uint32_t kStageBytes = 2 * NSUB * kKeyTile * 128;   // K then V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = sm;                        // NSUB x [128][64]
  uint8_t* dOs = Qs + kRowBytes;           // NSUB x [128][64]
  uint8_t* KV = dOs + kRowBytes;           // stage: K NSUB x [64][64], V
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + kBwdStages * kStageBytes);
  uint64_t* empty = full + kBwdStages;
  uint64_t* qbar = empty + kBwdStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, bi = bh / p.Hq, hq = bh - bi * p.Hq;
  const int hk = hq / p.G;
  // heavy (late) causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int off = p.Lk - p.Lq;
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBlockRows, p.Lq) - 1 + off;
  int k_end = p.Lk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / kKeyTile) * kKeyTile;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kKeyTile - 1) / kKeyTile : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage t % kBwdStages <- tile t: K and V of keys k_begin + 64 t
  auto load_stage = [&](int t) {
    const int st = t % kBwdStages;
    mbar_expect_tx(&full[st], kStageBytes);
    uint8_t* Ks = KV + st * kStageBytes;
    const int kt = k_begin + kKeyTile * t;
    for (int s = 0; s < NSUB; ++s) {
      tma_load(Ks + s * 8192, p.k, &full[st], 64 * s, hk, kt, bi);
      tma_load(Ks + (NSUB + s) * 8192, p.v, &full[st], 64 * s, hk, kt, bi);
    }
  };
  const bool loader = producer_wg<D>() ? warp == 8 && lane == 0
                                       : threadIdx.x == 0;
  if (loader) {
    mbar_expect_tx(qbar, 2 * kRowBytes);
    for (int s = 0; s < NSUB; ++s)
      for (int half = 0; half < 2; ++half) {
        tma_load(Qs + s * 16384 + half * 8192, p.q, qbar, 64 * s, hq,
                 q0 + 64 * half, bi);
        tma_load(dOs + s * 16384 + half * 8192, p.dout, qbar, 64 * s, hq,
                 q0 + 64 * half, bi);
      }
    const int first = producer_wg<D>() ? n_tiles : min(kBwdStages, n_tiles);
    for (int t = 0; t < first; ++t) {
      mbar_wait(&empty[t % kBwdStages], ((t / kBwdStages) & 1) ^ 1);
      load_stage(t);
    }
  }
  if (warp >= 8) return;          // the producer warpgroup
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(&empty[t % kBwdStages]);
    if (!producer_wg<D>() && threadIdx.x == 0 && t + kBwdStages < n_tiles) {
      mbar_wait(&empty[t % kBwdStages], (t / kBwdStages) & 1);
      load_stage(t + kBwdStages);
    }
  };

  // consumers: warpgroup w takes queries [qw0, qw0 + 64); a thread holds
  // rows qw0 + 16 wl + g and + 8; S accumulator i at key column acc_col(i)
  const int w = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  const int qw0 = q0 + 64 * w;
  const int row0 = qw0 + 16 * wl + g;
  const int qa = qw0 + off, qb = min(qw0 + 64, p.Lq) - 1 + off;
  const float sl2 = p.scale * kLog2e;
  float lse2[2], dsum[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    const int64_t i = (int64_t)bh * p.Lqp + row;
    lse2[rr] = row < p.Lq ? p.lse2[i] : INFINITY;
    dsum[rr] = row < p.Lq ? p.dsum[i] : 0.f;
  }
  const uint32_t q_addr = smem_u32(Qs) + w * 8192;
  const uint32_t do_addr = smem_u32(dOs) + w * 8192;
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;

  // S = Q Kᵀ and dP = dO Vᵀ for tile t, once it has arrived; committed
  auto issue_sdp = [&](float (&s)[32], float (&dp)[32], int t) {
    const int st = t % kBwdStages;
    mbar_wait(&full[st], (t / kBwdStages) & 1);
    const uint32_t k_addr = smem_u32(KV + st * kStageBytes);
    const uint32_t v_addr = k_addr + NSUB * 8192;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<8>(s, desc_kmajor(q_addr + (kk / 4) * 16384 + (kk % 4) * 32),
                  desc_kmajor(k_addr + (kk / 4) * 8192 + (kk % 4) * 32),
                  kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<8>(dp, desc_kmajor(do_addr + (kk / 4) * 16384 + (kk % 4) * 32),
                  desc_kmajor(v_addr + (kk / 4) * 8192 + (kk % 4) * 32),
                  kk > 0);
    wgmma_commit();
  };
  // dS = P ∘ (dP - dsum) in dp, P = exp(scale S - lse); the masks where
  // the tile cuts the diagonal, the window's edge or Lk
  auto grad_s = [&](const float (&s)[32], float (&dp)[32], int kt) {
    const bool edge = kt + kKeyTile > p.Lk ||
                      (p.causal && kt + kKeyTile - 1 > qa) ||
                      (p.window > 0 && kt <= qb - p.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      float pv = repro::ex2(fmaf(s[i], sl2, -lse2[rr]));
      if (edge) {
        const int qpos = row0 + 8 * rr + off, kpos = kt + acc_col(i, c);
        if (kpos >= p.Lk || (p.causal && kpos > qpos) ||
            (p.window > 0 && kpos <= qpos - p.window))
          pv = 0.f;
      }
      dp[i] = pv * (dp[i] - dsum[rr]);
    }
  };
  // dQ += dS K for the tile in stage st (K read MN-major); committed
  auto issue_dq = [&](const uint32_t (&dhi)[4][4],
                      const uint32_t (&dlo)[4][4], int st) {
    const uint32_t k_addr = smem_u32(KV + st * kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bk = desc_mnmajor(k_addr + kk * 2048);
      wgmma_pv<D>(dq, dhi[kk], bk);
      wgmma_pv<D>(dq, dlo[kk], bk);
    }
    wgmma_commit();
  };

  // S_t, dP_t and dQ += dS_{t-1} K_{t-1} are issued together, dS_t is
  // computed while the last product runs
  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    float s[32], dp[32];
    uint32_t dhi[4][4], dlo[4][4];
    issue_sdp(s, dp, 0);
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    grad_s(s, dp, k_begin);
    to_frags<8>(dp, dhi, dlo);
    for (int t = 1; t < n_tiles; ++t) {
      issue_sdp(s, dp, t);
      issue_dq(dhi, dlo, (t - 1) % kBwdStages);
      wgmma_wait1();             // S_t, dP_t done; dQ may still run
      fence_regs(s);
      fence_regs(dp);
      grad_s(s, dp, k_begin + kKeyTile * t);
      wgmma_wait0();
      fence_regs(dq);
      release(t - 1);
      to_frags<8>(dp, dhi, dlo);
    }
    issue_dq(dhi, dlo, (n_tiles - 1) % kBwdStages);
    wgmma_wait0();
    fence_regs(dq);
    release(n_tiles - 1);
  }
  store_rows<D>(static_cast<__nv_bfloat16*>(p.dq) + bi * p.sdq.b +
                    hq * p.sdq.h,
                p.sdq.l, row0, p.Lq, dq, p.scale);
}

template <int D>
int launch_tc(const BwdParams& dot, float* lse2, const TcBwdParams& p, int B,
              cudaStream_t stream) {
  const int rows = B * p.Hq * p.Lqp;
  flash_bwd_dot<__nv_bfloat16, D><<<(rows + 7) / 8, 256, 0, stream>>>(
      dot, p.Lqp, lse2, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t s1 = dkdv_smem<D>(), s2 = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wgmma<D>
      <<<dim3((p.Lk + kBlockRows - 1) / kBlockRows, B * p.Hkv),
         bwd_threads<D>(), s1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma<D>
      <<<dim3((p.Lq + kBlockRows - 1) / kBlockRows, B * p.Hq),
         bwd_threads<D>(), s2, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route: bf16, D in {64, 128}.  Tensors, strides[24] and
// window as repro_flash_attention_bwd's, with q, k, v and dout 16-byte
// aligned with byte strides that are multiples of 16 (TMA).  lse2 and
// dsum are the caller's [B·Hq, Lqp] f32 scratch, Lqp = Lq rounded up to
// a multiple of 64.  Three launches; returns the first CUDA error, 0 on
// success (cudaErrorInvalidValue where a tensor map is refused).
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* lse2, float* dsum, void* dq,
    void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, int window, const int64_t* st, void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  TcBwdParams p;
  if (!encode(p.q, q, B, Hq, Lq, D, st) ||
      !encode(p.dout, dout, B, Hq, Lq, D, st + 12) ||
      !encode(p.qt, q, B, Hq, Lq, D, st, kBQ) ||
      !encode(p.dot, dout, B, Hq, Lq, D, st + 12, kBQ) ||
      !encode(p.k, k, B, Hkv, Lk, D, st + 3) ||
      !encode(p.v, v, B, Hkv, Lk, D, st + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse2 = lse2;
  p.dsum = dsum;
  p.sdq = {st[15], st[16], st[17]};
  p.sdk = {st[18], st[19], st[20]};
  p.sdv = {st[21], st[22], st[23]};
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Lqp = (Lq + 63) / 64 * 64;
  p.causal = causal;
  p.window = window;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  BwdParams dot;
  dot.o = o;
  dot.dout = dout;
  dot.lse = lse;
  dot.dsum = dsum;
  dot.so = {st[9], st[10], st[11]};
  dot.sdo = {st[12], st[13], st[14]};
  dot.Hq = Hq;
  dot.Lq = Lq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_tc<64>(dot, lse2, p, B, s)
                 : launch_tc<128>(dot, lse2, p, B, s);
}
