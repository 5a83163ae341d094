// Flash attention forward (online softmax), causal and sliding window, GQA:
// two kernels, chosen by the wrapper's route rule (kernel.py: tc_route).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (Pallas, body _fa_kernel; grid (batch·heads, q blocks, kv blocks) with
// the kv axis sequential and m, l, acc in VMEM scratch, S = Q·Kᵀ and P·V
// both f32 dots) and the GQA fold of its wrapper, ops.py:_flash_attention
// (one launch per query group).  In both kernels a block takes one
// (batch·head, query tile) and loops over key tiles in order, keeping the
// running max m, normalizer l and accumulator of its rows in registers
// (f32): the loop takes the place of the TPU's sequential kv grid axis.
//
// Masks come from absolute positions, queries aligned to the END of the
// keys (off = Lk - Lq): causal keeps kpos <= qpos, a window keeps
// kpos > qpos - window.  Without either (causal = 0, window <= 0) off is
// never read and any Lq meets any Lk: the encoder's self-attention,
// cross-attention and Lq > Lk.  Key tiles that the mask empties for the whole
// query tile are never visited (the loop bounds), which halves causal
// work and leaves O(window) keys per query tile.  A ragged edge (Lq or Lk
// not a tile multiple) is masked here, not padded.  A row that sees no key
// writes 0 (l == 0).  Query head h reads kv head h / (Hq / Hkv) directly,
// so GQA needs no per-group launches and no copies; every tensor is read
// through (batch, head, position) strides, so the model's [B, L, H, D]
// projections are used as they are.
//
// What bounds it on an H100: at the prefill path's shape (B = 4, H = 32,
// L = 4096, D = 64, bf16, causal) the function needs 275 GFLOP (4·D per
// visible query-key pair), 0.278 ms at the 989 TFLOP/s bf16 tensor-core
// rate, and moves 268 MB, 0.08 ms at 3.35 TB/s: operations.
//
// flash_fwd_wgmma (bf16, D 64 or 128, Lq >= 64), the prefill's kernel: one
// block of 128 queries, two consumer warpgroups of 64 rows and one producer
// warp.  The producer loads Q once and keeps a ring of 3 K/V stages full
// with TMA (cp.async.bulk.tensor over 4-D maps of the caller's strided
// views, built on the host for each call; mbarriers signal arrival and
// release), so no thread spends instructions on loads.  S = Q·Kᵀ is
// wgmma m64n64k16 from shared memory (products of bf16 are exact in f32,
// as in the TPU kernel's f32 dot); the softmax scale is applied to S in
// f32 inside the exp2 argument (1/√D is not exact in bf16).  The TPU
// kernel computes P·V in f32, and one bf16 rounding of P would add about
// 2^-9 relative error to each p, over the per-element check's limit
// where |out| is small; so P = p_hi + p_lo (p_hi = bf16(p), p_lo =
// bf16(p - p_hi)) goes to two wgmmas from registers against V in shared
// memory (V's rows are keys: the MN-major operand).  That is 1.5 times the
// nominal tensor-core work, so the kernel can reach at most about two
// thirds of the bound above.  D = 128 loads each tile as two 64-column
// boxes under 128-byte swizzle, the wgmma K-major layout's atom.  The mask
// arithmetic runs only on tiles that cut the diagonal, the window edge or
// Lk; TMA reads out-of-bounds boxes as zero.  Each warpgroup overlaps its
// own work as FlashAttention-3 does: S of the next tile and P·V of the last
// one are issued together, and the softmax runs while P·V is on the
// tensor cores (every wgmma outside any branch, or ptxas serializes them).
// What holds it above the bound: the split's 1.5 times the tensor work;
// one exp2 per score on the 16-a-clock special-function units; and one
// block an SM (133 registers a thread at D = 64, 154 at D = 128), so two
// warpgroups share each SM's tensor cores with no scheduling between them.
//
// flash_fwd (f32, D = 32, or Lq < 64): the first, scalar kernel, kept as
// it was: 64 x 64 tiles with Q, K, V and P in shared memory as f32 and
// scalar fmaf, bound by shared-memory bandwidth and the 67 TFLOP/s f32
// rate.
//
// Both kernels write each row's log-sum-exp of the scaled scores when the
// caller passes an lse buffer (training: flash_attention_bwd.cu reads it to
// recompute P = exp(S - lse) without a pass for the row statistics; 4
// bytes a row).  The prefill passes none, and its launches are unchanged.
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::from_f;
using repro::Strides;
using repro::to_f;

constexpr int kThreads = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kBQ = 64;
constexpr int kBK = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                          // [B·Hq, Lq] or null
  Strides sq, sk, sv, so;
  int Hq, G, Lq, Lk, causal, window;   // window <= 0: none
  float scale;
};

constexpr size_t smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int DP = D + 1;      // padded rows: column reads hit 16 banks
  constexpr int CPT = D / 16;    // output columns per thread
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][D+1], pre-scaled
  float* Ks = Qs + kBQ * DP;     // [BK][D+1]
  float* Vs = Ks + kBK * DP;     // [BK][D]
  float* Ps = Vs + kBK * D;      // [BQ][BK+1]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, bi = bh / p.Hq, hi = bh % p.Hq;
  const int hk = hi / p.G;
  // heavy (late) causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int off = p.Lk - p.Lq;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq.b + hi * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + bi * p.sk.b + hk * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + bi * p.sv.b + hk * p.sv.h;
  T* o = static_cast<T*>(p.o) + bi * p.so.b + hi * p.so.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    Qs[r * DP + d] =
        q0 + r < p.Lq ? to_f(q[(int64_t)(q0 + r) * p.sq.l + d]) * p.scale
                      : 0.f;
  }

  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, p.Lq) - 1 + off;
  int k_end = p.Lk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();             // Qs written; last tile's readers done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < p.Lk;
      Ks[r * DP + d] = in ? to_f(k[(int64_t)(k0 + r) * p.sk.l + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(v[(int64_t)(k0 + r) * p.sv.l + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[(ty * 4 + r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r + off;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool ok = kp < p.Lk && (!p.causal || kp <= qp) &&
                        (p.window <= 0 || kp > qp - p.window);
        if (!ok) s[r][c] = -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      // a row with nothing visible yet keeps p = 0, l = 0, acc = 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - base);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(s[r][c] - base);
        rs += pv;
        Ps[(ty * 4 + r) * PP + tx + 16 * c] = pv;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4], vb[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[r] = Ps[(ty * 4 + r) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vb[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[r][c] = fmaf(pa[r], vb[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= p.Lq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[(int64_t)row * p.so.l + tx + 16 * c] = from_f<T>(acc[r][c] * inv);
    // the row's log-sum-exp of scaled scores (Q is pre-scaled); +inf for a
    // row that sees no key, so the backward's exp(s - lse) is 0 there
    if (p.lse != nullptr && tx == 0)
      p.lse[(int64_t)bh * p.Lq + row] = l[r] > 0.f ? m[r] + logf(l[r])
                                                   : INFINITY;
  }
}

template <typename T, int D>
int launch(const Params& p, int BH, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + kBQ - 1) / kBQ, BH);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int D, int BH, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, BH, s);
    case 64: return launch<T, 64>(p, BH, s);
    case 128: return launch<T, 128>(p, BH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace


// ------------------------------------------------- tensor-core route --
namespace {

using repro::TmaTensor;
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
using repro::wgmma_ss_n64;
using repro::wgmma_wait0;
using repro::wgmma_wait1;

constexpr int kTcThreads = 288;  // warps 0-7: two consumer warpgroups; 8: TMA
constexpr int kStages = 3;       // K/V ring depth
constexpr int kTcBQ = 128;       // queries per block, 64 per warpgroup
constexpr int kTcBK = 64;        // keys per tile

struct TcParams {
  TmaTensor q, k, v;
  void* o;
  float* lse;                    // [B·Hq, Lq] or null
  Strides so;
  int Hq, G, Lq, Lk, causal, window;
  float scale;
};

constexpr size_t tc_smem_bytes(int D) {
  // 1,024 bytes of alignment slack, Q [128 x D], kStages x (K, V) [64 x D],
  // then the barriers
  return 1024 + (size_t)(D / 64) * 16384 * (1 + kStages) +
         8 * (2 * kStages + 1);
}

// One block: one (batch·head, 128-query tile).  Warp 8 loads Q once and
// keeps a ring of kStages K/V tiles full with TMA; warpgroups 0 and 1 each
// take 64 query rows through every key tile: S = Q·Kᵀ by wgmma from shared
// memory, the online softmax in registers, then O += P·V by two wgmmas per
// 16 keys with P = p_hi + p_lo from registers.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ TcParams p) {
  constexpr int NSUB = D / 64;   // 64-column boxes per row
  constexpr int NO = D / 2;      // output accumulators a thread
  constexpr uint32_t kQBytes = kTcBQ * D * 2;
  constexpr uint32_t kKVBytes = 2 * kTcBK * D * 2;
  constexpr int kStageBytes = NSUB * 16384;   // K then V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = sm;                          // NSUB x [128][64]
  uint8_t* KV = sm + NSUB * 16384;           // stage: K NSUB x [64][64], V
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, bi = bh / p.Hq, hi = bh % p.Hq, hk = hi / p.G;
  // heavy (late) causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int off = p.Lk - p.Lq;
  const int q_first = q0 + off, q_last = min(q0 + kTcBQ, p.Lq) - 1 + off;
  int k_end = p.Lk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / kTcBK) * kTcBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK
                                      : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {               // producer
    if (lane == 0) {
      mbar_expect_tx(qbar, kQBytes);
      for (int s = 0; s < NSUB; ++s)
        for (int half = 0; half < 2; ++half)
          tma_load(Qs + s * 16384 + half * 8192, p.q, qbar, 64 * s, hi,
                   q0 + 64 * half, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages, ph = (t / kStages) & 1;
        mbar_wait(&empty[st], ph ^ 1);   // the first round passes at once
        mbar_expect_tx(&full[st], kKVBytes);
        uint8_t* Ks = KV + st * kStageBytes;
        const int k0 = k_begin + kTcBK * t;
        for (int s = 0; s < NSUB; ++s) {
          tma_load(Ks + s * 8192, p.k, &full[st], 64 * s, hk, k0, bi);
          tma_load(Ks + NSUB * 8192 + s * 8192, p.v, &full[st], 64 * s, hk,
                   k0, bi);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w takes query rows [qw0, qw0 + 64); a thread holds
  // rows r0 = 16 wl + g and r0 + 8 of them, accumulator i at row
  // r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 c + (i & 1)
  const int w = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  const int qw0 = q0 + 64 * w;
  const bool has_rows = qw0 < p.Lq;
  const int qa = qw0 + off, qb = min(qw0 + 64, p.Lq) - 1 + off;
  const float sl2 = p.scale * 1.4426950408889634f;   // scale · log2(e)
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(Qs) + w * 8192;

  // S (one tile, f32) -> p in place: the masks where the tile cuts the
  // diagonal, the window edge or Lk; the running max and sum; alpha, the
  // factor that rescales earlier rows
  auto softmax = [&](float (&s)[32], int k0, float (&alpha)[2]) {
    const bool edge = k0 + kTcBK > p.Lk ||
                      (p.causal && k0 + kTcBK - 1 > qa) ||
                      (p.window > 0 && k0 <= qb - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qpos = qw0 + 16 * wl + g + 8 * ((i >> 1) & 1) + off;
        const int kpos = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (kpos >= p.Lk || (p.causal && kpos > qpos) ||
            (p.window > 0 && kpos <= qpos - p.window))
          s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      // a row with nothing visible yet keeps p = 0, l = 0, o = 0
      const float base = m_new == -INFINITY ? 0.f : m_new * sl2;
      alpha[rr] = exp2f(m[rr] * sl2 - base);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * rr + e;
          s[i] = exp2f(fmaf(s[i], sl2, -base));
          l[rr] += s[i];
        }
    }
  };
  // S = Q·K for the tile t (stage t % kStages), once it has arrived;
  // committed, not waited for
  auto issue_s = [&](float (&sd)[32], int t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    const uint32_t k_addr = smem_u32(KV + st * kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sd, desc_kmajor(q_addr + (kk / 4) * 16384 + (kk % 4) * 32),
                   desc_kmajor(k_addr + (kk / 4) * 8192 + (kk % 4) * 32),
                   kk > 0);
    wgmma_commit();
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        o[4 * j + 2 * rr] *= alpha[rr];
        o[4 * j + 2 * rr + 1] *= alpha[rr];
      }
  };
  // o += P·V for the tile in stage st; committed, not waited for
  auto issue_pv = [&](const uint32_t (&phi)[4][4],
                      const uint32_t (&plo)[4][4], int st) {
    const uint32_t v_addr = smem_u32(KV + st * kStageBytes) + NSUB * 8192;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mnmajor(v_addr + kk * 2048);
      wgmma_pv<D>(o, phi[kk], dv);
      wgmma_pv<D>(o, plo[kk], dv);
    }
    wgmma_commit();
  };

  // FA3's in-warpgroup overlap: S_t = Q·K_t and O += P_{t-1}·V_{t-1} are
  // issued together; the softmax of S_t runs while the second product is
  // on the tensor cores; O is rescaled once that product is done.  Every
  // tile of the block's range is computed (a tile that the mask empties
  // for these rows gives p = 0), so no wgmma sits behind a branch.
  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    float s[32], alpha[2];
    uint32_t phi[4][4], plo[4][4];
    issue_s(s, 0);
    wgmma_wait0();
    fence_regs(s);
    softmax(s, k_begin, alpha);
    to_frags<8>(s, phi, plo);   // p = p_hi + p_lo
    for (int t = 1; t < n_tiles; ++t) {
      issue_s(s, t);
      issue_pv(phi, plo, (t - 1) % kStages);
      wgmma_wait1();             // S_t done; P_{t-1}·V_{t-1} may still run
      fence_regs(s);
      softmax(s, k_begin + kTcBK * t, alpha);
      wgmma_wait0();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kStages]);
      rescale(alpha);
      to_frags<8>(s, phi, plo);   // p = p_hi + p_lo
    }
    issue_pv(phi, plo, (n_tiles - 1) % kStages);
    wgmma_wait0();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[(n_tiles - 1) % kStages]);
  }
  if (!has_rows) return;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + bi * p.so.b +
                       hi * p.so.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lr = l[rr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = qw0 + 16 * wl + g + 8 * rr;
    if (row >= p.Lq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    // log-sum-exp of the scaled scores: p = exp(scale (s - m)), so
    // lse = scale·m + ln l; +inf for a row that sees no key
    if (p.lse != nullptr && c == 0)
      p.lse[(int64_t)bh * p.Lq + row] =
          lr > 0.f ? m[rr] * p.scale + logf(lr) : INFINITY;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * p.so.l + 8 * j +
                                         2 * c) =
          __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv,
                                o[4 * j + 2 * rr + 1] * inv);
  }
}

template <int D>
int launch_tc(const TcParams& p, int BH, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + kTcBQ - 1) / kTcBQ, BH);
  flash_fwd_wgmma<D><<<grid, kTcThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Hq, Lq, D]; k, v: [B, Hkv, Lk, D]; o: [B, Hq, Lq, D]; all bf16
// (is_bf16 = 1) or all f32, each read through strides[12] = the (batch,
// head, position) element strides of q, k, v, o in that order, with the
// head dim contiguous.  D in {32, 64, 128}; window <= 0 means none.  lse:
// null, or [B·Hq, Lq] f32 that receives each row's log-sum-exp of the
// scaled scores (the backward's input; +inf where a row sees no key).
// Returns the first CUDA error, 0 on success.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int is_bf16,
                                     int B, int Hq, int Hkv, int Lq, int Lk,
                                     int D, int causal, int window,
                                     const int64_t* strides, void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.Hq = Hq;
  p.G = Hq / Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.window = window;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, D, B * Hq, s)
                 : dispatch<float>(p, D, B * Hq, s);
}

// q: [B, Hq, Lq, D]; k, v: [B, Hkv, Lk, D]; o: [B, Hq, Lq, D]; all bf16,
// D in {64, 128}, read through strides[12] = the (batch, head, position)
// element strides of q, k, v, o in that order, with the head dim
// contiguous, bases and byte strides of q, k, v multiples of 16 (TMA).
// window <= 0 means none; lse as repro_flash_attention's.  Returns the
// first CUDA error, 0 on success (cudaErrorInvalidValue where the driver
// refuses a tensor map).
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B,
                                        int Hq, int Hkv, int Lq, int Lk,
                                        int D, int causal, int window,
                                        const int64_t* strides,
                                        void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0) return 0;
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  TcParams p;
  if (!encode(p.q, q, B, Hq, Lq, D, strides) ||
      !encode(p.k, k, B, Hkv, Lk, D, strides + 3) ||
      !encode(p.v, v, B, Hkv, Lk, D, strides + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = o;
  p.lse = lse;
  p.so = {strides[9], strides[10], strides[11]};
  p.Hq = Hq;
  p.G = Hq / Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.window = window;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_tc<64>(p, B * Hq, s) : launch_tc<128>(p, B * Hq, s);
}

// Dynamic shared memory flash_fwd_wgmma takes for head dim D.
extern "C" int64_t repro_flash_attention_tc_smem(int D) {
  return static_cast<int64_t>(tc_smem_bytes(D));
}
