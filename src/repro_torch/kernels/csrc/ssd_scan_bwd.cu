// The SSD scan's backward (ssd_scan.cu's forward differentiated): dxt,
// dloga, dB, dC given dy and the forward's y, in three launches.
//
// The TPU package has no backward kernel: repro/train differentiates the
// jnp chunked scan (repro/models/ssm.py:_ssd_chunked) with jax.grad.  This
// is Mamba-2's chunked backward (Dao & Gu, 2024, §7; the public
// mamba_ssm's chunk_state / chunk_scan backward passes as the model), on
// the forward's chunking (Q = 64 tokens), with l the in-chunk inclusive
// cumsum of loga (in log2 units here), the forward state S and the adjoint
// state G_t = exp(loga_{t+1}) G_{t+1} + C_t ⊗ dy_t (dxt_t = B_t G_t,
// dB_t = G_t xt_t, dC_t = S_t dy_t):
//
//   1. ssd_scan_bwd_walk, one block per (batch·head, direction): the
//      chunk states and their passing, S_c = exp(l_Q,c) S_{c-1} + s_c with
//      s_c = (B ∘ exp(l_Q - l))ᵀ · xt in chunk order, and the adjoint that
//      enters chunk c from the right, H_{c-1} = exp(l_Q,c) H_c + g_c with
//      g_c = (C ∘ exp(l))ᵀ · dy, in reverse order, the state in shared
//      memory; each chunk's entering state (S_{c-1}, H_c) goes to one of
//      two scratch sequences [b, H, n_chunks, N, P] f32.  Reversal of time
//      is index arithmetic: nothing is flipped in memory.  (A launch of
//      chunk states for all chunks at once and one of state passes, as the
//      forward has, moved twice the scratch and measured 1.10 ms against
//      this launch's 1.03 at the training shape.)
//   2. ssd_scan_bwd_chunk, one block per (batch, chunk, group of heads):
//      with V = tril(dy xtᵀ) ∘ exp(l_i - l_j), W = tril(C Bᵀ) ∘ the same,
//        dxt = exp(l_Q - l) ∘ (B · H_c) + Wᵀ · dy
//        dB  = exp(l_Q - l) ∘ (xt · H_cᵀ) + Vᵀ · C
//        dC  = exp(l) ∘ (dy · S_{c-1}ᵀ) + V · B
//      and dloga's per-token term <y, dy> - <xt, dxt> summed backwards in
//      the chunk, with the chunk's total.  For B, C shared by the heads
//      (one group) dB and dC are summed over the block's heads in f32 in
//      registers, each warp owning a fixed tile, into a [b, groups, L, N]
//      partial; per-head B, C get per-head dB, dC.
//   3. ssd_scan_bwd_finish: dloga plus the totals of the later chunks, and
//      the partials summed over the head groups in order.
//
// No float atomics: every result is written by one thread in a fixed
// order, so a replay is bit for bit the same.  dxt and dB read the same
// adjoint state H_c, dC the forward state, each loaded once a head.  B
// and C are read as the model passes them, one group with head stride 0
// (loaded once for a group of heads), or per head.
// Products run on tensor cores with mma.sync as the forward's: bf16
// operands exact in tf32, f32 operands split for 3xTF32 (about f32's
// accuracy).  A ragged last chunk is masked (rows past L load as zero with
// loga 0, so they move nothing, and are not stored).  xt, dy, y and dxt
// are read and written through (batch, head, position) strides, so they
// stay in the model's [b, L, H, P] layout.  The kernels allocate nothing:
// the wrapper passes the scratch.
//
// What bounds it on an H100: at the training shape (b·H = 256, L = 4096,
// P = N = 64; xt, dy, y f32, B/C bf16 shared) the function must read xt,
// dy, y and write dxt (1.07 GB) and dloga, dB, dC: 0.33 ms at 3.35 TB/s,
// bytes (three per-token recurrences, 52 GFLOP, take 0.31 ms as 3xTF32 at
// 165 TFLOP/s).  The design moves about 2.7 GB: xt and dy read twice, y
// once, dxt written, and each state sequence written and read again (2 x
// 2 x 268 MB), a floor near 0.8 ms; its nine 64 x 64 x 64 products a head
// and chunk (two in the walk, seven in the chunk pass), 77 GFLOP as
// 3xTF32, take at least 0.47 ms.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ssd_common.cuh"

namespace {

using namespace repro::ssd;
using repro::Strides;
using repro::to_f;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxColTiles = 8;   // dxt column tiles a row: P <= 128

struct BwdArgs {
  const float* xt;
  const float* loga;
  const void* B;
  const void* C;
  const float* y;
  const float* dy;
  float* dxt;                   // [b, H, L, P] through strides
  float* dloga;                 // [b, H, L]
  float* dB;                    // [b, H, L, N] per head, or [b, 1, L, N]
  float* dC;
  float* dBp;                   // [b, groups, L, N] partials (summed B)
  float* dCp;
  float* states;                // [b, H, nc, N, P]: S_{c-1}
  float* gstates;               // [b, H, nc, N, P]: H_c
  float* totals;                // [b, H, nc]: dloga's chunk totals
  Strides sx, sa, sb, sc, sy, sdy, sdx;
  int H, L, P, N, nc, ng;
  int bc_shared;                // B and C have head stride 0
  int sum_b, sum_c;             // dB / dC summed over the heads
  int x_vec, dy_vec;            // rows 16-byte aligned: 16-byte copies
};

// shared-memory row strides (elements)
template <typename TB>
__host__ __device__ constexpr int ld_bc(int N) {
  return std::is_same<TB, float>::value ? N + 4 : N + 8;
}
__host__ __device__ constexpr int ld_p1(int P) { return P + 8; }  // walk
__host__ __device__ constexpr int ld_p3(int P) { return P + 4; }  // chunks
constexpr int kLdq = Q + 4;       // [Q][Q] f32 tiles

template <typename TB>
size_t smem_walk(int P, int N) {
  return align16(sizeof(TB) * Q * (N + 8)) +
         sizeof(float) * (2 * Q * ld_p1(P) + N * P + 3 * Q);
}

template <typename TB>
size_t smem_chunk(int P, int N) {
  return 2 * align16(sizeof(TB) * Q * ld_bc<TB>(N)) +
         sizeof(float) * (Q * kLdq + (2 * Q + 2 * N) * ld_p3(P) + Q +
                          (4 + kMaxColTiles) * Q);
}

// blocks of the chunk pass an SM holds: two (108 KB of shared memory and
// at most 128 registers a thread at P = N = 64, bf16 B/C), so one block's
// loads and single-warp steps overlap the other's products; one for N = 128
template <int NB>
constexpr int chunk_blocks() { return NB <= 4 ? 2 : 1; }

// start copying loga of head h over the chunk into la (0 past qn)
__device__ __forceinline__ void async_loga(float* la, const BwdArgs& a,
                                           int bi, int h, int c0, int qn) {
  if (threadIdx.x < Q) {
    const bool ok = threadIdx.x < qn;
    const float* src = a.loga + bi * a.sa.b + h * a.sa.h;
    cp_async4(la + threadIdx.x, ok ? src + (c0 + threadIdx.x) * a.sa.l : src,
              ok);
  }
}

// Passes 1 and 2: block (batch·head, direction) walks the chunks in
// order (direction 0: S_c = exp(l_Q,c) S_{c-1} + s_c with s_c =
// (B ∘ exp(l_Q - l))ᵀ · xt) or in reverse (1: H_{c-1} = exp(l_Q,c) H_c +
// g_c with g_c = (C ∘ exp(l))ᵀ · dy), the state [N, P] f32 in shared
// memory, and writes the state that enters each chunk (S_{c-1}, H_c) to
// the scratch.  The next chunk's xt or dy is in flight (cp.async) while
// this one computes.
template <typename TB>
__global__ void __launch_bounds__(kThreads) ssd_scan_bwd_walk(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int P = a.P, N = a.N, ldb = N + 8, ldx = ld_p1(P);
  char* base = reinterpret_cast<char*>(smem4);
  TB* Bs = reinterpret_cast<TB*>(base);                         // [Q][ldb]
  float* X = reinterpret_cast<float*>(
      base + align16(sizeof(TB) * Q * ldb));                    // [2][Q][ldx]
  float* S = X + 2 * Q * ldx;                                   // [N][P]
  float* la = S + N * P;                                        // [2][Q]
  float* w = la + 2 * Q;                                        // [Q]
  const int bh = blockIdx.x, bi = bh / a.H, h = bh - bi * a.H;
  const bool back = blockIdx.y == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  const Strides sb = back ? a.sc : a.sb, sx = back ? a.sdy : a.sx;
  const TB* Bg = static_cast<const TB*>(back ? a.C : a.B) + bi * sb.b +
                 h * sb.h;
  const float* Xg = (back ? a.dy : a.xt) + bi * sx.b + h * sx.h;
  const int x_vec = back ? a.dy_vec : a.x_vec;
  float* out = (back ? a.gstates : a.states) + (int64_t)bh * a.nc * N * P;
  constexpr bool kSplitB = std::is_same<TB, float>::value;
  for (int i = threadIdx.x; i < N * P; i += kThreads) S[i] = 0.f;
  // chunk step t's xt or dy and loga go to buffer t & 1, one step ahead
  auto issue = [&](int t) {
    const int c = back ? a.nc - 1 - t : t, c0 = c * Q;
    const int qn = min(Q, a.L - c0);
    async_tile(X + (t & 1) * Q * ldx, ldx, Xg + c0 * sx.l, sx.l, Q, qn, P,
               x_vec);
    async_loga(la + (t & 1) * Q, a, bi, h, c0, qn);
    cp_async_commit();
  };

  issue(0);
  for (int t = 0; t < a.nc; ++t) {
    const int c = back ? a.nc - 1 - t : t, c0 = c * Q;
    const int qn = min(Q, a.L - c0);
    float* Xh = X + (t & 1) * Q * ldx;
    float* lh = la + (t & 1) * Q;
    load_tile(Bs, ldb, Bg + c0 * sb.l, sb.l, Q, qn, N);
    if (t + 1 < a.nc) issue(t + 1);
    else cp_async_commit();      // an empty group: one group per step
    cp_async_wait_prev();
    __syncthreads();
    if (threadIdx.x < 32) cumsum(lh, kLog2e);
    __syncthreads();
    const float llast = lh[Q - 1];
    if (threadIdx.x < Q)
      w[threadIdx.x] = exp2f(back ? lh[threadIdx.x] : llast - lh[threadIdx.x]);
    __syncthreads();
    for (int i = threadIdx.x; i < Q * P; i += kThreads) {
      const int r = i / P;
      Xh[r * ldx + (i - r * P)] *= w[r];
    }
    __syncthreads();
    const float dec = exp2f(llast);
    float* slot = out + (int64_t)c * N * P;
    // warp tiles of (16 MT) x 16 of the state: the scratch <- the state
    // entering the chunk, then the state <- dec · state + this chunk's
    auto tiles = [&](auto mt) {
      constexpr int MT = decltype(mt)::value;
      const int tp = P / 16, n_t = N / (16 * MT) * tp;
      for (int tt = warp; tt < n_t; tt += kWarps) {
        const int m0 = (tt / tp) * 16 * MT, n0 = (tt % tp) * 16;
        float acc[MT][2][4];
        zero(acc);
        gemm<kSplitB, true>(
            acc, m0, n0, Q,
            [&](int m, int k) { return to_f(Bs[k * ldb + m]); },
            [&](int k, int n) { return Xh[k * ldx + n]; });
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int i = (m0 + 16 * mi + g + 8 * half) * P + n0 + 8 * j +
                            2 * cq;
              const float2 old = *reinterpret_cast<float2*>(S + i);
              *reinterpret_cast<float2*>(slot + i) = old;
              *reinterpret_cast<float2*>(S + i) = make_float2(
                  fmaf(dec, old.x, acc[mi][j][2 * half]),
                  fmaf(dec, old.y, acc[mi][j][2 * half + 1]));
            }
      }
    };
    if (N % 32 == 0) tiles(std::integral_constant<int, 2>());
    else tiles(std::integral_constant<int, 1>());
    __syncthreads();             // this buffer, w and B rewritten next
  }
}

// The chunk pass for one (batch, chunk, group of heads); NB = N / 16.  One
// buffer of per-head tiles: the other block on the SM computes while this
// one loads.
template <typename TB, int NB>
__global__ void __launch_bounds__(kThreads, chunk_blocks<NB>())
    ssd_scan_bwd_chunk(BwdArgs a) {
  constexpr int N = 16 * NB;
  constexpr bool kF32 = std::is_same<TB, float>::value;
  constexpr int tq = Q / 16;
  constexpr int ldb = ld_bc<TB>(N);
  extern __shared__ float4 smem4[];
  const int P = a.P, ldp = ld_p3(P);
  char* base = reinterpret_cast<char*>(smem4);
  TB* Cs = reinterpret_cast<TB*>(base);                         // [Q][ldb]
  TB* Bs = reinterpret_cast<TB*>(base + align16(sizeof(TB) * Q * ldb));
  float* Vm = reinterpret_cast<float*>(
      base + 2 * align16(sizeof(TB) * Q * ldb));                // [Q][kLdq]
  float* X = Vm + Q * kLdq;                                     // [Q][ldp]
  float* dY = X + Q * ldp;                                      // [Q][ldp]
  float* Sp = dY + Q * ldp;                                     // [N][ldp]
  float* Hn = Sp + N * ldp;                                     // [N][ldp]
  float* lh = Hn + N * ldp;                                     // [Q]
  float* wq = lh + Q;                                           // [Q]
  float* el = wq + Q;                                           // [Q]
  float* ydy = el + Q;                                          // [Q]
  float* dl = ydy + Q;                                          // [Q]
  float* part = dl + Q;                                         // [8][Q]
  const int nhg = (a.H + kHeadGroup - 1) / kHeadGroup;
  const int c = blockIdx.x, bi = blockIdx.y / nhg, grp = blockIdx.y % nhg;
  const int h0 = grp * kHeadGroup;
  const int h_end = min(h0 + kHeadGroup, a.H);
  const int c0 = c * Q, qn = min(Q, a.L - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  const TB* Bg = static_cast<const TB*>(a.B) + bi * a.sb.b + c0 * a.sb.l;
  const TB* Cg = static_cast<const TB*>(a.C) + bi * a.sc.b + c0 * a.sc.l;

  // dB and dC tiles of this warp, summed over the group's heads (sum_b,
  // sum_c) or one head at a time: rows m0 .. m0 + 15, columns n0 .. +N/2
  const int bm0 = 16 * (warp >> 1), bn0 = (warp & 1) * (N / 2);
  float accB[1][NB][4], accC[1][NB][4];
  zero(accB);
  zero(accC);
  auto store_bc = [&](float (&acc)[1][NB][4], float* out) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = bm0 + g + 8 * half;
      if (r >= qn) continue;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        *reinterpret_cast<float2*>(out + (int64_t)r * N + bn0 + 8 * j +
                                   2 * cq) =
            make_float2(acc[0][j][2 * half], acc[0][j][2 * half + 1]);
    }
  };
  // M = tril(A Bᵀ) ∘ exp(l_i - l_j) into Vm on and below the diagonal's
  // 16 x 16 tiles (0 above the diagonal), A(i, k) = fa(i, k), B(j, k) =
  // fb(j, k), k in [0, K)
  auto decayed_tril = [&](auto split, int K, auto fa, auto fb) {
    constexpr bool S = decltype(split)::value;
    for (int t = warp; t < tq * tq; t += kWarps) {
      const int mi = t / tq, ni = t % tq;
      if (ni > mi) continue;
      float acc[1][2][4];
      zero(acc);
      gemm<S, S>(acc, mi * 16, ni * 16, K, fa,
                 [&](int k, int n) { return fb(n, k); });
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = mi * 16 + g + 8 * half;
          const int jj = ni * 16 + 8 * j + 2 * cq;
          *reinterpret_cast<float2*>(Vm + i * kLdq + jj) = make_float2(
              jj <= i ? acc[0][j][2 * half] * exp2f(lh[i] - lh[jj]) : 0.f,
              jj + 1 <= i
                  ? acc[0][j][2 * half + 1] * exp2f(lh[i] - lh[jj + 1])
                  : 0.f);
        }
    }
  };

  for (int h = h0; h < h_end; ++h) {
    if (h == h0 || !a.bc_shared) {
      load_tile(Bs, ldb, Bg + h * a.sb.h, a.sb.l, Q, qn, N);
      load_tile(Cs, ldb, Cg + h * a.sc.h, a.sc.l, Q, qn, N);
    }
    // head h's xt, dy, entering states and loga
    const int64_t slot = ((int64_t)(bi * a.H + h) * a.nc + c) * N * P;
    async_tile(X, ldp, a.xt + bi * a.sx.b + h * a.sx.h + c0 * a.sx.l, a.sx.l,
               Q, qn, P, a.x_vec);
    async_tile(dY, ldp, a.dy + bi * a.sdy.b + h * a.sdy.h + c0 * a.sdy.l,
               a.sdy.l, Q, qn, P, a.dy_vec);
    async_tile(Sp, ldp, a.states + slot, P, N, N, P, true);
    async_tile(Hn, ldp, a.gstates + slot, P, N, N, P, true);
    async_loga(lh, a, bi, h, c0, qn);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // l in log2 units: every decay below is exp2 of a difference <= 0
    if (threadIdx.x < 32) cumsum(lh, kLog2e);
    __syncthreads();
    if (threadIdx.x < Q) {
      wq[threadIdx.x] = exp2f(lh[Q - 1] - lh[threadIdx.x]);
      el[threadIdx.x] = exp2f(lh[threadIdx.x]);
    }
    // <y_t, dy_t>, a warp a row in a fixed order
    const float* yg = a.y + bi * a.sy.b + h * a.sy.h + c0 * a.sy.l;
    for (int r = warp; r < Q; r += kWarps) {
      float acc = 0.f;
      if (r < qn)
        for (int k = lane; k < P; k += 32)
          acc = fmaf(yg[(int64_t)r * a.sy.l + k], dY[r * ldp + k], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) ydy[r] = acc;
    }
    // V = tril(dy xtᵀ) ∘ exp(l_i - l_j)
    decayed_tril(std::true_type(), P,
                 [&](int m, int k) { return dY[m * ldp + k]; },
                 [&](int n, int k) { return X[n * ldp + k]; });
    __syncthreads();

    // dB += exp(l_Q - l) ∘ (xt · H_cᵀ) + Vᵀ · C (keys s >= t);
    // dC += exp(l) ∘ (dy · S_{c-1}ᵀ) + V · B (keys s <= t)
    gemm<true, true>(
        accB, bm0, bn0, P,
        [&](int m, int k) { return X[m * ldp + k] * wq[m]; },
        [&](int k, int n) { return Hn[n * ldp + k]; });
    gemm<true, kF32>(
        accB, bm0, bn0, Q - bm0,
        [&](int m, int k) { return Vm[(k + bm0) * kLdq + m]; },
        [&](int k, int n) { return to_f(Cs[(k + bm0) * ldb + n]); });
    gemm<true, true>(
        accC, bm0, bn0, P,
        [&](int m, int k) { return dY[m * ldp + k] * el[m]; },
        [&](int k, int n) { return Sp[n * ldp + k]; });
    gemm<true, kF32>(
        accC, bm0, bn0, bm0 + 16,
        [&](int m, int k) { return Vm[m * kLdq + k]; },
        [&](int k, int n) { return to_f(Bs[k * ldb + n]); });
    const int64_t bc_row = (int64_t)(bi * a.H + h) * a.L + c0;
    if (!a.sum_b) {
      store_bc(accB, a.dB + bc_row * N);
      zero(accB);
    }
    if (!a.sum_c) {
      store_bc(accC, a.dC + bc_row * N);
      zero(accC);
    }
    __syncthreads();             // V read: W takes its place
    // W = tril(C Bᵀ) ∘ exp(l_i - l_j)
    decayed_tril(std::integral_constant<bool, kF32>(), N,
                 [&](int m, int k) { return to_f(Cs[m * ldb + k]); },
                 [&](int n, int k) { return to_f(Bs[n * ldb + k]); });
    __syncthreads();

    // dxt = exp(l_Q - l) ∘ (B · H_c) + Wᵀ · dy, and each row's <xt, dxt>
    // over this warp's columns into part[column tile]
    float* dx = a.dxt + bi * a.sdx.b + h * a.sdx.h + c0 * a.sdx.l;
    auto tiles = [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      const int tp = P / (8 * NT), n_t = tq * tp;
      for (int t = warp; t < n_t; t += kWarps) {
        const int m0 = (t / tp) * 16, n0 = (t % tp) * 8 * NT;
        float inter[1][NT][4], intra[1][NT][4];
        zero(inter);
        zero(intra);
        gemm<kF32, true>(
            inter, m0, n0, N,
            [&](int m, int k) { return to_f(Bs[m * ldb + k]); },
            [&](int k, int n) { return Hn[k * ldp + n]; });
        gemm<true, true>(
            intra, m0, n0, Q - m0,
            [&](int m, int k) { return Vm[(k + m0) * kLdq + m]; },
            [&](int k, int n) { return dY[(k + m0) * ldp + n]; });
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + g + 8 * half;
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = n0 + 8 * j + 2 * cq;
            const float d0 = wq[r] * inter[0][j][2 * half] +
                             intra[0][j][2 * half];
            const float d1 = wq[r] * inter[0][j][2 * half + 1] +
                             intra[0][j][2 * half + 1];
            dot = fmaf(X[r * ldp + col], d0, dot);
            dot = fmaf(X[r * ldp + col + 1], d1, dot);
            if (r < qn)
              *reinterpret_cast<float2*>(dx + (int64_t)r * a.sdx.l + col) =
                  make_float2(d0, d1);
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          if (cq == 0) part[(t % tp) * Q + r] = dot;
        }
      }
      return tp;
    };
    const int n_col = P % 32 == 0 ? tiles(std::integral_constant<int, 4>())
                                  : tiles(std::integral_constant<int, 2>());
    __syncthreads();
    // dloga in the chunk: the reverse cumsum of <y, dy> - <xt, dxt>, two
    // tokens a lane; lane 0's first is the chunk's total
    if (warp == 0) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 2 * lane + u;
        float sx = 0.f;
        for (int ct = 0; ct < n_col; ++ct) sx += part[ct * Q + r];
        v[u] = ydy[r] - sx;
      }
      const float run = v[0] + v[1];
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      const float later = incl - run;
      float* dlo = a.dloga + (int64_t)(bi * a.H + h) * a.L + c0;
      if (2 * lane < qn) dlo[2 * lane] = run + later;
      if (2 * lane + 1 < qn) dlo[2 * lane + 1] = v[1] + later;
      if (lane == 0)
        a.totals[(int64_t)(bi * a.H + h) * a.nc + c] = incl;
    }
    __syncthreads();             // this head's tiles, W and part rewritten
  }
  const int64_t part_row = (int64_t)(bi * a.ng + grp) * a.L + c0;
  if (a.sum_b) store_bc(accB, a.dBp + part_row * N);
  if (a.sum_c) store_bc(accC, a.dCp + part_row * N);
}

// The finish: blocks [0, b·H) add to dloga the totals of the later chunks;
// blocks after them sum the partials of dB and dC over the head groups in
// order, into [b, 1, L, N].
__global__ void __launch_bounds__(kThreads) ssd_scan_bwd_finish(BwdArgs a,
                                                               int rows,
                                                               int b) {
  extern __shared__ float suffix[];            // [nc]
  if ((int)blockIdx.x < rows) {
    const float* tot = a.totals + (int64_t)blockIdx.x * a.nc;
    if (threadIdx.x == 0) {
      float run = 0.f;
      for (int c = a.nc - 1; c >= 0; --c) {
        suffix[c] = run;                       // the chunks after c
        run += tot[c];
      }
    }
    __syncthreads();
    float* dlo = a.dloga + (int64_t)blockIdx.x * a.L;
    for (int t = threadIdx.x; t < a.L; t += kThreads) dlo[t] += suffix[t / Q];
    return;
  }
  const int64_t n = (int64_t)a.L * a.N;
  const int64_t e = (int64_t)(blockIdx.x - rows) * kThreads + threadIdx.x;
  if (e >= b * n) return;
  const int64_t bi = e / n, i = e - bi * n;
  if (a.sum_b) {
    float s = 0.f;
    for (int k = 0; k < a.ng; ++k) s += a.dBp[(bi * a.ng + k) * n + i];
    a.dB[e] = s;
  }
  if (a.sum_c) {
    float s = 0.f;
    for (int k = 0; k < a.ng; ++k) s += a.dCp[(bi * a.ng + k) * n + i];
    a.dC[e] = s;
  }
}

template <typename TB, int NB>
int launch(const BwdArgs& a, int b, cudaStream_t stream) {
  const size_t s1 = smem_walk<TB>(a.P, a.N);
  const size_t s3 = smem_chunk<TB>(a.P, a.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_walk<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_scan_bwd_chunk<TB, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_bwd_walk<TB><<<dim3(b * a.H, 2), kThreads, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_bwd_chunk<TB, NB>
      <<<dim3(a.nc, b * a.ng), kThreads, s3, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t s4 = sizeof(float) * a.nc;
  err = cudaFuncSetAttribute(ssd_scan_bwd_finish,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s4);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = b * a.H;
  const int sums =
      a.sum_b || a.sum_c
          ? (int)(((int64_t)b * a.L * a.N + kThreads - 1) / kThreads)
          : 0;
  ssd_scan_bwd_finish<<<rows + sums, kThreads, s4, stream>>>(a, rows, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int dispatch(const BwdArgs& a, int b, cudaStream_t s) {
  switch (a.N) {
    case 16: return launch<TB, 1>(a, b, s);
    case 32: return launch<TB, 2>(a, b, s);
    case 64: return launch<TB, 4>(a, b, s);
    case 128: return launch<TB, 8>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Gradients of y = ssd(xt, loga, B, C) given dy: three launches on
// `stream` (the state walks, the chunks, the finish).  xt, y, dy, dxt [b, H, L,
// P], loga [b, H, L], f32, through strides[21] = the (batch, head,
// position) element strides of xt, loga, B, C, y, dy, dxt in that order,
// the last dimension of xt, y, dy, B, C and dxt contiguous; B, C [b, H, L,
// N] bf16 (bc_bf16 = 1) or f32, head stride 0 when shared.  dloga
// [b, H, L] f32 contiguous.  sum_b: dB [b, 1, L, N] f32, the per-head
// gradients summed over the heads; else [b, H, L, N] (sum_c for dC).
// Scratch: states, gstates [b, H, nc, N, P], totals [b, H, nc],
// dBp, dCp [b, ceil(H / 8), L, N] f32 (only with sum_b / sum_c), nc =
// ceil(L / 64).  N in {16, 32, 64, 128}, P a multiple of 16 up to 128.
// Returns the first CUDA error, 0 on success.
extern "C" int repro_ssd_scan_bwd(
    const void* xt, const void* loga, const void* B, const void* C,
    const void* y, const void* dy, void* dxt, void* dloga, void* dB,
    void* dC, void* dBp, void* dCp, void* states, void* gstates, void* totals,
    int bc_bf16, int sum_b, int sum_c, int b, int H,
    int L, int P, int N, const int64_t* st, void* stream) {
  if (b <= 0 || H <= 0 || L <= 0) return 0;
  if (P % 16 || P > 16 * kMaxColTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.xt = static_cast<const float*>(xt);
  a.loga = static_cast<const float*>(loga);
  a.B = B;
  a.C = C;
  a.y = static_cast<const float*>(y);
  a.dy = static_cast<const float*>(dy);
  a.dxt = static_cast<float*>(dxt);
  a.dloga = static_cast<float*>(dloga);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dBp = static_cast<float*>(dBp);
  a.dCp = static_cast<float*>(dCp);
  a.states = static_cast<float*>(states);
  a.gstates = static_cast<float*>(gstates);
  a.totals = static_cast<float*>(totals);
  a.sx = {st[0], st[1], st[2]};
  a.sa = {st[3], st[4], st[5]};
  a.sb = {st[6], st[7], st[8]};
  a.sc = {st[9], st[10], st[11]};
  a.sy = {st[12], st[13], st[14]};
  a.sdy = {st[15], st[16], st[17]};
  a.sdx = {st[18], st[19], st[20]};
  a.H = H;
  a.L = L;
  a.P = P;
  a.N = N;
  a.nc = (L + Q - 1) / Q;
  a.ng = (H + kHeadGroup - 1) / kHeadGroup;
  a.bc_shared = (H == 1 || (st[7] == 0 && st[10] == 0)) ? 1 : 0;
  a.sum_b = sum_b;
  a.sum_c = sum_c;
  auto vec = [](const void* p, const int64_t* s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 4 == 0 &&
           s[1] % 4 == 0 && s[2] % 4 == 0;
  };
  a.x_vec = vec(xt, st);
  a.dy_vec = vec(dy, st + 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bc_bf16 ? dispatch<__nv_bfloat16>(a, b, s) : dispatch<float>(a, b, s);
}

// Dynamic shared memory of the larger of the walk and the chunk pass.
extern "C" int64_t repro_ssd_scan_bwd_smem(int P, int N, int bc_bf16) {
  const size_t w = bc_bf16 ? smem_walk<__nv_bfloat16>(P, N)
                           : smem_walk<float>(P, N);
  const size_t c = bc_bf16 ? smem_chunk<__nv_bfloat16>(P, N)
                           : smem_chunk<float>(P, N);
  return static_cast<int64_t>(w > c ? w : c);
}
