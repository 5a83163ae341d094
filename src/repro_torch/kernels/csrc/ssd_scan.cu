// Mamba-2 chunked SSD scan (arXiv:2405.21060), chunk-parallel on tensor
// cores: three kernel launches per call.
//
// Replaces repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel (Pallas, body
// _ssd_kernel, grid (batch·heads, chunks) with the chunk axis sequential
// and the f32 state S [N, P] in VMEM scratch; ops.py pads L to a chunk
// multiple).  A sequential chunk axis leaves most of 132 SMs idle, so the
// work is split as in Mamba-2's own GPU decomposition (paper §7), with l
// the in-chunk inclusive cumsum of loga and Q the chunk length:
//
//   1. ssd_scan_states, one block per (batch, chunk, group of heads):
//      s_c = (B ∘ exp(l_Q - l))ᵀ · xt  [N, P] into the scratch
//      states [b, H, n_chunks, N, P] f32, and exp(l_Q) into decay.
//   2. ssd_scan_pass, one thread per (batch·head, state element), walking
//      the chunks in order: S_c = exp(l_Q,c) S_{c-1} + s_c.  It writes in
//      place over the scratch: slot c ends holding S_{c-1}, the state
//      that enters chunk c (0 for the first).
//   3. ssd_scan_outputs, one block per (batch, chunk, group of heads):
//      y = exp(l) ∘ (C · S_{c-1})
//          + (tril(C Bᵀ) ∘ exp(l_i - l_j)) · xt.
//
// B and C are shared by every head in the model (a stride-0 expand along
// H): then a block loads them once for its group of heads, and computes
// C·Bᵀ once, applying each head's decay as it reads the product.  Per-head
// B and C (head stride not 0) are reloaded for each head.  Products run on
// tensor cores with mma.sync: C·Bᵀ from bf16 B and C in bf16 m16n8k16 (the
// products are exact in f32); every product with an f32 operand in 3xTF32
// on m16n8k8 (a = big + small, a·b ≈ big·big + big·small + small·big,
// about f32's accuracy; a bf16 operand is exact in tf32, no small part).
// A ragged last chunk is masked here (rows past L load as zero with loga 0,
// so they move nothing, and are not stored).  Every tensor is read through
// (batch, head, position) strides, so xt and y stay in the model's
// [b, L, H, P] layout.  The kernels allocate nothing: the wrapper passes
// the scratch.
//
// What bounds it on an H100: at the prefill path's shape (b·H = 256,
// L = 4096, P = N = 64; xt, loga, y f32, B/C bf16 shared over heads) the
// function must move 0.54 GB (xt read, y written), 0.16 ms at 3.35 TB/s,
// and the per-token recurrence needs 4·L·N·P flops a head, 17 GFLOP,
// which run here on tensor cores in 3xTF32 (three tf32 products per f32
// product: 495 / 3 = 165 TFLOP/s), 0.10 ms: its bound is 0.16 ms, bytes.
// The design adds scratch traffic: the states are written, read and
// written by the pass, and read again (4 x 268 MB at Q = 64), and xt is
// read twice, so device memory is its floor (about 0.56 ms for the three
// launches).  What it does about latency, which measured above that
// floor: passes 1 and 3 walk their group of heads with the next
// head's tiles in flight (cp.async into a second buffer) while the current
// one computes; warp tiles are 32 x 16 (pass 1) and 16 x 32 (pass 3), so a
// fragment split into tf32 serves two or four products; the pass keeps
// eight chunks' loads in flight a thread.  Q = 64: at Q = 128 the pass
// moves half as much, but pass 3's in-chunk product doubles and its
// shared memory allows one block an SM (measured slower, so only 64 is
// built).
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ssd_common.cuh"

namespace {

using namespace repro::ssd;
using repro::Strides;
using repro::to_f;

struct Args {
  const float* xt;
  const float* loga;
  const void* B;
  const void* C;
  float* y;
  float* states;                // [b, H, nc, N, P]
  float* decay;                 // [b, H, nc]
  Strides sx, sa, sb, sc, sy;
  int H, L, P, N, nc;
  int bc_shared;                // B and C have head stride 0
  int x_vec;                    // xt rows 16-byte aligned: 16-byte copies
};

// Row strides (elements) of the shared-memory tiles, padded so that the
// fragment loads below hit distinct banks.
template <typename TB>
__host__ __device__ constexpr int ld_bc(int N) {
  return std::is_same<TB, float>::value ? N + 4 : N + 8;
}
__host__ __device__ constexpr int ld_x(int P) { return P + 8; }

template <typename TB>
size_t smem_states(int P, int N) {
  return align16(sizeof(TB) * Q * (N + 8)) +
         sizeof(float) * (2 * Q * ld_x(P) + 3 * Q);
}

template <typename TB>
size_t smem_outputs(int P, int N) {
  return 2 * align16(sizeof(TB) * Q * ld_bc<TB>(N)) +
         sizeof(float) * (Q * (Q + 4) + 2 * (Q * ld_x(P) + N * ld_x(P) + Q));
}

// start copying loga of head h over the chunk into la (0 past qn)
__device__ __forceinline__ void async_loga(float* la, const Args& a, int bi,
                                           int h, int c0, int qn) {
  if (threadIdx.x < Q) {
    const bool ok = threadIdx.x < qn;
    const float* src = a.loga + bi * a.sa.b + h * a.sa.h;
    cp_async4(la + threadIdx.x, ok ? src + (c0 + threadIdx.x) * a.sa.l : src,
              ok);
  }
}

// Pass 1: each chunk's own state s_c = (B ∘ exp(l_Q - l))ᵀ · xt.
template <typename TB>
__global__ void __launch_bounds__(kThreads) ssd_scan_states(Args a) {
  extern __shared__ float4 smem4[];
  const int P = a.P, N = a.N, ldb = N + 8, ldx = ld_x(P);
  TB* Bs = reinterpret_cast<TB*>(smem4);                        // [Q][ldb]
  float* X = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + align16(sizeof(TB) * Q * ldb));
  float* la = X + 2 * Q * ldx;                                  // [2][Q]
  float* w = la + 2 * Q;                                        // [Q]
  const int nhg = (a.H + kHeadGroup - 1) / kHeadGroup;
  const int c = blockIdx.x, bi = blockIdx.y / nhg;
  const int h0 = (blockIdx.y % nhg) * kHeadGroup;
  const int h_end = min(h0 + kHeadGroup, a.H);
  const int c0 = c * Q, qn = min(Q, a.L - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  const TB* Bg = static_cast<const TB*>(a.B) + bi * a.sb.b + c0 * a.sb.l;
  constexpr bool kSplitB = std::is_same<TB, float>::value;
  // head h's xt and loga go to buffer (h - h0) & 1, one head ahead
  auto issue = [&](int h) {
    const int buf = (h - h0) & 1;
    async_tile(X + buf * Q * ldx, ldx,
               a.xt + bi * a.sx.b + h * a.sx.h + c0 * a.sx.l, a.sx.l, Q, qn,
               P, a.x_vec);
    async_loga(la + buf * Q, a, bi, h, c0, qn);
    cp_async_commit();
  };

  issue(h0);
  for (int h = h0; h < h_end; ++h) {
    float* Xh = X + ((h - h0) & 1) * Q * ldx;
    float* lh = la + ((h - h0) & 1) * Q;
    if (h == h0 || !a.bc_shared)
      load_tile(Bs, ldb, Bg + h * a.sb.h, a.sb.l, Q, qn, N);
    if (h + 1 < h_end) issue(h + 1);
    else cp_async_commit();      // an empty group: one group per head
    cp_async_wait_prev();
    __syncthreads();
    if (threadIdx.x < 32) cumsum(lh, 1.f);
    __syncthreads();
    const float llast = lh[Q - 1];
    if (threadIdx.x < Q) w[threadIdx.x] = expf(llast - lh[threadIdx.x]);
    __syncthreads();
    for (int i = threadIdx.x; i < Q * P; i += kThreads) {
      const int r = i / P;
      Xh[r * ldx + (i - r * P)] *= w[r];
    }
    __syncthreads();
    float* s = a.states + ((int64_t)(bi * a.H + h) * a.nc + c) * N * P;
    // warp tiles of (16 MT) x 16: an X fragment serves MT products
    auto tiles = [&](auto mt) {
      constexpr int MT = decltype(mt)::value;
      const int tp = P / 16, n_t = N / (16 * MT) * tp;
      for (int t = warp; t < n_t; t += kWarps) {
        const int m0 = (t / tp) * 16 * MT, n0 = (t % tp) * 16;
        float acc[MT][2][4];
        zero(acc);
        gemm<kSplitB, true>(
            acc, m0, n0, Q,
            [&](int m, int k) { return to_f(Bs[k * ldb + m]); },
            [&](int k, int n) { return Xh[k * ldx + n]; });
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* o = s + (m0 + 16 * mi + g) * P + n0 + 8 * j + 2 * cq;
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[mi][j][0], acc[mi][j][1]);
            *reinterpret_cast<float2*>(o + 8 * P) =
                make_float2(acc[mi][j][2], acc[mi][j][3]);
          }
      }
    };
    if (N % 32 == 0) tiles(std::integral_constant<int, 2>());
    else tiles(std::integral_constant<int, 1>());
    if (threadIdx.x == 0)
      a.decay[(int64_t)(bi * a.H + h) * a.nc + c] = expf(llast);
    __syncthreads();             // this buffer, w and Bs are rewritten next
  }
}

// Pass 2: S_c = exp(l_Q,c) S_{c-1} + s_c in chunk order, in place: slot c
// of states ends holding S_{c-1}.  One thread per 4 elements of one
// (batch·head); a batch of chunks is loaded before any is stored, so the
// loads overlap.
__global__ void __launch_bounds__(kThreads)
ssd_scan_pass(float4* __restrict__ states, const float* __restrict__ decay,
              int nc, int NP4) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP4) return;
  float4* s = states + (int64_t)blockIdx.y * nc * NP4 + e;
  const float* d = decay + (int64_t)blockIdx.y * nc;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float4 t[kBatch];
    float dc[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u < nc) {
        t[u] = s[(int64_t)(c0 + u) * NP4];
        dc[u] = d[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u < nc) {
        s[(int64_t)(c0 + u) * NP4] = S;
        S = make_float4(dc[u] * S.x + t[u].x, dc[u] * S.y + t[u].y,
                        dc[u] * S.z + t[u].z, dc[u] * S.w + t[u].w);
      }
  }
}

// Pass 3: y = exp(l) ∘ (C · S_{c-1})
//            + (tril(C Bᵀ) ∘ exp(l_i - l_j)) · xt.
template <typename TB>
__global__ void __launch_bounds__(kThreads) ssd_scan_outputs(Args a) {
  extern __shared__ float4 smem4[];
  const int P = a.P, N = a.N, ldb = ld_bc<TB>(N), ldx = ld_x(P);
  constexpr int ldg = Q + 4;
  char* base = reinterpret_cast<char*>(smem4);
  TB* Cs = reinterpret_cast<TB*>(base);                         // [Q][ldb]
  TB* Bs = reinterpret_cast<TB*>(base + align16(sizeof(TB) * Q * ldb));
  float* G = reinterpret_cast<float*>(
      base + 2 * align16(sizeof(TB) * Q * ldb));                // [Q][ldg]
  float* X = G + Q * ldg;                                       // [2][Q][ldx]
  float* Sp = X + 2 * Q * ldx;                                  // [2][N][ldx]
  float* la = Sp + 2 * N * ldx;                                 // [2][Q]
  const int nhg = (a.H + kHeadGroup - 1) / kHeadGroup;
  const int c = blockIdx.x, bi = blockIdx.y / nhg;
  const int h0 = (blockIdx.y % nhg) * kHeadGroup;
  const int h_end = min(h0 + kHeadGroup, a.H);
  const int c0 = c * Q, qn = min(Q, a.L - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  const TB* Bg = static_cast<const TB*>(a.B) + bi * a.sb.b + c0 * a.sb.l;
  const TB* Cg = static_cast<const TB*>(a.C) + bi * a.sc.b + c0 * a.sc.l;
  // head h's xt, entering state and loga go to buffer (h - h0) & 1, one
  // head ahead
  auto issue = [&](int h) {
    const int buf = (h - h0) & 1;
    async_tile(X + buf * Q * ldx, ldx,
               a.xt + bi * a.sx.b + h * a.sx.h + c0 * a.sx.l, a.sx.l, Q, qn,
               P, a.x_vec);
    async_tile(Sp + buf * N * ldx, ldx,
               a.states + ((int64_t)(bi * a.H + h) * a.nc + c) * N * P, P, N,
               N, P, true);
    async_loga(la + buf * Q, a, bi, h, c0, qn);
    cp_async_commit();
  };
  constexpr bool kF32 = std::is_same<TB, float>::value;
  constexpr int tq = Q / 16;

  issue(h0);
  for (int h = h0; h < h_end; ++h) {
    const int buf = (h - h0) & 1;
    const float* Xh = X + buf * Q * ldx;
    const float* Sh = Sp + buf * N * ldx;
    float* lh = la + buf * Q;
    if (h == h0 || !a.bc_shared) {
      load_tile(Bs, ldb, Bg + h * a.sb.h, a.sb.l, Q, qn, N);
      load_tile(Cs, ldb, Cg + h * a.sc.h, a.sc.l, Q, qn, N);
      __syncthreads();
      // G = C Bᵀ on and below the diagonal's 16 x 16 tiles
      for (int t = warp; t < tq * tq; t += kWarps) {
        const int mi = t / tq, ni = t % tq;
        if (ni > mi) continue;
        const int m0 = mi * 16, n0 = ni * 16;
        float acc[1][2][4];
        zero(acc);
        if constexpr (kF32) {
          gemm<true, true>(
              acc, m0, n0, N,
              [&](int m, int k) { return Cs[m * ldb + k]; },
              [&](int k, int n) { return Bs[n * ldb + k]; });
        } else {
          for (int k0 = 0; k0 < N; k0 += 16) {
            auto pair = [&](const TB* t0, int r, int k) {
              return *reinterpret_cast<const uint32_t*>(t0 + r * ldb + k);
            };
            const uint32_t af[4] = {pair(Cs, m0 + g, k0 + 2 * cq),
                                    pair(Cs, m0 + g + 8, k0 + 2 * cq),
                                    pair(Cs, m0 + g, k0 + 2 * cq + 8),
                                    pair(Cs, m0 + g + 8, k0 + 2 * cq + 8)};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = n0 + 8 * j + g;
              const uint32_t bf[2] = {pair(Bs, n, k0 + 2 * cq),
                                      pair(Bs, n, k0 + 2 * cq + 8)};
              repro::mma_bf16(acc[0][j], af, bf);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + 8 * j + 2 * cq;
          *reinterpret_cast<float2*>(G + (m0 + g) * ldg + col) =
              make_float2(acc[0][j][0], acc[0][j][1]);
          *reinterpret_cast<float2*>(G + (m0 + g + 8) * ldg + col) =
              make_float2(acc[0][j][2], acc[0][j][3]);
        }
      }
    }
    if (h + 1 < h_end) issue(h + 1);
    else cp_async_commit();      // an empty group: one group per head
    cp_async_wait_prev();
    __syncthreads();
    // l in log2 units: the decays below are exp2 of differences
    if (threadIdx.x < 32) cumsum(lh, 1.4426950408889634f);
    __syncthreads();
    float* yo = a.y + bi * a.sy.b + h * a.sy.h + c0 * a.sy.l;
    // warp tiles of 16 x (8 NT): a W or C fragment serves NT products
    auto tiles = [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      const int tp = P / (8 * NT), n_t = tq * tp;
      // tiles in row order, every other round of kWarps reversed, so that
      // each warp's intra work (16 (row tile + 1) keys) sums to the same
      for (int round = 0; round * kWarps < n_t; ++round) {
        const int t =
            round * kWarps + (round & 1 ? kWarps - 1 - warp : warp);
        if (t >= n_t) continue;
        const int m0 = (t / tp) * 16, n0 = (t % tp) * 8 * NT;
        float intra[1][NT][4], inter[1][NT][4];
        zero(intra);
        zero(inter);
        // keys j <= i < m0 + 16 only: the rest of W is 0
        gemm<true, true>(
            intra, m0, n0, m0 + 16,
            [&](int i, int j) {
              return j <= i ? G[i * ldg + j] * exp2f(lh[i] - lh[j]) : 0.f;
            },
            [&](int k, int n) { return Xh[k * ldx + n]; });
        gemm<kF32, true>(
            inter, m0, n0, N,
            [&](int i, int k) { return to_f(Cs[i * ldb + k]); },
            [&](int k, int n) { return Sh[k * ldx + n]; });
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + g + 8 * half;
          if (r >= qn) continue;
          const float el = exp2f(lh[r]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            *reinterpret_cast<float2*>(yo + r * a.sy.l + n0 + 8 * j +
                                       2 * cq) =
                make_float2(el * inter[0][j][2 * half] +
                                intra[0][j][2 * half],
                            el * inter[0][j][2 * half + 1] +
                                intra[0][j][2 * half + 1]);
        }
      }
    };
    if (P % 32 == 0) tiles(std::integral_constant<int, 4>());
    else tiles(std::integral_constant<int, 2>());
    __syncthreads();             // this buffer (and B, C, G) rewritten next
  }
}

template <typename TB>
size_t smem_bytes(int P, int N) {
  const size_t s1 = smem_states<TB>(P, N), s3 = smem_outputs<TB>(P, N);
  return s1 > s3 ? s1 : s3;
}

template <typename TB>
int launch(const Args& a, int b, cudaStream_t stream) {
  const size_t s1 = smem_states<TB>(a.P, a.N);
  const size_t s3 = smem_outputs<TB>(a.P, a.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_states<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_scan_outputs<TB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nhg = (a.H + kHeadGroup - 1) / kHeadGroup;
  const dim3 grid(a.nc, b * nhg);
  ssd_scan_states<TB><<<grid, kThreads, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NP4 = a.N * a.P / 4;
  ssd_scan_pass<<<dim3((NP4 + kThreads - 1) / kThreads, b * a.H), kThreads,
                  0, stream>>>(reinterpret_cast<float4*>(a.states), a.decay,
                               a.nc, NP4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_outputs<TB><<<grid, kThreads, s3, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call, three launches on `stream` (chunk states, state passing,
// outputs).  xt, loga, y: f32; B, C: bf16 (bc_bf16 = 1) or f32; batch b,
// head h read through strides[15] = (batch, head, position) element
// strides of xt, loga, B, C, y, in that order, with the last dimension of
// xt, B, C and y contiguous.  states [b, H, nc, N, P] and decay [b, H, nc]
// f32 are the caller's scratch, nc = ceil(L / 64).  P and N multiples of
// 16.  Returns the first CUDA error, 0 on success.
extern "C" int repro_ssd_scan(const void* xt, const void* loga,
                              const void* B, const void* C, void* y,
                              void* states, void* decay, int bc_bf16, int b,
                              int H, int L, int P, int N,
                              const int64_t* st, void* stream) {
  if (b <= 0 || H <= 0 || L <= 0) return 0;
  if (P % 16 || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.xt = static_cast<const float*>(xt);
  a.loga = static_cast<const float*>(loga);
  a.B = B;
  a.C = C;
  a.y = static_cast<float*>(y);
  a.states = static_cast<float*>(states);
  a.decay = static_cast<float*>(decay);
  a.sx = {st[0], st[1], st[2]};
  a.sa = {st[3], st[4], st[5]};
  a.sb = {st[6], st[7], st[8]};
  a.sc = {st[9], st[10], st[11]};
  a.sy = {st[12], st[13], st[14]};
  a.H = H;
  a.L = L;
  a.P = P;
  a.N = N;
  a.nc = (L + Q - 1) / Q;
  a.bc_shared = (H == 1 || (st[7] == 0 && st[10] == 0)) ? 1 : 0;
  a.x_vec = reinterpret_cast<uintptr_t>(xt) % 16 == 0 && st[0] % 4 == 0 &&
            st[1] % 4 == 0 && st[2] % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bc_bf16 ? launch<__nv_bfloat16>(a, b, s) : launch<float>(a, b, s);
}

// Dynamic shared memory the larger of passes 1 and 3 needs.
extern "C" int64_t repro_ssd_scan_smem(int P, int N, int bc_bf16) {
  return static_cast<int64_t>(bc_bf16 ? smem_bytes<__nv_bfloat16>(P, N)
                                      : smem_bytes<float>(P, N));
}
