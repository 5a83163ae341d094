// Mamba-2 chunked SSD scan (arXiv:2405.21060), one block per batch·head.
//
// Replaces repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel (Pallas, body
// _ssd_kernel, grid (batch·heads, chunks) with the chunk axis sequential and
// the f32 state S [N, P] in VMEM scratch; ops.py pads L to a chunk
// multiple).  Here the sequential grid axis becomes a loop inside the block:
// each block walks its sequence chunk by chunk (Q = 64 tokens) with S in
// shared memory, and per chunk computes
//
//   l      = inclusive cumsum of loga over the chunk (a warp scan)
//   W[i,j] = (j <= i) ? (C_i · B_j) exp(l_i - l_j) : 0
//   y_i    = exp(l_i) (C_i @ S) + sum_j W[i,j] xt_j
//   S     <- exp(l_last) S + sum_j exp(l_last - l_j) B_j ⊗ xt_j
//
// all in f32.  A ragged last chunk is masked in the kernel (rows past L load
// as zero with loga 0, so they move nothing and are not stored): no padding
// copy.  Every tensor is read through (batch, head, position) strides, so
// the model's B and C, shared by all heads, come in as a stride-0 expand
// and are never materialized per head, and xt/y stay in the model's
// [b, L, H, P] layout.
//
// What bounds it on an H100: at the prefill path's shape (b·H = 256,
// L = 4096, P = N = 64; xt, loga, y f32, B/C bf16 shared over heads) the
// function must move 0.54 GB (xt read, y written), 0.16 ms at 3.35 TB/s,
// and the per-token recurrence needs 4·L·N·P flops a head, 17 GFLOP,
// 0.26 ms at the 67 TFLOP/s f32 rate: operations.  This first kernel does
// about twice that work in the chunked form with scalar f32 FMAs from
// shared memory (no tensor cores), and only 256 blocks run, each
// sequential over 64 chunks: it is bound by shared-memory traffic and
// parallelism, not by the card's peaks.  Tensor-core tiles and a parallel
// pass over chunks (state passing) are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;           // chunk length (the warp scan takes 64)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {                 // element strides of (batch, head, position)
  int64_t b, h, l;
};

template <typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_scan(const float* __restrict__ xt, const float* __restrict__ loga,
         const TB* __restrict__ Bm, const TB* __restrict__ Cm,
         float* __restrict__ y, int H, int L, int P, int N, Strides sx,
         Strides sa, Strides sb, Strides sc, Strides sy) {
  extern __shared__ float smem[];
  const int NP = N + 1;          // padded row of B/C: no bank conflicts
  float* S = smem;               // [N][P] carried state
  float* X = S + N * P;          // [Q][P] xt chunk
  float* Bs = X + kQ * P;        // [Q][N+1]
  float* Cs = Bs + kQ * NP;      // [Q][N+1]
  float* W = Cs + kQ * NP;       // [Q][Q+1] decayed scores
  float* l = W + kQ * (kQ + 1);  // [Q] cumulative log-decay
  float* el = l + kQ;            // [Q] exp(l_i)
  float* ed = el + kQ;           // [Q] exp(l_last - l_j)

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  xt += bi * sx.b + hi * sx.h;
  loga += bi * sa.b + hi * sa.h;
  Bm += bi * sb.b + hi * sb.h;
  Cm += bi * sc.b + hi * sc.h;
  y += bi * sy.b + hi * sy.h;

  for (int i = tid; i < N * P; i += kThreads) S[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += kQ) {
    const int qn = min(kQ, L - c0);
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      X[i] = r < qn ? xt[(c0 + r) * sx.l + p] : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      Bs[r * NP + n] = r < qn ? to_f(Bm[(c0 + r) * sb.l + n]) : 0.f;
      Cs[r * NP + n] = r < qn ? to_f(Cm[(c0 + r) * sc.l + n]) : 0.f;
    }
    if (tid < kQ) l[tid] = tid < qn ? loga[(c0 + tid) * sa.l] : 0.f;
    __syncthreads();

    if (tid < 32) {              // inclusive scan of 64 values, 2 per lane
      const float a = l[2 * tid], s = a + l[2 * tid + 1];
      float incl = s;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float excl = incl - s;
      l[2 * tid] = excl + a;
      l[2 * tid + 1] = incl;
    }
    __syncthreads();
    if (tid < kQ) {
      el[tid] = expf(l[tid]);
      ed[tid] = expf(l[kQ - 1] - l[tid]);
    }
    for (int idx = tid; idx < kQ * kQ; idx += kThreads) {
      const int i = idx / kQ, j = idx - i * kQ;
      float w = 0.f;
      if (j <= i) {
        const float* ci = Cs + i * NP;
        const float* bj = Bs + j * NP;
        for (int n = 0; n < N; ++n) w = fmaf(ci[n], bj[n], w);
        w *= expf(l[i] - l[j]);
      }
      W[i * (kQ + 1) + j] = w;
    }
    __syncthreads();

    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int i = idx / P, p = idx - i * P;
      const float* ci = Cs + i * NP;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], S[n * P + p], inter);
      const float* wi = W + i * (kQ + 1);
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(wi[j], X[j * P + p], intra);
      if (i < qn) y[(c0 + i) * sy.l + p] = el[i] * inter + intra;
    }
    __syncthreads();

    const float elast = el[kQ - 1];
    for (int idx = tid; idx < N * P; idx += kThreads) {
      const int n = idx / P, p = idx - n * P;
      float acc = 0.f;
      for (int j = 0; j < kQ; ++j)
        acc = fmaf(Bs[j * NP + n] * ed[j], X[j * P + p], acc);
      S[idx] = elast * S[idx] + acc;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) * (size_t)(N * P + kQ * P + 2 * kQ * (N + 1) +
                                  kQ * (kQ + 1) + 3 * kQ);
}

template <typename TB>
int launch(const void* xt, const void* loga, const void* B, const void* C,
           void* y, int BH, int H, int L, int P, int N, const int64_t* st,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sx{st[0], st[1], st[2]}, sa{st[3], st[4], st[5]},
      sb{st[6], st[7], st[8]}, sc{st[9], st[10], st[11]},
      sy{st[12], st[13], st[14]};
  ssd_scan<TB><<<BH, kThreads, smem, stream>>>(
      static_cast<const float*>(xt), static_cast<const float*>(loga),
      static_cast<const TB*>(B), static_cast<const TB*>(C),
      static_cast<float*>(y), H, L, P, N, sx, sa, sb, sc, sy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xt, loga, y: f32; B, C: bf16 (bc_bf16 = 1) or f32.  Block b·H + h reads
// batch b, head h through strides[15] = (batch, head, position) element
// strides of xt, loga, B, C, y, in that order; the last dimension of xt,
// B, C and y is contiguous.  Returns the first CUDA error, 0 on success.
extern "C" int repro_ssd_scan(const void* xt, const void* loga,
                              const void* B, const void* C, void* y,
                              int bc_bf16, int BH, int H, int L, int P,
                              int N, const int64_t* strides, void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bc_bf16 ? launch<__nv_bfloat16>(xt, loga, B, C, y, BH, H, L, P, N,
                                         strides, s)
                 : launch<float>(xt, loga, B, C, y, BH, H, L, P, N, strides,
                                 s);
}

// Dynamic shared memory the kernel needs for head dim P and state N.
extern "C" int64_t repro_ssd_scan_smem(int P, int N) {
  return static_cast<int64_t>(smem_bytes(P, N));
}
