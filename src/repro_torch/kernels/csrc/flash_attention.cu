// Flash attention forward (online softmax), causal and sliding window, GQA.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (Pallas, body _fa_kernel; grid (batch·heads, q blocks, kv blocks) with
// the kv axis sequential and m, l, acc in VMEM scratch) and the GQA fold of
// its wrapper, ops.py:_flash_attention (one launch per query group).  Here
// one block takes one (batch·head, 64-query tile) and loops over 64-key
// tiles in order, keeping the running max m, normalizer l and accumulator
// acc of its rows in registers (f32); Q, the current K/V tile and the
// probabilities sit in shared memory.  The loop takes the place of the
// TPU's sequential kv grid axis.
//
// Masks come from absolute positions, queries aligned to the END of the
// keys (off = Lk - Lq): causal keeps kpos <= qpos, a window keeps
// kpos > qpos - window.  Key tiles that the mask empties for the whole
// query tile are never visited (the loop bounds), which halves causal
// work and leaves O(window) keys per query tile.  A ragged edge (Lq or Lk
// not a multiple of 64) is masked here, not padded.  A row that sees no
// key writes 0 (l == 0).  Query head h reads kv head h / (Hq / Hkv)
// directly, so GQA needs no per-group launches and no copies; every
// tensor is read through (batch, head, position) strides, so the model's
// [B, L, H, D] projections are used as they are.
//
// What bounds it on an H100: at the prefill path's shape (B = 4, H = 32,
// L = 4096, D = 64, bf16, causal) the function needs 275 GFLOP (4·D per
// visible query-key pair), 0.28 ms at the 989 TFLOP/s bf16 tensor-core
// rate, and moves 268 MB, 0.08 ms at 3.35 TB/s: operations.  This first
// kernel computes with scalar f32 FMAs from shared memory (each thread a
// 4 x 4 score tile and 4 x D/16 outputs), so shared-memory bandwidth and
// the 67 TFLOP/s f32 rate bound it, far above the tensor-core bound.
// mma/wgmma tiles and a TMA ring are later work.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kBQ = 64;
constexpr int kBK = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {                 // element strides of (batch, head, position)
  int64_t b, h, l;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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

// q: [B, Hq, Lq, D]; k, v: [B, Hkv, Lk, D]; o: [B, Hq, Lq, D]; all bf16
// (is_bf16 = 1) or all f32, each read through strides[12] = the (batch,
// head, position) element strides of q, k, v, o in that order, with the
// head dim contiguous.  D in {32, 64, 128}; window <= 0 means none.
// Returns the first CUDA error, 0 on success.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int is_bf16,
                                     int B, int Hq, int Hkv, int Lq, int Lk,
                                     int D, int causal, int window,
                                     const int64_t* strides, void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
