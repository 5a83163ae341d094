// Helpers shared by the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): the 3xTF32 / bf16 warp products over mma.sync,
// global -> shared copies (batched loads, cp.async), the chunk's cumsum.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace ssd {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHeadGroup = 8;   // heads per block of the chunk passes
constexpr int kUnroll = 2;      // k-steps of a warp product unrolled
constexpr int Q = 64;           // tokens per chunk

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}


// acc[mi][nj] += A · B over one (16 MT) x (8 NT) output tile at (m0, n0),
// as MT x NT m16n8 tiles: A(m, k) = fa(m, k), B(k, n) = fb(k, n), k in
// [0, K), K a multiple of 8.  SA / SB: the operand is f32 and is split
// (3xTF32); otherwise its values are bf16, exact in tf32.  Each A fragment
// serves NT products and each B fragment MT.
template <bool SA, bool SB, int MT, int NT, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4], int m0, int n0,
                                     int K, FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll kUnroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m = m0 + 16 * mi + g;
      const float av[4] = {fa(m, k0 + c), fa(m + 8, k0 + c),
                           fa(m, k0 + c + 4), fa(m + 8, k0 + c + 4)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (SA) repro::split_tf32(av[i], ab[mi][i], as[mi][i]);
        else ab[mi][i] = __float_as_uint(av[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      const float bv[2] = {fb(k0 + c, n), fb(k0 + c + 4, n)};
      uint32_t bb[2], bs[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (SB) repro::split_tf32(bv[i], bb[i], bs[i]);
        else bb[i] = __float_as_uint(bv[i]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if constexpr (SB) repro::mma_tf32(acc[mi][j], ab[mi], bs);
        if constexpr (SA) repro::mma_tf32(acc[mi][j], as[mi], bb);
        repro::mma_tf32(acc[mi][j], ab[mi], bb);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;
}

constexpr int kBatch = 8;        // global loads a thread keeps in flight

// dst[r * ld + k] = src[r * sl + k] for r < rows, k < n, with rows from qn
// on read as zero.  The loads of a batch all issue before its stores: the
// compiler cannot tell the shared tile from the global source and would
// otherwise wait for each store before the next load.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t sl, int rows, int qn,
                                          int n) {
  const int total = rows * n;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads, r = i / n;
      v[u] = i < total && r < qn ? src[r * sl + (i - r * n)] : T(0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads, r = i / n;
      if (i < total) dst[r * ld + (i - r * n)] = v[u];
    }
  }
}

// asynchronous copies global -> shared (cp.async); a copy with ok false
// reads nothing and writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies but the newest group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// all of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [0, rows) x [0, n) of the f32 matrix src (row stride
// sl) into dst[r * ld + k], rows from qn on as zeros.  vec: 16-byte copies
// (n % 4 == 0, rows 16-byte aligned, ld % 4 == 0).
__device__ __forceinline__ void async_tile(float* dst, int ld,
                                           const float* src, int64_t sl,
                                           int rows, int qn, int n,
                                           bool vec) {
  if (vec) {
    const int n4 = n / 4, total = rows * n4;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / n4, k = 4 * (i - r * n4);
      cp_async16(dst + r * ld + k, r < qn ? src + r * sl + k : src, r < qn);
    }
  } else {
    const int total = rows * n;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / n, k = i - r * n;
      cp_async4(dst + r * ld + k, r < qn ? src + r * sl + k : src, r < qn);
    }
  }
}

// la[0, Q) <- its inclusive cumsum times scale; warp 0 only
__device__ __forceinline__ void cumsum(float* la, float scale) {
  constexpr int V = Q / 32;
  const int lane = threadIdx.x & 31;
  float v[V], run = 0.f;
#pragma unroll
  for (int t = 0; t < V; ++t) {
    run += la[lane * V + t];
    v[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const float excl = incl - run;
#pragma unroll
  for (int t = 0; t < V; ++t) la[lane * V + t] = (v[t] + excl) * scale;
}

}  // namespace ssd
}  // namespace repro
