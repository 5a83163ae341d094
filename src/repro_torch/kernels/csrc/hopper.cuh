// Hopper (sm_90a) building blocks shared by flash_attention.cu and
// flash_attention_bwd.cu: TMA tensor maps and loads, mbarriers, wgmma
// shared-memory descriptors and products, and the bf16 hi + lo fragments
// of an f32 accumulator.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "common.cuh"

namespace repro {

struct TmaTensor {               // one 4-D map (D, then h, l, b by stride)
  CUtensorMap map;
  int perm[3];                   // map dim 1 + i holds logical dim perm[i]:
};                               // 0 head, 1 position, 2 batch

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(n)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// spin until the phase of parity `parity` has completed; a wait that
// never completes traps (a launch error) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0, spins = 0;
  do {
    if (++spins == (1u << 30)) asm volatile("trap;");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ int pick(int which, int h, int l, int b) {
  return which == 0 ? h : which == 1 ? l : b;
}
// one box of `t` (64 columns by the map's box of positions) at (d0, head
// h, position l, batch b) into dst
__device__ __forceinline__ void tma_load(void* dst, const TmaTensor& t,
                                         uint64_t* bar, int d0, int h, int l,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&t.map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(pick(t.perm[0], h, l, b)), "r"(pick(t.perm[1], h, l, b)),
      "r"(pick(t.perm[2], h, l, b))
      : "memory");
}
// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar as TMA does
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles of 64-wide
// (128-byte) rows, 8-row groups 1,024 bytes apart (SBO).  K-major: the
// reduction dim runs along the row (Q and K in S = Q·Kᵀ).  MN-major: it
// runs down the rows, and LBO is the step to the next 64 columns, one
// [rows x 64] box: 64 rows (LBO 512 x 16 bytes) unless stated (V in
// O = P·V).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint64_t box_rows = 64) {
  return ((addr & 0x3FFFFu) >> 4) | ((box_rows * 8) << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the newest committed group have completed
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accesses of r across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A·B, m64n32k16, A and B from shared memory (K-major, 128-byte
// swizzle); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A·B, m64n64k16, A and B from shared memory (K-major, 128-byte
// swizzle); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A·B, m64n64k16, A from registers (4 x bf16x2 a thread), B from
// shared memory MN-major (transposed) with 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, m64n128k16, A from registers (4 x bf16x2 a thread), B from
// shared memory MN-major (transposed) with 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B with N = D (64 or 128), A from registers, B MN-major
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// 2^x on the special-function unit (one instruction; flushes subnormal
// results to 0, and 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// An m64nN f32 accumulator of a warpgroup (N = 8 NK) as wgmma A fragments
// of its columns, 16 a fragment: x = x_hi + x_lo with x_hi = bf16(x) and
// x_lo = bf16(x - x_hi), so a product of the two parts keeps about f32's
// accuracy.  Accumulator i sits at row 8 ((i >> 1) & 1) of the thread's
// pair, column 8 (i >> 2) + 2 c + (i & 1), as the A fragment wants it.
template <int NK>
__device__ __forceinline__ void to_frags(const float (&x)[4 * NK],
                                         uint32_t (&hi)[NK / 2][4],
                                         uint32_t (&lo)[NK / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][r] = bf16x2_bits(h2);
      lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded,
// so this library needs no link against it
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 4-D bf16 map over a [B, H, L, D] view with element strides st = (b, h,
// l) and a contiguous D: dims D, then h, l, b in order of stride (a dim of
// size 1 last, its stride made valid), boxes of 64 x box_rows (D x
// positions) under 128-byte swizzle.  Out-of-bounds boxes read as zero.
// False if the map is refused.  cuTensorMapEncodeTiled encodes only with
// a CUDA context current in the calling thread, which a thread that has
// made no CUDA call yet (autograd's backward thread, a caller's own
// thread) lacks: cudaFree(nullptr) makes the primary context current.
inline bool encode(TmaTensor& t, const void* ptr, int B, int H, int L, int D,
                   const int64_t* st, int box_rows = 64) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr || cudaFree(nullptr) != cudaSuccess) return false;
  const int64_t size[3] = {H, L, B};
  const int64_t stride[3] = {st[1], st[2], st[0]};
  int order[3] = {0, 1, 2};
  auto key = [&](int i) {
    return size[i] == 1 ? INT64_MAX : stride[i];
  };
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key(order[j]) < key(order[i])) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t bytes[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  cuuint64_t prev = (cuuint64_t)D * 2;
  for (int i = 0; i < 3; ++i) {
    const int d = order[i];
    t.perm[i] = d;
    dims[i + 1] = (cuuint64_t)size[d];
    bytes[i] = size[d] == 1 ? prev : (cuuint64_t)stride[d] * 2;
    prev = bytes[i] * dims[i + 1];
    if (d == 1) box[i + 1] = (cuuint32_t)box_rows;
  }
  return fn(&t.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, bytes, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro
