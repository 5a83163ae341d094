// FIFO position assignment (SKUEUE Stages 1-3) as a min-plus prefix scan.
//
// Replaces repro/kernels/segscan/kernel.py:queue_scan_kernel, the Pallas
// two-phase scan over (8, 128) tiles (_totals_kernel, _scan_kernel, and the
// carry scan in jnp between them).  Op i carries the transform T(A, B, C):
//   valid ENQ (0, INF, 1), valid DEQ (1, 1, 0), invalid (0, INF, 0) = identity
// composed with (earlier ; later) = (A1+A2, min(B1+A2, C1+B2, INF), C1+C2).
// The compose is associative but NOT commutative: every combine below takes
// the earlier operand first.  With A, C >= 0 the INF saturation makes every
// bracketing give the same integers, so the result is bit-identical to the
// reference's scan whatever the tree shape.
//
// What bounds it on an H100: memory.  Each op reads 2 bytes (is_enq, valid
// as bytes) and writes 5 (int32 position, bool matched): 7 B/op, so 16 M
// ops move 117 MB, 35 us at 3.35 TB/s.  The arithmetic is a few integer
// ops per element.  A 65,536-op wave (64 blocks) is far below the card's
// width and is bound by launch latency instead.
//
// Design, simple and right first: three launches.
//   1. block_totals: one op per thread; warp __shfl_up_sync scans, then a
//      combine of the 32 warp totals; each block writes its total.
//   2. carry_scan: ONE block scans the block totals exclusively, looping
//      over chunks of 1024 with a running carry (so n = 2^24 works), and
//      writes the new (first, last) to device memory.
//   3. scan_emit: the per-block exclusive scan again, composed after the
//      block's carry and the (first, last) state; emits pos and matched.
// The inputs are read twice (launches 1 and 3); a single-pass decoupled
// look-back scan would read them once.  The ragged last block masks its
// tail as identity transforms, so no padding copy is needed.  first/last
// are read through device pointers: a wave never syncs the host.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;               // threads = ops per block
constexpr int kWarps = kBlock / 32;
constexpr int32_t kInf = 1 << 30;          // repro core/scan_queue.py INF
constexpr unsigned kFull = 0xffffffffu;

struct T { int32_t a, b, c; };

__device__ __forceinline__ T ident() { return T{0, kInf, 0}; }

// (x then y): x is the earlier transform.
__device__ __forceinline__ T compose(T x, T y) {
  T r;
  r.a = x.a + y.a;
  r.b = min(min(x.b + y.a, x.c + y.b), kInf);
  r.c = x.c + y.c;
  return r;
}

__device__ __forceinline__ T load_op(const uint8_t* is_enq,
                                     const uint8_t* valid, int64_t i,
                                     int64_t n) {
  if (i >= n || valid[i] == 0) return ident();
  return is_enq[i] ? T{0, kInf, 1} : T{1, 1, 0};
}

__device__ __forceinline__ T shfl_up(T t, int off) {
  return T{__shfl_up_sync(kFull, t.a, off), __shfl_up_sync(kFull, t.b, off),
           __shfl_up_sync(kFull, t.c, off)};
}

// Inclusive scan of one warp's transforms, in lane order.
__device__ __forceinline__ T warp_incl(T t, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T u = shfl_up(t, off);
    if (lane >= off) t = compose(u, t);
  }
  return t;
}

// Exclusive scan over the block, in thread order; *agg gets the block's
// total.  warp_tot is __shared__ scratch of kWarps entries.  All threads
// of the block must call it.
__device__ T block_excl(T t, T* warp_tot, T* agg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = warp_incl(t, lane);
  T prev = shfl_up(inc, 1);
  T excl = lane == 0 ? ident() : prev;
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = warp_tot[lane];             // kWarps == 32 warps, one per lane
    w = warp_incl(w, lane);
    warp_tot[lane] = w;               // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) excl = compose(warp_tot[warp - 1], excl);
  *agg = warp_tot[kWarps - 1];
  __syncthreads();                    // warp_tot may be reused next
  return excl;
}

__global__ void __launch_bounds__(kBlock)
block_totals(const uint8_t* __restrict__ is_enq,
             const uint8_t* __restrict__ valid, int32_t* __restrict__ totals,
             int64_t n) {
  __shared__ T warp_tot[kWarps];
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  T agg;
  block_excl(load_op(is_enq, valid, i, n), warp_tot, &agg);
  if (threadIdx.x == 0) {
    totals[3 * blockIdx.x + 0] = agg.a;
    totals[3 * blockIdx.x + 1] = agg.b;
    totals[3 * blockIdx.x + 2] = agg.c;
  }
}

__global__ void __launch_bounds__(kBlock)
carry_scan(const int32_t* __restrict__ totals, int32_t* __restrict__ carry,
           int nb, const int32_t* __restrict__ first,
           const int32_t* __restrict__ last, int32_t* __restrict__ new_state) {
  __shared__ T warp_tot[kWarps];
  T run = ident();                    // every thread keeps the same copy
  for (int base = 0; base < nb; base += kBlock) {
    const int j = base + threadIdx.x;
    T t = j < nb ? T{totals[3 * j], totals[3 * j + 1], totals[3 * j + 2]}
                 : ident();
    T agg;
    T excl = compose(run, block_excl(t, warp_tot, &agg));
    if (j < nb) {
      carry[3 * j + 0] = excl.a;
      carry[3 * j + 1] = excl.b;
      carry[3 * j + 2] = excl.c;
    }
    run = compose(run, agg);
  }
  if (threadIdx.x == 0) {
    const int32_t f = *first, l = *last;
    new_state[0] = min(f + run.a, l + run.b);
    new_state[1] = l + run.c;
  }
}

__global__ void __launch_bounds__(kBlock)
scan_emit(const uint8_t* __restrict__ is_enq,
          const uint8_t* __restrict__ valid,
          const int32_t* __restrict__ carry,
          const int32_t* __restrict__ first,
          const int32_t* __restrict__ last, int32_t* __restrict__ pos,
          uint8_t* __restrict__ matched, int64_t n) {
  __shared__ T warp_tot[kWarps];
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  T agg;
  T excl = block_excl(load_op(is_enq, valid, i, n), warp_tot, &agg);
  if (i >= n) return;
  const T c{carry[3 * blockIdx.x], carry[3 * blockIdx.x + 1],
            carry[3 * blockIdx.x + 2]};
  const T x = compose(c, excl);
  const int32_t f0 = *first, l0 = *last;
  const int32_t f_i = min(f0 + x.a, l0 + x.b);
  const int32_t l_i = l0 + x.c;
  int32_t p = -1;
  if (valid[i]) p = is_enq[i] ? l_i + 1 : (f_i <= l_i ? f_i : -1);
  pos[i] = p;
  matched[i] = p != -1;
}

}  // namespace

// pos/matched: [n] outputs; new_state: [2] int32 (new_first, new_last);
// totals/carry: scratch of 3 * ceil(n / 1024) int32 each.  Returns the
// cudaGetLastError() after the launches (0 on success).
extern "C" int repro_queue_scan(const void* is_enq, const void* valid,
                                const void* first, const void* last,
                                void* pos, void* matched, void* new_state,
                                void* totals, void* carry, int n,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kBlock - 1) / kBlock;
  const auto* e = static_cast<const uint8_t*>(is_enq);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* f = static_cast<const int32_t*>(first);
  const auto* l = static_cast<const int32_t*>(last);
  auto* tot = static_cast<int32_t*>(totals);
  auto* car = static_cast<int32_t*>(carry);
  if (nb > 0) block_totals<<<nb, kBlock, 0, s>>>(e, v, tot, n);
  carry_scan<<<1, kBlock, 0, s>>>(tot, car, nb, f, l,
                                  static_cast<int32_t*>(new_state));
  if (nb > 0)
    scan_emit<<<nb, kBlock, 0, s>>>(e, v, car, f, l,
                                    static_cast<int32_t*>(pos),
                                    static_cast<uint8_t*>(matched), n);
  return static_cast<int>(cudaGetLastError());
}
