// SKUEUE position assignment (Stages 1-3) as prefix scans: the FIFO
// min-plus scan, the LIFO max-plus scan, and the per-tier enqueue sweep of
// the priority queue.
//
// Replaces repro/kernels/segscan/kernel.py: queue_scan_kernel and
// stack_scan_kernel (the Pallas two-phase scans over (8, 128) tiles, with
// the carry scan in jnp between them) and tiered_queue_scan_kernel (grid
// tiers x tiles).
//
// FIFO.  Op i carries the transform T(A, B, C) on (first, last):
//   valid ENQ (0, INF, 1), valid DEQ (1, 1, 0), invalid (0, INF, 0) = identity
// composed (earlier ; later) = (A1+A2, min(B1+A2, C1+B2, INF), C1+C2).
// With A, C >= 0 the INF saturation makes every bracketing give the same
// integers.
//
// LIFO.  Op i carries T(a, b, dt) on (last, ticket): l' = max(l + a, b),
//   valid PUSH (1, -INF, 1), valid POP (-1, 0, 0), invalid (0, -INF, 0)
// composed (earlier ; later) = (a1+a2, max(b1+a2, b2, -INF), d1+d2).
// Why the -INF clamp gives the same integers under every bracketing: a b
// that comes from a real POP is exact, since max-plus composition without
// the clamp is associative.  A b that comes only from PUSHes' -INF is
// garbage, and where a bracketing clamps it differs; but garbage stays in
// [-INF, -INF + n].  The state it meets is last + a_x with last >= 0 and
// a_x >= -n, so last + a_x >= -n > -INF + n whenever n < 2^29, and the
// garbage always loses the max.  The wrapper raises at n >= 2^29.
//
// Both compositions are associative but NOT commutative: every combine
// below takes the earlier operand first.  One template (block_excl and the
// three kernels) serves both; an Op struct supplies the transform.
//
// What bounds them on an H100: memory.  FIFO reads 2 B/op (is_enq, valid)
// and writes 5 (int32 position, bool matched); LIFO reads 2 and writes 9
// (position, ticket, matched); 16 M ops move 117 MB and 184 MB, 35 and
// 55 us at 3.35 TB/s.  The arithmetic is a few integer ops per element.  A
// 65,536-op wave (64 blocks) is far below the card's width and is bound
// by launch latency instead.
//
// Design, simple and right first: three launches.
//   1. block_totals: one op per thread; warp __shfl_up_sync scans, then a
//      combine of the 32 warp totals; each block writes its total.
//   2. carry_scan: ONE block scans the block totals exclusively, looping
//      over chunks of 1024 with a running carry (so n = 2^24 works), and
//      writes the new state to device memory.
//   3. scan_emit: the per-block exclusive scan again, composed after the
//      block's carry and the incoming state; emits the outputs.
// The inputs are read twice (launches 1 and 3); a single-pass decoupled
// look-back scan would read them once.  The ragged last block masks its
// tail as identity transforms, so no padding copy is needed.  The state
// is read through device pointers: a wave never syncs the host.
//
// Tiered sweep.  For an enqueue-only masked sweep the min-plus scan is a
// count per tier: an enqueue of tier t gets lasts[t] + 1 + (earlier
// enqueues of tier t), and new_lasts = lasts + count[t].  A tier outside
// [0, P), or a non-enqueue, gets -1 and moves nothing.  It writes the
// gathered pos [n] directly; the Pallas kernel wrote pos_all [P, n] and
// its wrapper gathered one row per op, P times the bytes.  Bound: memory,
// 5 B/op in (int32 tier, bool enq) and 4 out.  Three launches again:
//   1. tier_block_counts: __match_any_sync groups a warp's lanes by tier;
//      each group's leader adds its size to a shared-memory histogram;
//      each block writes counts[t][block].
//   2. tier_carry_scan: one block per tier scans its row of block counts
//      exclusively and writes new_lasts[t].
//   3. tier_emit: per-warp per-tier counts in shared memory, scanned over
//      the 32 warps; an op's rank is its block's carry, plus its warp's
//      prefix, plus its rank among its warp's same-tier lanes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;               // threads = ops per block
constexpr int kWarps = kBlock / 32;
constexpr int32_t kInf = 1 << 30;          // repro core/scan_queue.py INF
constexpr unsigned kFull = 0xffffffffu;

struct T { int32_t a, b, c; };

// FIFO: T(A, B, C) on (first, last).
struct QueueOp {
  static constexpr bool kTicket = false;
  __device__ static T ident() { return T{0, kInf, 0}; }
  // (x then y): x is the earlier transform.
  __device__ static T compose(T x, T y) {
    return T{x.a + y.a, min(min(x.b + y.a, x.c + y.b), kInf), x.c + y.c};
  }
  __device__ static T load(bool e, bool v) {
    if (!v) return ident();
    return e ? T{0, kInf, 1} : T{1, 1, 0};
  }
  // new (first, last) after the whole batch's transform
  __device__ static void finish(T run, int32_t f, int32_t l, int32_t* out) {
    out[0] = min(f + run.a, l + run.b);
    out[1] = l + run.c;
  }
  // position of an op whose exclusive prefix transform is x
  __device__ static int32_t position(T x, int32_t f0, int32_t l0, bool e,
                                     bool v) {
    const int32_t f_i = min(f0 + x.a, l0 + x.b);
    const int32_t l_i = l0 + x.c;
    if (!v) return -1;
    return e ? l_i + 1 : (f_i <= l_i ? f_i : -1);
  }
  __device__ static int32_t ticket(T, int32_t, bool) { return 0; }
};

// LIFO: T(a, b, dt) on (last, ticket).
struct StackOp {
  static constexpr bool kTicket = true;
  __device__ static T ident() { return T{0, -kInf, 0}; }
  __device__ static T compose(T x, T y) {
    return T{x.a + y.a, max(max(x.b + y.a, y.b), -kInf), x.c + y.c};
  }
  __device__ static T load(bool e, bool v) {
    if (!v) return ident();
    return e ? T{1, -kInf, 1} : T{-1, 0, 0};
  }
  __device__ static void finish(T run, int32_t l, int32_t t, int32_t* out) {
    out[0] = max(l + run.a, run.b);
    out[1] = t + run.c;
  }
  __device__ static int32_t position(T x, int32_t l0, int32_t, bool e,
                                     bool v) {
    const int32_t l_i = max(l0 + x.a, x.b);
    if (!v) return -1;
    return e ? l_i + 1 : (l_i >= 1 ? l_i : -1);
  }
  // a push's ticket, a pop's bound; like the reference, not masked by
  // valid (an invalid op's ticket is never read)
  __device__ static int32_t ticket(T x, int32_t t0, bool e) {
    return e ? t0 + x.c + 1 : t0 + x.c;
  }
};

// Plain sums (a only), for the tiered sweep's carry scan.
struct CountOp {
  __device__ static T ident() { return T{0, 0, 0}; }
  __device__ static T compose(T x, T y) { return T{x.a + y.a, 0, 0}; }
};

__device__ __forceinline__ T shfl_up(T t, int off) {
  return T{__shfl_up_sync(kFull, t.a, off), __shfl_up_sync(kFull, t.b, off),
           __shfl_up_sync(kFull, t.c, off)};
}

// Inclusive scan of one warp's transforms, in lane order.
template <class Op>
__device__ __forceinline__ T warp_incl(T t, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T u = shfl_up(t, off);
    if (lane >= off) t = Op::compose(u, t);
  }
  return t;
}

// Exclusive scan over the block, in thread order; *agg gets the block's
// total.  warp_tot is __shared__ scratch of kWarps entries.  All threads
// of the block must call it.
template <class Op>
__device__ T block_excl(T t, T* warp_tot, T* agg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = warp_incl<Op>(t, lane);
  T prev = shfl_up(inc, 1);
  T excl = lane == 0 ? Op::ident() : prev;
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = warp_tot[lane];             // kWarps == 32 warps, one per lane
    w = warp_incl<Op>(w, lane);
    warp_tot[lane] = w;               // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) excl = Op::compose(warp_tot[warp - 1], excl);
  *agg = warp_tot[kWarps - 1];
  __syncthreads();                    // warp_tot may be reused next
  return excl;
}

template <class Op>
__global__ void __launch_bounds__(kBlock)
block_totals(const uint8_t* __restrict__ is_e,
             const uint8_t* __restrict__ valid, int32_t* __restrict__ totals,
             int64_t n) {
  __shared__ T warp_tot[kWarps];
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const bool in = i < n;
  T agg;
  block_excl<Op>(Op::load(in && is_e[i], in && valid[i]), warp_tot, &agg);
  if (threadIdx.x == 0) {
    totals[3 * blockIdx.x + 0] = agg.a;
    totals[3 * blockIdx.x + 1] = agg.b;
    totals[3 * blockIdx.x + 2] = agg.c;
  }
}

template <class Op>
__global__ void __launch_bounds__(kBlock)
carry_scan(const int32_t* __restrict__ totals, int32_t* __restrict__ carry,
           int nb, const int32_t* __restrict__ s0,
           const int32_t* __restrict__ s1, int32_t* __restrict__ new_state) {
  __shared__ T warp_tot[kWarps];
  T run = Op::ident();                // every thread keeps the same copy
  for (int base = 0; base < nb; base += kBlock) {
    const int j = base + threadIdx.x;
    T t = j < nb ? T{totals[3 * j], totals[3 * j + 1], totals[3 * j + 2]}
                 : Op::ident();
    T agg;
    T excl = Op::compose(run, block_excl<Op>(t, warp_tot, &agg));
    if (j < nb) {
      carry[3 * j + 0] = excl.a;
      carry[3 * j + 1] = excl.b;
      carry[3 * j + 2] = excl.c;
    }
    run = Op::compose(run, agg);
  }
  if (threadIdx.x == 0) Op::finish(run, *s0, *s1, new_state);
}

template <class Op>
__global__ void __launch_bounds__(kBlock)
scan_emit(const uint8_t* __restrict__ is_e, const uint8_t* __restrict__ valid,
          const int32_t* __restrict__ carry, const int32_t* __restrict__ s0,
          const int32_t* __restrict__ s1, int32_t* __restrict__ pos,
          uint8_t* __restrict__ matched, int32_t* __restrict__ tick,
          int64_t n) {
  __shared__ T warp_tot[kWarps];
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const bool in = i < n;
  const bool e = in && is_e[i], v = in && valid[i];
  T agg;
  T excl = block_excl<Op>(Op::load(e, v), warp_tot, &agg);
  if (!in) return;
  const T c{carry[3 * blockIdx.x], carry[3 * blockIdx.x + 1],
            carry[3 * blockIdx.x + 2]};
  const T x = Op::compose(c, excl);
  const int32_t p = Op::position(x, *s0, *s1, e, v);
  pos[i] = p;
  matched[i] = p != -1;
  if constexpr (Op::kTicket) tick[i] = Op::ticket(x, *s1, e);
}

template <class Op>
int launch_scan(const void* is_e, const void* valid, const void* s0,
                const void* s1, void* pos, void* matched, void* tick,
                void* new_state, void* totals, void* carry, int n,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kBlock - 1) / kBlock;
  const auto* e = static_cast<const uint8_t*>(is_e);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* a = static_cast<const int32_t*>(s0);
  const auto* b = static_cast<const int32_t*>(s1);
  auto* tot = static_cast<int32_t*>(totals);
  auto* car = static_cast<int32_t*>(carry);
  if (nb > 0) block_totals<Op><<<nb, kBlock, 0, s>>>(e, v, tot, n);
  carry_scan<Op><<<1, kBlock, 0, s>>>(tot, car, nb, a, b,
                                      static_cast<int32_t*>(new_state));
  if (nb > 0)
    scan_emit<Op><<<nb, kBlock, 0, s>>>(
        e, v, car, a, b, static_cast<int32_t*>(pos),
        static_cast<uint8_t*>(matched), static_cast<int32_t*>(tick), n);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- tiered sweep -----
// The op's tier if it is an enqueue of a tier in [0, P), else -1.
__device__ __forceinline__ int tier_key(const int32_t* tier,
                                        const uint8_t* enq, int64_t i,
                                        int64_t n, int P) {
  if (i >= n || !enq[i]) return -1;
  const int32_t t = tier[i];
  return (t >= 0 && t < P) ? t : -1;
}

__global__ void __launch_bounds__(kBlock)
tier_block_counts(const int32_t* __restrict__ tier,
                  const uint8_t* __restrict__ enq,
                  int32_t* __restrict__ counts, int64_t n, int P, int nb) {
  extern __shared__ int32_t hist[];   // [P]
  for (int j = threadIdx.x; j < P; j += kBlock) hist[j] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int key = tier_key(tier, enq, i, n, P);
  const unsigned peers = __match_any_sync(kFull, key);
  if (key >= 0 && lane == __ffs(peers) - 1)
    atomicAdd(&hist[key], __popc(peers));
  __syncthreads();
  for (int j = threadIdx.x; j < P; j += kBlock)
    counts[(int64_t)j * nb + blockIdx.x] = hist[j];
}

__global__ void __launch_bounds__(kBlock)
tier_carry_scan(const int32_t* __restrict__ counts,
                int32_t* __restrict__ carry, const int32_t* __restrict__ lasts,
                int32_t* __restrict__ new_lasts, int nb) {
  __shared__ T warp_tot[kWarps];
  const int64_t row = (int64_t)blockIdx.x * nb;   // one block per tier
  int32_t run = 0;
  for (int base = 0; base < nb; base += kBlock) {
    const int j = base + threadIdx.x;
    T agg;
    const T ex = block_excl<CountOp>(T{j < nb ? counts[row + j] : 0, 0, 0},
                                     warp_tot, &agg);
    if (j < nb) carry[row + j] = run + ex.a;
    run += agg.a;
  }
  if (threadIdx.x == 0)
    new_lasts[blockIdx.x] = static_cast<int32_t>(
        static_cast<uint32_t>(lasts[blockIdx.x]) + static_cast<uint32_t>(run));
}

__global__ void __launch_bounds__(kBlock)
tier_emit(const int32_t* __restrict__ tier, const uint8_t* __restrict__ enq,
          const int32_t* __restrict__ carry, const int32_t* __restrict__ lasts,
          int32_t* __restrict__ pos, int64_t n, int P, int nb) {
  extern __shared__ int32_t wc[];     // [kWarps][P] per-warp tier counts
  for (int j = threadIdx.x; j < kWarps * P; j += kBlock) wc[j] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int key = tier_key(tier, enq, i, n, P);
  const unsigned peers = __match_any_sync(kFull, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (key >= 0 && lane == __ffs(peers) - 1) wc[warp * P + key] = __popc(peers);
  __syncthreads();
  for (int t = threadIdx.x; t < P; t += kBlock) {   // exclusive over warps
    int32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = wc[w * P + t];
      wc[w * P + t] = run;
      run += c;
    }
  }
  __syncthreads();
  if (i >= n) return;
  int32_t p = -1;
  if (key >= 0) {                     // int32 wrap-around, as in the reference
    const uint32_t before = static_cast<uint32_t>(
        carry[(int64_t)key * nb + blockIdx.x] + wc[warp * P + key] + rank);
    p = static_cast<int32_t>(static_cast<uint32_t>(lasts[key]) + 1u + before);
  }
  pos[i] = p;
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
  return launch_scan<QueueOp>(is_enq, valid, first, last, pos, matched,
                              nullptr, new_state, totals, carry, n, stream);
}

// pos/tick/matched: [n] outputs; new_state: [2] int32 (new_last,
// new_ticket); totals/carry as for repro_queue_scan.
extern "C" int repro_stack_scan(const void* is_push, const void* valid,
                                const void* last, const void* ticket,
                                void* pos, void* tick, void* matched,
                                void* new_state, void* totals, void* carry,
                                int n, void* stream) {
  return launch_scan<StackOp>(is_push, valid, last, ticket, pos, matched,
                              tick, new_state, totals, carry, n, stream);
}

// tier: [n] int32, enq: [n] bool, lasts: [P] int32; pos: [n] int32 and
// new_lasts: [P] int32 outputs; counts/carry: scratch of P * max(1,
// ceil(n / 1024)) int32 each.  1 <= P <= 256 (the emit kernel's shared
// memory, 32 * P int32, stays under 48 KB).
extern "C" int repro_tiered_scan(const void* tier, const void* enq,
                                 const void* lasts, void* pos,
                                 void* new_lasts, void* counts, void* carry,
                                 int n, int n_tiers, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kBlock - 1) / kBlock;
  const int nbc = nb > 0 ? nb : 1;
  const auto* t = static_cast<const int32_t*>(tier);
  const auto* e = static_cast<const uint8_t*>(enq);
  auto* cnt = static_cast<int32_t*>(counts);
  auto* car = static_cast<int32_t*>(carry);
  if (nb > 0)
    tier_block_counts<<<nb, kBlock, n_tiers * sizeof(int32_t), s>>>(
        t, e, cnt, n, n_tiers, nbc);
  else
    cudaMemsetAsync(cnt, 0, n_tiers * sizeof(int32_t), s);
  tier_carry_scan<<<n_tiers, kBlock, 0, s>>>(
      cnt, car, static_cast<const int32_t*>(lasts),
      static_cast<int32_t*>(new_lasts), nbc);
  if (nb > 0)
    tier_emit<<<nb, kBlock, kWarps * n_tiers * sizeof(int32_t), s>>>(
        t, e, car, static_cast<const int32_t*>(lasts),
        static_cast<int32_t*>(pos), n, n_tiers, nbc);
  return static_cast<int>(cudaGetLastError());
}
