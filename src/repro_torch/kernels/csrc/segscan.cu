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
// Both compositions are associative but NOT commutative: every combine
// below takes the earlier operand first.
//
// Why the -INF clamp gives the same integers under every bracketing (the
// single-pass scan brackets a prefix as thread-serial items, then the
// warp, then the block's warps, then windows of 32 tiles of the
// look-back, nearest first; the reference as its associative_scan does):
// without the clamp, max-plus composition is associative, and a prefix's
// b is the max over its ops j of b_j + (the a's after j).  A term from a
// real POP (b_j = 0) is at least -n and is never clamped, so it is exact
// in every bracketing.  A term from a PUSH's or an invalid op's -INF is
// garbage: where a bracketing clamps it differs, but it stays in
// [-INF, -INF + n].  It meets either a real term (>= -n) or the state,
// last + a_x with last >= 0 and a_x >= -n, so >= -n; and -n > -INF + n
// whenever n < 2^29.  So the garbage never wins a max that is read, and
// every position, bound and new state is the same integer.  The wrapper
// raises at n >= 2^29.  The ticket t0 + dt (and + 1) is summed in uint32:
// the reference's int32 sum wraps, and signed overflow is undefined here.
//
// Why the INF saturation gives the same integers under every bracketing
// (the FIFO's argument, beside the stack's above): without the clamp,
// min-plus composition is associative, and a prefix's B is the min over its
// ops j of (the C's before j) + B_j + (the A's after j).  The clamp is
// absorbing: with A, C >= 0, min(min(u, INF) + a, c + min(v, INF), INF) =
// min(u + a, c + v, INF), since INF + a and c + INF are both >= INF.  So
// a composition of clamped parts is the clamp of the unclamped whole, and
// thread-serial items, the warp, the block's warps and the look-back's
// windows of 32 tiles (nearest first) all give min(B, INF), the integer
// the reference's associative_scan gives.  No sum overflows: A and C stay
// at most n, B at most INF before its clamp, so a sum is at most INF + n
// < 2^31 whenever n < 2^30; the state adds first + A and last + B (the
// reference sums the same int32s).  The wrapper raises at n >= 2^30.
//
// What bounds them on an H100: memory.  FIFO reads 2 B/op (is_enq, valid)
// and writes 5 (int32 position, bool matched); LIFO reads 2 and writes 9
// (position, ticket, matched); the tiered sweep reads 5 (int32 tier, bool
// enq) and writes 4.  At 2^24 ops they move 117, 184 and 151 MB: 35, 55
// and 45 us at 3.35 TB/s.  The arithmetic is a few integer ops per op.
//
// Design: one launch per call, inputs read once.  The FIFO scan
// (queue_scan_lookback) replaces the TPU's two pallas_calls and the carry
// scan between them (queue_scan_kernel: _totals_kernel, then _scan_kernel
// on the carries), which read the wave twice; it shares every part with
// the stack scan but its transform and its outputs.
//   * Tiles of 4,096 ops, each thread's ops consecutive: the stack takes 128
//     threads x 32 ops, the tiered sweep 256 x 16 (one tier per thread in its
//     per-tier steps), the FIFO 256 x 16 (below).  Bools come in as 16-byte
//     loads (16 ops), int32 tiers four to a 16-byte load; a thread whose ops
//     straddle n, or a base that is not 16-byte aligned, loads and stores with
//     scalar accesses instead, so any contiguous view works.  Timed on an H100
//     during development: 32 ops a thread ran the stack faster at 2^24 ops
//     than 16, and 128 threads kept one wave's latency below 256's; the tiered
//     sweep ran slower at 32.  The FIFO takes 256 x 16, the shape its traffic
//     runs: at one wave (16 tiles, all in flight at once) the shorter
//     per-thread chains finished in 5.1 us against 5.95 at 128 x 32; 128 x 32
//     was faster only from 2^22 ops, where more tiles in flight win (0.068
//     against 0.074 ms at 2^24), a size no queue path reaches.  Per op, the
//     FIFO steps its (first, last) rather than composing a transform: an ENQ
//     or DEQ moves one counter.
//   * Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
//     Scan with Decoupled Look-back", NVIDIA 2016).  A block draws its tile
//     from an atomic counter (atomicInc wraps it back to 0 on the last
//     tile, so it is ready for the next call), so a tile's predecessors
//     are running or done whatever order the hardware dispatches blocks
//     in.  A tile publishes its aggregate (flag A), looks back with one
//     warp over windows of 32 predecessors until it meets an inclusive
//     prefix (flag P), and publishes its own inclusive prefix.  The value
//     is too wide for one atomic word (3 int32, or P counts), so values
//     and flags live in separate arrays: the writers store the value,
//     then one thread fences (__threadfence) and stores the flag; the
//     reader acquire-loads the flag, then reads the value past L1.
//   * The flags carry an epoch: flag = 2 * epoch (A) or 2 * epoch + 1 (P),
//     epoch >= 1 passed in by the launcher and raised every call.  A flag
//     from an earlier call is below 2 * epoch and reads as "not yet", so
//     the status buffer is never cleared between calls; the launcher
//     caches one per (device, stream), shared by all three scans, zeroed
//     once when it is allocated or grown.  The layout is `status_view`'s;
//     the launcher sizes it.  A CUDA graph would replay one epoch, so the
//     launcher refuses to be captured.
//   * The tile that finishes last in tile order writes the new state.
// FIFO and stack (tile_prefix): each thread composes its 16 (FIFO) or 32
// (stack) ops serially, warps scan the thread aggregates (__shfl_up_sync),
// warp 0 scans the 8 or 4 warp totals; the look-back window is reduced in lane order (a higher
// lane is an earlier tile).  Positions (and the stack's tickets) go
// through shared memory (padded one word in 32, no bank conflicts) to
// coalesced 16-byte stores; matched flags leave packed, 16 a store.
// Tiered: an enqueue of tier t gets lasts[t] + 1 + (earlier enqueues of
// tier t), and new_lasts = lasts + count[t]; a tier outside [0, P), or a
// non-enqueue, gets -1.  The carry is a per-tier sum, so the look-back
// sums a window's counts in any order: each lane reads one predecessor's
// P counts, and a warp sum (__reduce_add_sync) per tier folds the window.
// Ranks follow op order: each thread stages its ops' keys (the tier, or
// -1) in shared memory, each warp walks its 512 ops in rounds of 32
// consecutive ones, __match_any_sync groups a round's lanes by tier, and
// per-warp per-tier running counts carry across rounds; an exclusive scan
// over the 8 warps gives each warp its offset.  Positions overwrite the
// keys and leave as 16-byte stores.  Shared memory: 16.5 KB of keys, 8 KB
// of per-warp counts and 2 KB of per-tier prefix and counts at P = 256,
// about 27 KB, far under the 227 KB a block may use.  One launch takes at
// most 256 tiers; the launcher makes one launch per group of 256 tiers.
// The state of every scan is read through device pointers: a wave never
// syncs the host.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;                // ops per tile, every scan
constexpr int kQueueThreads = 256;         //   FIFO: 16 ops a thread
constexpr int kStackThreads = 128;         //   stack: 32 ops a thread
constexpr int kTierThreads = 256;          //   tiered: 16 ops a thread
constexpr int kMaxTiers = kTierThreads;    //   tiered: one tier per thread
constexpr int32_t kInf = 1 << 30;          // repro core/scan_queue.py INF
constexpr unsigned kFull = 0xffffffffu;

struct T { int32_t a, b, c; };

// FIFO: T(A, B, C) on (first, last).
struct QueueOp {
  __device__ static T ident() { return T{0, kInf, 0}; }
  // (x then y): x is the earlier transform.
  __device__ static T compose(T x, T y) {
    return T{x.a + y.a, min(min(x.b + y.a, x.c + y.b), kInf), x.c + y.c};
  }
  __device__ static T load(bool e, bool v) {
    if (!v) return ident();
    return e ? T{0, kInf, 1} : T{1, 1, 0};
  }
  // compose(x, load(e, v)) for x of this scan (b <= INF, c < INF - 1):
  // an ENQ leaves b at min(b, c + INF, INF) = b, a DEQ's min(b + 1, c + 1)
  // is below INF
  __device__ static T then(T x, bool e, bool v) {
    if (v && e) return T{x.a, x.b, x.c + 1};
    if (v) return T{x.a + 1, min(x.b + 1, x.c + 1), x.c};
    return x;
  }
  // new (first, last) after the whole batch's transform
  __device__ static void finish(T run, int32_t f, int32_t l, int32_t* out) {
    out[0] = min(f + run.a, l + run.b);
    out[1] = l + run.c;
  }
};

__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) +
                              static_cast<uint32_t>(y));
}

// LIFO: T(a, b, dt) on (last, ticket).
struct StackOp {
  __device__ static T ident() { return T{0, -kInf, 0}; }
  __device__ static T compose(T x, T y) {
    return T{x.a + y.a, max(max(x.b + y.a, y.b), -kInf), x.c + y.c};
  }
  __device__ static T load(bool e, bool v) {
    if (!v) return ident();
    return e ? T{1, -kInf, 1} : T{-1, 0, 0};
  }
  __device__ static T then(T x, bool e, bool v) {
    return compose(x, load(e, v));
  }
  __device__ static void finish(T run, int32_t l, int32_t t, int32_t* out) {
    out[0] = max(l + run.a, run.b);
    out[1] = wrap_add(t, run.c);
  }
  __device__ static int32_t position(T x, int32_t l0, bool e, bool v) {
    const int32_t l_i = max(l0 + x.a, x.b);
    if (!v) return -1;
    return e ? l_i + 1 : (l_i >= 1 ? l_i : -1);
  }
  // a push's ticket, a pop's bound; like the reference, not masked by
  // valid (an invalid op's ticket is never read)
  __device__ static int32_t ticket(T x, int32_t t0, bool e) {
    return wrap_add(wrap_add(t0, x.c), e ? 1 : 0);
  }
};

__device__ __forceinline__ T shfl_up(T t, int off) {
  return T{__shfl_up_sync(kFull, t.a, off), __shfl_up_sync(kFull, t.b, off),
           __shfl_up_sync(kFull, t.c, off)};
}

__device__ __forceinline__ T shfl_down(T t, int off) {
  return T{__shfl_down_sync(kFull, t.a, off),
           __shfl_down_sync(kFull, t.b, off),
           __shfl_down_sync(kFull, t.c, off)};
}

__device__ __forceinline__ T shfl(T t, int src) {
  return T{__shfl_sync(kFull, t.a, src), __shfl_sync(kFull, t.b, src),
           __shfl_sync(kFull, t.c, src)};
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

// ------------------------------------------- single-pass look-back -----
// The status buffer: a tile counter (16 bytes), `slots` (even) uint64
// flags, then two value arrays of `width` int32 per tile (aggregates,
// inclusive prefixes).  The flags sit at a place fixed for the buffer's
// life, whatever this call's tiles and width, so they never hold another
// call's values (which could read as a flag of this epoch).  kernel.py's
// _status sizes it.
struct Status {
  unsigned* counter;
  unsigned long long* flag;
  int32_t* agg;
  int32_t* incl;
};

__device__ __forceinline__ Status status_view(void* buf, int slots,
                                              int tiles, int width) {
  auto* b = static_cast<uint8_t*>(buf);
  Status s;
  s.counter = reinterpret_cast<unsigned*>(b);
  s.flag = reinterpret_cast<unsigned long long*>(b + 16);
  s.agg = reinterpret_cast<int32_t*>(b + 16 +
                                     8 * static_cast<size_t>(slots));
  s.incl = s.agg + static_cast<size_t>(tiles) * width;
  return s;
}

// The tile this block scans, in the order blocks start: thread 0 draws it
// and the block reads it from `slot` after a __syncthreads.
__device__ __forceinline__ void draw_tile(const Status& st, int tiles,
                                          int* slot) {
  if (threadIdx.x == 0) *slot = atomicInc(st.counter, tiles - 1);
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Publish a flag after this thread's value stores, and those of every
// thread that met it at a barrier (__syncthreads / __syncwarp) since: the
// fence is cumulative, so fence + relaxed store is a release (CUB's
// pattern for wide values, and cooperative groups' grid barrier).
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  __threadfence();
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Spin until predecessor j has published in this call; returns its flag.
// A flag that never comes means a broken status buffer: trap (the launch
// then fails) instead of hanging the card.
__device__ __forceinline__ unsigned long long wait_flag(
    const Status& st, int j, unsigned long long epoch) {
  unsigned long long f;
  for (unsigned spins = 0; (f = load_flag(st.flag + j)) < 2 * epoch;) {
    __nanosleep(32);
    if (++spins == (1u << 26)) asm volatile("trap;");
  }
  return f;
}

// A FIFO or stack tile's published value: (a, b, c) as one 16-byte
// store.
__device__ __forceinline__ void put_T(int32_t* row, T t) {
  __stcg(reinterpret_cast<int4*>(row), make_int4(t.a, t.b, t.c, 0));
}

__device__ __forceinline__ T get_T(const int32_t* row) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(row));
  return T{v.x, v.y, v.z};
}

// Warp 0 of tile `tile` > 0: the composition of every earlier tile, in
// tile order, read from the status buffer.  Each window puts predecessor
// tile - 1 - lane - 32k on lane `lane`; lanes past the nearest inclusive
// prefix (or before tile 0) count as the identity.  All lanes return it.
template <class Op>
__device__ T look_back(const Status& st, int tile, unsigned long long epoch,
                       int lane) {
  T prefix = Op::ident();
  for (int top = tile - 1;; top -= 32) {
    const int j = top - lane;
    const unsigned long long f = j >= 0 ? wait_flag(st, j, epoch)
                                        : 2 * epoch + 1;
    const bool inclusive = f & 1;
    const unsigned pmask = __ballot_sync(kFull, inclusive);
    const int stop = pmask ? __ffs(pmask) - 1 : 31;
    T x = Op::ident();
    if (j >= 0 && lane <= stop)
      x = get_T((inclusive ? st.incl : st.agg) + 4 * static_cast<size_t>(j));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {   // lane order: higher = earlier
      const T y = shfl_down(x, off);
      if (lane + off < 32) x = Op::compose(y, x);
    }
    prefix = Op::compose(shfl(x, 0), prefix);
    if (pmask) return prefix;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bools from p[i, i + 16): one 16-byte load where it can, else bytes
// (0 past n).
__device__ __forceinline__ uint4 load16(const uint8_t* p, int64_t i,
                                        int64_t n, bool vec) {
  if (vec && i + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(p + i));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (i + k < n) w[k >> 2] |= static_cast<uint32_t>(p[i + k] != 0)
                                << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool item(const uint4& x, int k) {
  const uint32_t w = k < 4 ? x.x : k < 8 ? x.y : k < 12 ? x.z : x.w;
  return (w >> (8 * (k & 3))) & 0xffu;
}

// 4 int32 to p[i, i + 4), one 16-byte store where it can; i < n.
__device__ __forceinline__ void store4(int32_t* p, int64_t i, int64_t n,
                                       bool vec, int4 v) {
  if (vec && i + 4 <= n) {
    *reinterpret_cast<int4*>(p + i) = v;
    return;
  }
  const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < n) p[i + k] = w[k];
}

__device__ __forceinline__ int pad(int o) { return o + (o >> 5); }

constexpr int kStage = kTile + kTile / 32;   // padded staging, int32

// A thread's kItems bools, in 16-byte words.
template <int kItems>
struct Bools {
  uint4 w[kItems / 16];
  __device__ bool operator[](int k) const { return item(w[k >> 4], k & 15); }
};

template <int kItems>
__device__ __forceinline__ Bools<kItems> load_bools(const uint8_t* p,
                                                    int64_t i, int64_t n) {
  Bools<kItems> b;
  const bool vec = aligned16(p);
#pragma unroll
  for (int q = 0; q < kItems / 16; ++q)
    b.w[q] = load16(p, i + 16 * q, n, vec);
  return b;
}

// The tile's staged int32 (stage[pad(o)] for op o of the tile) to
// out[t0 + o], as coalesced 16-byte stores by kThreads threads.
template <int kThreads>
__device__ __forceinline__ void store_tile(int32_t* out, const int32_t* stage,
                                           int64_t t0, int64_t n) {
  const bool vec = aligned16(out);
#pragma unroll
  for (int r = 0; r < kTile / (4 * kThreads); ++r) {
    const int o = 4 * (threadIdx.x + kThreads * r);
    if (t0 + o >= n) break;
    const int s = pad(o);              // o % 32 <= 28: no pad inside
    store4(out, t0 + o, n, vec,
           make_int4(stage[s], stage[s + 1], stage[s + 2], stage[s + 3]));
  }
}

// A thread's kItems flags, packed four to a word in m, to p[i0, i0 +
// kItems): 16-byte stores where it can, else bytes.
template <int kItems>
__device__ __forceinline__ void store_bools(uint8_t* p, const uint32_t* m,
                                            int64_t i0, int64_t n) {
  const bool vec = aligned16(p);
#pragma unroll
  for (int q = 0; q < kItems / 16; ++q) {
    const int64_t i = i0 + 16 * q;
    if (vec && i + 16 <= n) {
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
    } else {
      for (int k = 0; k < 16 && i + k < n; ++k)
        p[i + k] = (m[4 * q + (k >> 2)] >> (8 * (k & 3))) & 1u;
    }
  }
}

// The FIFO and stack scans' common part, for tile `tile` of a block of
// kThreads threads: each thread composes its kItems ops serially, warps
// scan the thread aggregates, warp 0 scans the warp totals, publishes the
// tile's aggregate, looks back, publishes its inclusive prefix, and (on
// the last tile) writes the new state from (*s0, *s1).  Returns the
// composition of every op before this thread's first.  All threads of the
// block call it.
template <class Op, int kThreads, int kItems>
__device__ __forceinline__ T tile_prefix(const Status& st, int tile,
                                         int tiles, unsigned long long epoch,
                                         const Bools<kItems>& e,
                                         const Bools<kItems>& v,
                                         const int32_t* s0, const int32_t* s1,
                                         int32_t* new_state) {
  constexpr int kTileWarps = kThreads / 32;
  __shared__ T warp_tot[kTileWarps];
  __shared__ T tile_pre;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T agg = Op::ident();                 // this thread's ops, in order
#pragma unroll
  for (int k = 0; k < kItems; ++k) agg = Op::then(agg, e[k], v[k]);
  const T inc = warp_incl<Op>(agg, lane);
  const T up = shfl_up(inc, 1);
  T excl = lane == 0 ? Op::ident() : up;
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kTileWarps ? warp_tot[lane] : Op::ident();
    w = warp_incl<Op>(w, lane);
    if (lane < kTileWarps) warp_tot[lane] = w;        // inclusive over warps
    const T total = shfl(w, kTileWarps - 1);
    T prefix = Op::ident();
    if (lane == 0) {
      put_T((tile == 0 ? st.incl : st.agg) + 4 * tile, total);
      publish(st.flag + tile, 2 * epoch + (tile == 0));
    }
    if (tile > 0) {
      prefix = look_back<Op>(st, tile, epoch, lane);
      if (lane == 0) {
        put_T(st.incl + 4 * tile, Op::compose(prefix, total));
        publish(st.flag + tile, 2 * epoch + 1);
      }
    }
    if (lane == 0) {
      tile_pre = prefix;
      if (tile == tiles - 1)
        Op::finish(Op::compose(prefix, total), *s0, *s1, new_state);
    }
  }
  __syncthreads();
  if (warp > 0) excl = Op::compose(warp_tot[warp - 1], excl);
  return Op::compose(tile_pre, excl);
}

// At most 64 registers, so that 4 tiles of 256 threads fit an SM.
__global__ void __launch_bounds__(kQueueThreads, 1024 / kQueueThreads)
queue_scan_lookback(const uint8_t* __restrict__ is_enq,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ first,
                    const int32_t* __restrict__ last,
                    int32_t* __restrict__ pos, uint8_t* __restrict__ matched,
                    int32_t* __restrict__ new_state, void* status,
                    int slots, unsigned long long epoch, int64_t n,
                    int tiles) {
  constexpr int kItems = kTile / kQueueThreads;
  __shared__ int32_t stage[kStage];    // positions
  __shared__ int tile_s;
  const int tid = threadIdx.x;
  const Status st = status_view(status, slots, tiles, 4);
  draw_tile(st, tiles, &tile_s);
  __syncthreads();
  const int tile = tile_s;
  const int64_t t0 = static_cast<int64_t>(tile) * kTile;
  const int64_t i0 = t0 + tid * kItems;
  const auto e = load_bools<kItems>(is_enq, i0, n);
  const auto v = load_bools<kItems>(valid, i0, n);
  const T x = tile_prefix<QueueOp, kQueueThreads, kItems>(
      st, tile, tiles, epoch, e, v, first, last, new_state);
  // (first, last) before this thread's first op, then stepped through its
  // ops: an ENQ takes last + 1, a DEQ first while first <= last.  Applying
  // the ops one at a time is applying their composition, and the clamp
  // never bites: a prefix's B is INF before its first DEQ and at most
  // n + 1 after it.  So each op gets the reference's min(first + A,
  // last + B) and last + C of its prefix.
  int32_t f = min(*first + x.a, *last + x.b), l = *last + x.c;
  uint32_t m[kItems / 4];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((k & 3) == 0) m[k >> 2] = 0;
    const bool enq = v[k] && e[k], deq = v[k] && !e[k];
    const int32_t p = enq ? l + 1 : deq && f <= l ? f : -1;
    stage[pad(tid * kItems + k)] = p;
    m[k >> 2] |= static_cast<uint32_t>(p != -1) << (8 * (k & 3));
    l += enq;
    if (deq) f = min(f + 1, l + 1);
  }
  store_bools<kItems>(matched, m, i0, n);
  __syncthreads();
  store_tile<kQueueThreads>(pos, stage, t0, n);
}

__global__ void __launch_bounds__(kStackThreads)
stack_scan_lookback(const uint8_t* __restrict__ is_push,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ last,
                    const int32_t* __restrict__ ticket,
                    int32_t* __restrict__ pos, int32_t* __restrict__ tick,
                    uint8_t* __restrict__ matched,
                    int32_t* __restrict__ new_state, void* status,
                    int slots, unsigned long long epoch, int64_t n,
                    int tiles) {
  constexpr int kItems = kTile / kStackThreads;
  __shared__ int32_t stage[kStage];    // positions, then tickets
  __shared__ int tile_s;
  const int tid = threadIdx.x;
  const Status st = status_view(status, slots, tiles, 4);
  draw_tile(st, tiles, &tile_s);
  __syncthreads();
  const int tile = tile_s;
  const int64_t t0 = static_cast<int64_t>(tile) * kTile;
  const int64_t i0 = t0 + tid * kItems;
  const auto e = load_bools<kItems>(is_push, i0, n);
  const auto v = load_bools<kItems>(valid, i0, n);
  const T x0 = tile_prefix<StackOp, kStackThreads, kItems>(
      st, tile, tiles, epoch, e, v, last, ticket, new_state);
  const int32_t l0 = *last, k0 = *ticket;
  T x = x0;                            // positions, and matched
  uint32_t m[kItems / 4];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((k & 3) == 0) m[k >> 2] = 0;
    const int32_t p = StackOp::position(x, l0, e[k], v[k]);
    stage[pad(tid * kItems + k)] = p;
    m[k >> 2] |= static_cast<uint32_t>(p != -1) << (8 * (k & 3));
    x = StackOp::compose(x, StackOp::load(e[k], v[k]));
  }
  store_bools<kItems>(matched, m, i0, n);
  __syncthreads();
  store_tile<kStackThreads>(pos, stage, t0, n);
  __syncthreads();
  x = x0;                              // tickets: only the counts move them
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    stage[pad(tid * kItems + k)] = StackOp::ticket(x, k0, e[k]);
    x.c += e[k] && v[k];
  }
  __syncthreads();
  store_tile<kStackThreads>(tick, stage, t0, n);
}

// ------------------------------------------------------- tiered sweep -----
__global__ void __launch_bounds__(kTierThreads)
tiered_scan_lookback(const int32_t* __restrict__ tier,
                     const uint8_t* __restrict__ enq,
                     const int32_t* __restrict__ lasts,
                     int32_t* __restrict__ pos,
                     int32_t* __restrict__ new_lasts, void* status,
                     int slots, unsigned long long epoch, int64_t n, int P,
                     int tiles) {
  constexpr int kItems = kTile / kTierThreads;
  constexpr int kTileWarps = kTierThreads / 32;
  constexpr int kWarpOps = kTile / kTileWarps;
  __shared__ int32_t key_s[kStage];    // keys (padded), then positions
  __shared__ int32_t wc[kTileWarps][kMaxTiers];         // per-warp tier counts
  __shared__ int32_t cnt_s[kMaxTiers], pre_s[kMaxTiers];
  __shared__ int tile_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Status st = status_view(status, slots, tiles, P);
  draw_tile(st, tiles, &tile_s);
  for (int t = lane; t < P; t += 32) wc[warp][t] = 0;
  __syncthreads();
  const int tile = tile_s;
  const int64_t t0 = static_cast<int64_t>(tile) * kTile;
  const int64_t i0 = t0 + tid * kItems;

  // this thread's ops: enq in 16-byte words, tiers four to a 16-byte load;
  // each op's key (its tier, or -1 if it takes no position) to key_s
  const auto e = load_bools<kItems>(enq, i0, n);
  const bool vt = aligned16(tier);
#pragma unroll
  for (int q = 0; q < kItems / 4; ++q) {
    const int64_t i = i0 + 4 * q;
    int4 x;
    if (vt && i + 4 <= n) {
      x = __ldg(reinterpret_cast<const int4*>(tier + i));
    } else {
      x.x = i < n ? tier[i] : 0;
      x.y = i + 1 < n ? tier[i + 1] : 0;
      x.z = i + 2 < n ? tier[i + 2] : 0;
      x.w = i + 3 < n ? tier[i + 3] : 0;
    }
    const int32_t t4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j;
      key_s[pad(tid * kItems + k)] =
          (e[k] && t4[j] >= 0 && t4[j] < P) ? t4[j] : -1;
    }
  }
  __syncthreads();

  // rank within the warp's ops, rounds of 32 consecutive ones; kr packs
  // (tier << 16) | rank, or -1 for an op that takes no position
  int32_t kr[kItems];
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int key = key_s[pad(warp * kWarpOps + 32 * r + lane)];
    const unsigned peers = __match_any_sync(kFull, key);
    const int before = key >= 0 ? wc[warp][key] + __popc(peers & lower) : 0;
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) wc[warp][key] += __popc(peers);
    __syncwarp();
    kr[r] = key >= 0 ? (key << 16) | before : -1;
  }
  __syncthreads();
  int32_t cnt = 0;                     // this thread's tier: tile count
  if (tid < P) {                       // exclusive over warps, in place
    for (int w = 0; w < kTileWarps; ++w) {
      const int32_t c = wc[w][tid];
      wc[w][tid] = cnt;
      cnt += c;
    }
    cnt_s[tid] = cnt;
    __stcg((tile == 0 ? st.incl : st.agg) + static_cast<size_t>(tile) * P +
               tid, cnt);
    pre_s[tid] = 0;
  }
  __syncthreads();
  if (tid == 0) publish(st.flag + tile, 2 * epoch + (tile == 0));
  if (warp == 0 && tile > 0) {
    // each window: lane s reads predecessor top - s's counts (lanes past
    // the nearest inclusive prefix read nothing); one warp sum per tier
    for (int top = tile - 1;; top -= 32) {
      const int j = top - lane;
      const unsigned long long f = j >= 0 ? wait_flag(st, j, epoch)
                                          : 2 * epoch + 1;
      const unsigned pmask = __ballot_sync(kFull, f & 1);
      const int stop = pmask ? __ffs(pmask) - 1 : 31;
      const int32_t* row = j >= 0 && lane <= stop
          ? (f & 1 ? st.incl : st.agg) + static_cast<size_t>(j) * P
          : nullptr;
#pragma unroll 4
      for (int t = 0; t < P; ++t) {
        const int32_t sum = __reduce_add_sync(kFull, row ? __ldcg(row + t)
                                                         : 0);
        if (lane == 0) pre_s[t] += sum;
      }
      if (pmask) break;
    }
    __syncwarp();
    for (int t = lane; t < P; t += 32)
      __stcg(st.incl + static_cast<size_t>(tile) * P + t,
             pre_s[t] + cnt_s[t]);
    __syncwarp();
    if (lane == 0) publish(st.flag + tile, 2 * epoch + 1);
  }
  __syncthreads();
  if (tid < P) {                       // int32 wrap-around, as the reference
    const int32_t pre = pre_s[tid];
    cnt_s[tid] = wrap_add(wrap_add(lasts[tid], 1), pre);   // first position
    if (tile == tiles - 1) new_lasts[tid] = wrap_add(lasts[tid], pre + cnt);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int key = kr[r] >> 16;       // -1 stays -1
    key_s[pad(warp * kWarpOps + 32 * r + lane)] =
        kr[r] < 0 ? -1
                  : wrap_add(wrap_add(cnt_s[key], wc[warp][key]),
                             kr[r] & 0xffff);
  }
  __syncthreads();
  store_tile<kTierThreads>(pos, key_s, t0, n);
}

}  // namespace

// pos/matched: [n] outputs; new_state: [2] int32 (new_first, new_last);
// status, slots and epoch as for repro_stack_scan.  One launch of `tiles`
// blocks.  Returns the cudaGetLastError() after the launch (0 on success).
extern "C" int repro_queue_scan(const void* is_enq, const void* valid,
                                const void* first, const void* last,
                                void* pos, void* matched, void* new_state,
                                void* status, int slots,
                                unsigned long long epoch, int n,
                                void* stream) {
  const int tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  queue_scan_lookback<<<tiles, kQueueThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(is_enq), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(first), static_cast<const int32_t*>(last),
      static_cast<int32_t*>(pos), static_cast<uint8_t*>(matched),
      static_cast<int32_t*>(new_state), status, slots, epoch, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

// pos/tick/matched: [n] outputs; new_state: [2] int32 (new_last,
// new_ticket); status: the look-back buffer of this stream (status_view),
// zeroed when allocated, with slots >= tiles = max(1, ceil(n / 4096))
// flags and room for 8 * tiles * 4 bytes of values; epoch: above every
// epoch this buffer has seen.  One launch of `tiles` blocks.
extern "C" int repro_stack_scan(const void* is_push, const void* valid,
                                const void* last, const void* ticket,
                                void* pos, void* tick, void* matched,
                                void* new_state, void* status, int slots,
                                unsigned long long epoch, int n,
                                void* stream) {
  const int tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  stack_scan_lookback<<<tiles, kStackThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(is_push), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(last), static_cast<const int32_t*>(ticket),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(tick),
      static_cast<uint8_t*>(matched), static_cast<int32_t*>(new_state),
      status, slots, epoch, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

// tier: [n] int32, enq: [n] bool, lasts: [P] int32; pos: [n] int32 and
// new_lasts: [P] int32 outputs; status, slots and epoch as for
// repro_stack_scan, with room for 8 * tiles * P bytes of values.
// 1 <= P <= 256 (one tier per thread; the launcher groups larger P).
extern "C" int repro_tiered_scan(const void* tier, const void* enq,
                                 const void* lasts, void* pos,
                                 void* new_lasts, void* status, int slots,
                                 unsigned long long epoch, int n,
                                 int n_tiers, void* stream) {
  const int tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  tiered_scan_lookback<<<tiles, kTierThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tier), static_cast<const uint8_t*>(enq),
      static_cast<const int32_t*>(lasts), static_cast<int32_t*>(pos),
      static_cast<int32_t*>(new_lasts), status, slots, epoch, n, n_tiers,
      tiles);
  return static_cast<int>(cudaGetLastError());
}
