// Skeap's relaxed batch-DeleteMin over one wave: each dequeue, in wave
// order, takes the head of the best non-empty tier p*, or the first tier
// in [p*, p* + k] whose head is owned by the dequeue's own shard.
//
// Replaces the reference's lax.scan in repro/core/scan_queue.py:294-316
// (priority_queue_scan, relaxation > 0), which has no Pallas kernel.  Each
// dequeue reads the per-tier counts the ones before it wrote, so the walk
// is one dependent chain.  What bounds it on an H100 is that chain, not
// the bytes: the wave moves ~14 bytes an op (flags, shard, three
// outputs), 65,536 ops 0.9 MB, about 0.27 us at 3.35 TB/s.
//
// An event-driven walk.  While every dequeue takes p*, the heads of the
// tiers in (p*, p* + k] do not move, so "shard s owns a head in (p*, p* +
// k]" is a table over shards that stays fixed between events.  Dequeue d
// + t (the t-th of a run that starts at d) takes p* unless
//   t >= rem[p*], or low[s] and (head[p*] + t) mod n != s  (s its shard),
// and every dequeue before the first that stops takes p*, at head[p*] +
// t.  The stopping dequeue is an event: p* ran dry (the next non-empty
// tier becomes p*), or a relaxed serve, resolved alone: q is the lowest
// tier in (p*, p* + k] with an element whose head its shard owns (ties to
// the lowest tier, as jnp.argmax), and q's head steps.  Either way the
// table is rebuilt.  p* never falls within a wave (the sizes are fixed
// after the enqueues and the counts only rise).
//
// One block, one launch a wave; a ring of kRing dequeue entries in shared
// memory (op index, shard, and the reply's tier and position) between
// two roles:
//   * Warps 0-3 walk, window by window: kWindow = 1,024 dequeues, warp g
//     holding entries 256g + 32e + j in lane j (e < 8).  A pass runs the
//     test above on every unresolved entry without a branch (each warp a
//     warp minimum, the four minima in shared memory, a barrier of the
//     four) and stores the replies of the entries before the first stop.
//     Warp 0 then takes the event alone (the others wait at a second
//     barrier and read its state: p*, its size, head and owner, low[]),
//     and the next pass tests the rest of the window.  So the chain costs
//     one pass a window plus one an event.  low[] is a 64-bit register
//     mask when n_shards <= 64, a bit array in shared memory above that.
//     Tier state (remaining size, head, the head's floor modulo n_shards)
//     lives in shared memory, p*'s in registers, and with k < 32 the
//     window (p*, p* + k] in warp 0's lanes (one tier a lane: an event
//     is a ballot and one lane's update, and the window goes back to
//     shared memory when p* moves); a wider window is read 32 tiers a
//     ballot, so any k and P up to MAX_TIERS are served.  The walkers
//     touch only shared memory.
//   * No division on the chain: (hmod[p*] + u) mod n by a reciprocal taken
//     once a launch (modulo.cuh), then stepped 32 at a time.  The int32
//     head wraps past INT32_MAX, and where n_shards does not divide 2^32 a
//     +u shift of the floor modulo is wrong across the wrap: a pass whose
//     run can cross it (head[p*] > INT32_MAX - 1,023) takes the exact floor
//     modulo of each wrapped head, by the same reciprocal.
//   * Nine producer warps (those from warp 4 on that do not share warp 0's
//     scheduler; warps 4, 8 and 12 only wait at the end) keep the ring
//     full and empty it.  A round takes 2,304 ops, 8 consecutive ones a
//     thread, loaded a round ahead (16- and 8-byte loads), writes ⊥
//     defaults for all of them (16- and 8-byte stores), maps a shard
//     outside [0, n_shards) to n_shards (it owns nothing), compacts the
//     dequeues in wave order (a warp scan of the counts), appends them to
//     the ring and publishes the count.  Before a round overwrites ring
//     entries they copy those entries' replies, which the walkers have
//     resolved, over the defaults (a producer barrier lies between the two
//     writes); the rest at the end.
//   * The walkers wait only when fewer than a window of entries is
//     published and the wave is not done, so the passes do not depend on
//     timing (relaxed_walk_model in ref.py counts the same ones).  Warp 0
//     shows the producers its progress every kPublish entries, before a
//     wait and at the end.  The counters live in shared memory: no global
//     state, nothing to guard under CUDA-graph capture.  A wait that never
//     ends traps.
//   * Heads wrap as in JAX (unsigned adds).  No float, no atomics whose
//     order shows in a result.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's clock
// build, PERF.md row 7): a step (a pass or an event) costs 1,000 to 2,000
// cycles, far above the few dozen of its dependent instructions: single
// warps run these short dependent chains at a small fraction of an
// instruction a cycle, so the design spends warps to cut steps.
//
// A second instantiation (kClock) counts the walk's passes and events and
// its clock64 cycles, waiting included, for the smoke's cycles a step; the
// wrapper launches it only when it is passed a stats buffer.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "modulo.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kWalkers = 4;                // warps 0-3 walk
constexpr int kProducers = 9 * 32;         // warps 5-7, 9-11, 13-15
constexpr int kPer = 8;                    // ops per producer a round
constexpr int kTile = kProducers * kPer;   // ops a round
constexpr int kLaneDeq = 8;                // dequeues a lane looks at
constexpr int kWalk = 32 * kLaneDeq;       // dequeues a walker warp tests
constexpr int kWindow = kWalkers * kWalk;  // dequeues a window
constexpr int kRing = 8192;                // dequeue entries, a power of 2
constexpr int kPublish = 1024;             // the walker shows progress
constexpr int kStats = 8;                  // int64 words of the clock build
// a wait that never ends traps (a launch error) instead of holding the card
constexpr uint32_t kSpinLimit = 1u << 26;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kBottom = -1;
static_assert(kRing >= kTile + kWindow + kPublish, "ring too small");
static_assert(kWarps == 16 && kWalkers == 4 && kProducers == 9 * 32,
              "roles: warp 0 alone on its scheduler");
static_assert((kRing & (kRing - 1)) == 0, "ring size not a power of 2");

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
}

struct Shared {                 // the walker's and producers' meeting place
  int32_t* idx;                 // [kRing] a dequeue's op index
  int32_t* shard;               // [kRing] its shard
  int32_t* rtier;               // [kRing + 32] its reply's tier (32 spare)
  int32_t* rpos;                // [kRing + 32] its reply's position
  int32_t* rem;                 // [P] remaining size of a tier
  int32_t* head;                // [P] its head position
  int32_t* hmod;                // [P] the head's floor modulo n_shards
  uint32_t* low;                // low[] bits when n_shards > 64, n + 1
  volatile int* produced;       // entries published << 1 | wave done
  volatile int* consumed;       // entries the walker has resolved
  int* warp_tot;                // [12] dequeues of each producer warp
};

// ---- producers ----
// the replies of ring entries [from, to), resolved by the walker, to the
// outputs: producer pt takes entries from + pt, from + pt + kProducers, ...
__device__ __forceinline__ void write_back(const Shared& sh, int from, int to,
                                           int pt, int32_t* tier,
                                           int32_t* pos, uint8_t* matched) {
  if (from >= to) return;
  for (uint32_t spins = 0; *sh.consumed < to; ++spins) {
    if (spins == kSpinLimit) asm volatile("trap;");
    __nanosleep(32);
  }
  __threadfence_block();
  for (int r = from + pt; r < to; r += kProducers) {
    const int i = sh.idx[r & (kRing - 1)], t = sh.rtier[r & (kRing - 1)];
    tier[i] = t;
    pos[i] = sh.rpos[r & (kRing - 1)];
    matched[i] = t >= 0;
  }
}

// a producer's 8 consecutive ops: flag bytes and shards, vector loads
// where the pointers allow
struct Raw {
  uint2 deq;
  int4 s0, s1;
};

__device__ __forceinline__ Raw load_raw(const uint8_t* deq,
                                        const int32_t* shard_of, int i0,
                                        int n, bool vec) {
  Raw r{};
  if (i0 >= n) return r;
  if (vec && i0 + kPer <= n) {
    r.deq = *reinterpret_cast<const uint2*>(deq + i0);
    r.s0 = *reinterpret_cast<const int4*>(shard_of + i0);
    r.s1 = *reinterpret_cast<const int4*>(shard_of + i0 + 4);
    return r;
  }
  uint32_t b[2] = {0u, 0u};
  int s[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool in = i0 + j < n;
    b[j >> 2] |= (in && deq[i0 + j] ? 1u : 0u) << (8 * (j & 3));
    s[j] = in ? shard_of[i0 + j] : 0;
  }
  r.deq = make_uint2(b[0], b[1]);
  r.s0 = make_int4(s[0], s[1], s[2], s[3]);
  r.s1 = make_int4(s[4], s[5], s[6], s[7]);
  return r;
}

template <bool kClock>
__device__ void produce(const uint8_t* __restrict__ deq,
                        const int32_t* __restrict__ shard_of,
                        int32_t* __restrict__ tier, int32_t* __restrict__ pos,
                        uint8_t* __restrict__ matched, int n,
                        uint32_t n_sh, const Shared& sh, long long* stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pw = warp - (warp >> 2) - 4;   // 0..8
  const int pt = pw * 32 + lane;
  const bool vec = (reinterpret_cast<uintptr_t>(deq) & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(shard_of) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(tier) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pos) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(matched) & 7) == 0;
  long long t_wb = 0;
  int base = 0, written = 0;               // entries published, written
  Raw cur = load_raw(deq, shard_of, pt * kPer, n, vec);
  for (int tb = 0; tb < n; tb += kTile) {
    const int i0 = tb + pt * kPer;
    const Raw nxt = load_raw(deq, shard_of, i0 + kTile, n, vec);
    // ⊥ defaults for all 8 ops; a dequeue's reply overwrites its own in a
    // later round's write-back, after a barrier of the producers
    if (vec && i0 + kPer <= n) {
      const int4 m1 = make_int4(-1, -1, -1, -1);
      reinterpret_cast<int4*>(tier + i0)[0] = m1;
      reinterpret_cast<int4*>(tier + i0)[1] = m1;
      reinterpret_cast<int4*>(pos + i0)[0] = m1;
      reinterpret_cast<int4*>(pos + i0)[1] = m1;
      *reinterpret_cast<uint2*>(matched + i0) = make_uint2(0u, 0u);
    } else {
      for (int j = 0; j < kPer && i0 + j < n; ++j) {
        tier[i0 + j] = -1;
        pos[i0 + j] = kBottom;
        matched[i0 + j] = 0;
      }
    }
    // a shard outside [0, n_shards) owns no head: it becomes n_shards
    int s[kPer] = {cur.s0.x, cur.s0.y, cur.s0.z, cur.s0.w,
                   cur.s1.x, cur.s1.y, cur.s1.z, cur.s1.w};
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      s[j] = static_cast<uint32_t>(s[j]) < n_sh ? s[j] : n_sh;
    uint32_t mask = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      mask |= (((j < 4 ? cur.deq.x : cur.deq.y) >> (8 * (j & 3))) & 0xffu
                   ? 1u : 0u) << j;
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sh.warp_tot[pw] = incl;
    producers_sync();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kProducers / 32; ++w) {
      const int v = sh.warp_tot[w];
      before += w < pw ? v : 0;
      total += v;
    }
    // room: the entries this round overwrites go to the outputs first
    const int need = base + total - kRing;
    if (need > written) {
      const long long t0 = kClock ? clock64() : 0;
      write_back(sh, written, need, pt, tier, pos, matched);
      if (kClock) t_wb += clock64() - t0;
      written = need;
      producers_sync();                    // every copy read before reuse
    }
    int off = base + before + incl - cnt;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if ((mask >> j) & 1u) {
        sh.idx[off & (kRing - 1)] = i0 + j;
        sh.shard[off & (kRing - 1)] = s[j];
        ++off;
      }
    }
    producers_sync();                      // entries written, totals read
    base += total;
    if (pt == 0) {
      __threadfence_block();
      *sh.produced = base << 1 | (tb + kTile >= n ? 1 : 0);
    }
    cur = nxt;
  }
  write_back(sh, written, base, pt, tier, pos, matched);
  if (kClock && pt == 0) stats[5] = t_wb;
}

// ---- the walker: warp 0 ----
// the first tier >= from with an element, or P
__device__ __forceinline__ int next_tier(const int32_t* rem, int from, int P,
                                         int lane) {
  for (int c0 = from; c0 < P; c0 += 32) {
    const int c = c0 + lane;
    const unsigned b = __ballot_sync(kFull, c < P && rem[c] > 0);
    if (b) return c0 + __ffs(b) - 1;
  }
  return P;
}

// One pass of the test over a walker warp's quarter of the window: the
// first t in [t0, lim) of entries tq + 32e + lane that stops p*'s run
// (kWindow when none does), as a warp minimum.  Entry t is run position
// u = t - t0; s[e] holds entry tq + 32e + lane's shard, in [0, n_shards]
// (n_shards: a shard outside the range, owning nothing).  kWrap: the run
// can cross the int32 wrap, so each head's floor modulo is taken exactly;
// otherwise h(u) = (hmod[p*] + u) mod n, stepped by 32 mod n from a
// lane's entry to its next.
template <bool kWide, bool kWrap>
__device__ __forceinline__ int first_stop(const int (&s)[kLaneDeq], int tq,
                                          int lane, int t0, int lim,
                                          int rem_p, int32_t head_p,
                                          int hm_p, uint64_t low,
                                          const uint32_t* bits,
                                          const repro::FastMod& mod,
                                          uint32_t spread, uint32_t c32) {
  const int lim2 = min(lim, t0 + rem_p);
  // (hmod + tq + lane - t0) mod n, kept non-negative by spread >=
  // kWindow, a multiple of n
  uint32_t h = mod.of(static_cast<uint32_t>(hm_p + tq + lane - t0) + spread);
  int first = kWindow;
#pragma unroll
  for (int e = 0; e < kLaneDeq; ++e) {
    const int t = tq + e * 32 + lane;
    const uint32_t sv = static_cast<uint32_t>(s[e]);
    const uint32_t he = kWrap ? static_cast<uint32_t>(mod.floor_of(
                                    wrap_add(head_p, t - t0)))
                              : h;
    uint32_t own;
    if (kWide) {
      own = (bits[sv >> 5] >> (sv & 31)) & 1u;
    } else {
      uint64_t sh64;                       // shr clamps a shift of 64 to 0
      asm("shr.b64 %0, %1, %2;" : "=l"(sh64) : "l"(low), "r"(sv));
      own = static_cast<uint32_t>(sh64) & 1u;
    }
    const bool stop = t >= lim2 || (own && he != sv && t >= t0);
    first = min(first, stop ? t : kWindow);
    h += c32;
    h = h >= mod.n ? h - mod.n : h;
  }
  return __reduce_min_sync(kFull, first);
}

__device__ __forceinline__ void walkers_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(kWalkers * 32) : "memory");
}

// Warp 0's walk state, read by the other walker warps after a barrier.
struct WalkState {
  int ps, hi, rem_p, head_p, hm_p, t0, lim, pad;
  unsigned long long low;
  int mins[kWalkers];
};

template <bool kWide, bool kClock>
__device__ void walk(int32_t* __restrict__ n_relaxed_out, int P, int k,
                     const repro::FastMod mod, const Shared& sh,
                     WalkState& st, long long* stats) {
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int tq = g * kWalk;                // this warp's quarter
  const bool lead = g == 0;
  const int words = (static_cast<int>(mod.n) + 32) >> 5;
  const uint32_t spread = mod.n * ((kWindow + mod.n - 1) / mod.n);
  const uint32_t c32 = mod.of(32);
  const long long t_start = kClock ? clock64() : 0;
  long long waited = 0, steps = 0, dry = 0;
  int n_rel = 0;
  // p* and its tier in registers; the window (ps, hi] in shared memory
  int ps = 0, hi = 0;
  int32_t rem_p = 0, head_p = 0;
  int hm_p = 0;
  uint64_t low = 0;
  // With k < 32 warp 0's lane j holds tier ps + 1 + j of the window (its
  // size, head and owner) in registers, so an event reads and writes no
  // tier state in shared memory; the tiers return there when p* moves
  const bool in_regs = k < 32;
  int wrem = 0, whmod = -1;
  int32_t whead = 0;
  auto window_load = [&]() {
    const int c = ps + 1 + lane;
    const bool a = c <= hi;
    wrem = a ? sh.rem[c] : 0;
    whead = a ? sh.head[c] : 0;
    whmod = a ? sh.hmod[c] : -1;
  };
  auto window_store = [&]() {
    const int c = ps + 1 + lane;
    if (c <= hi) {
      sh.rem[c] = wrem;
      sh.head[c] = whead;
      sh.hmod[c] = whmod;
    }
  };
  auto owners = [&](int h) -> uint64_t {   // owner h of each lane's tier
    if (kWide) {
      if (h >= 0) atomicOr(&sh.low[h >> 5], 1u << (h & 31));
      return 0;
    }
    const unsigned lo = __reduce_or_sync(kFull,
                                         h >= 0 && h < 32 ? 1u << h : 0u);
    const unsigned up = __reduce_or_sync(kFull,
                                         h >= 32 ? 1u << (h - 32) : 0u);
    return static_cast<uint64_t>(up) << 32 | lo;
  };
  auto rebuild = [&]() {                   // low[] over (ps, hi]
    if (kWide) {
      for (int w = lane; w < words; w += 32) sh.low[w] = 0;
      __syncwarp();
    }
    uint64_t m = 0;
    if (in_regs) {
      m = owners(wrem > 0 ? whmod : -1);
    } else {
      for (int c0 = ps + 1; c0 <= hi; c0 += 32) {
        const int c = c0 + lane;
        m |= owners(c <= hi && sh.rem[c] > 0 ? sh.hmod[c] : -1);
      }
    }
    if (kWide) __syncwarp();
    low = m;
  };
  auto enter = [&]() {                     // ps is a new p*
    rem_p = sh.rem[ps];
    head_p = sh.head[ps];
    hm_p = sh.hmod[ps];
    hi = min(ps + k, P - 1);
    if (in_regs) window_load();
    rebuild();
  };
  // warp 0 leads: it waits for the producers, runs the events and shows
  // the others its state; each warp tests and stores its own quarter
  auto show = [&](int t0) {
    if (lane == 0) {
      st.ps = ps;
      st.hi = hi;
      st.rem_p = rem_p;
      st.head_p = head_p;
      st.hm_p = hm_p;
      st.t0 = t0;
      st.low = low;
    }
  };
  auto look = [&]() {
    ps = st.ps;
    hi = st.hi;
    rem_p = st.rem_p;
    head_p = st.head_p;
    hm_p = st.hm_p;
    low = st.low;
    return st.t0;
  };
  if (lead) {
    ps = next_tier(sh.rem, 0, P, lane);
    if (ps < P) enter();
    show(0);
  }
  walkers_sync();
  if (!lead) look();
  int d = 0, seen = 0, shown = 0;
  bool fin = false;
  // window by window: kWindow entries (fewer at the wave's end), each
  // resolved by passes of the test, one more after each event
  for (;;) {
    if (lead) {
      if (!fin && seen - d < kWindow) {
        // fewer than a window's entries published: wait for the next round
        const long long t0 = kClock ? clock64() : 0;
        int word;
        uint32_t spins = 0;
        do {
          if (++spins == kSpinLimit) asm volatile("trap;");
          word = __shfl_sync(kFull, lane == 0 ? *sh.produced : 0, 0);
        } while (!(word & 1) && (word >> 1) - d < kWindow);
        __threadfence_block();
        if (kClock) waited += clock64() - t0;
        fin = word & 1;
        seen = word >> 1;
      }
      if (lane == 0) st.lim = min(kWindow, seen - d);
    }
    walkers_sync();
    const int lim = st.lim;
    if (lim == 0) break;
    int s[kLaneDeq];
#pragma unroll
    for (int e = 0; e < kLaneDeq; ++e)
      s[e] = sh.shard[(d + tq + e * 32 + lane) & (kRing - 1)];
    int t0 = 0;                            // entries before t0 resolved
    while (t0 < lim) {
      if (kClock) ++steps;
      int jb = lim;
      if (ps < P) {
        const int mine =
            head_p > INT_MAX - (kWindow - 1)
                ? first_stop<kWide, true>(s, tq, lane, t0, lim, rem_p,
                                          head_p, hm_p, low, sh.low, mod,
                                          spread, c32)
                : first_stop<kWide, false>(s, tq, lane, t0, lim, rem_p,
                                           head_p, hm_p, low, sh.low, mod,
                                           spread, c32);
        if (lane == 0) st.mins[g] = mine;
        walkers_sync();
#pragma unroll
        for (int w = 0; w < kWalkers; ++w) jb = min(jb, st.mins[w]);
      }
      // replies of [t0, jb): p*'s run, or ⊥ once every tier ran dry;
      // the others go to a spare slot
#pragma unroll
      for (int e = 0; e < kLaneDeq; ++e) {
        const int t = tq + e * 32 + lane;
        const int r = t >= t0 && t < jb ? (d + t) & (kRing - 1)
                                        : kRing + lane;
        sh.rtier[r] = ps < P ? ps : -1;
        sh.rpos[r] = ps < P ? wrap_add(head_p, t - t0) : kBottom;
      }
      if (ps == P) break;
      if (lead) {
        rem_p -= jb - t0;
        head_p = wrap_add(head_p, jb - t0);
        hm_p = mod.floor_of(head_p);
        t0 = jb;
        if (rem_p == 0) {                  // event: p* ran dry
          if (lane == 0) sh.rem[ps] = 0;
          if (in_regs) {                   // the window's first, or past it
            const unsigned b = __ballot_sync(kFull, wrem > 0);
            window_store();
            __syncwarp();
            ps = b ? ps + __ffs(b) : next_tier(sh.rem, hi + 1, P, lane);
          } else {
            __syncwarp();
            ps = next_tier(sh.rem, ps + 1, P, lane);
          }
          if (ps < P) enter();
          if (kClock) ++dry;
        } else if (jb < lim) {             // event: a relaxed serve
          const int r = (d + jb) & (kRing - 1);
          const int sd = sh.shard[r];
          if (in_regs) {                   // low[] held it: some lane owns
            const unsigned bq = __ballot_sync(kFull,
                                              wrem > 0 && whmod == sd);
            if (lane == __ffs(bq) - 1) {
              sh.rtier[r] = ps + 1 + lane;
              sh.rpos[r] = whead;
              --wrem;
              whead = wrap_add(whead, 1);
              whmod = mod.floor_of(whead);
            }
          } else {
            int q = hi + 1;
            for (int c0 = ps + 1; c0 <= hi; c0 += 32) {
              const int c = c0 + lane;
              const unsigned bq = __ballot_sync(
                  kFull, c <= hi && sh.rem[c] > 0 && sh.hmod[c] == sd);
              if (bq) {
                q = c0 + __ffs(bq) - 1;
                break;
              }
            }
            __syncwarp();
            if (lane == 0) {               // low[] held it: q <= hi
              const int32_t h = sh.head[q];
              sh.rtier[r] = q;
              sh.rpos[r] = h;
              sh.rem[q] -= 1;
              sh.head[q] = wrap_add(h, 1);
              sh.hmod[q] = mod.floor_of(wrap_add(h, 1));
            }
          }
          __syncwarp();
          ++t0;
          ++n_rel;
          rebuild();                       // p* stays
        }
        show(t0);
      }
      walkers_sync();
      if (!lead) t0 = look();
    }
    walkers_sync();                        // the window's replies stored
    d += lim;
    // the replies before d are in the ring: show the producers every
    // kPublish entries and before a wait
    if (lead && (d - shown >= kPublish || (!fin && seen - d < kWindow))) {
      if (lane == 0) {
        __threadfence_block();
        *sh.consumed = d;
      }
      shown = d;
    }
  }
  if (lead && in_regs && ps < P) window_store();
  __syncwarp();
  if (lead && lane == 0) {
    __threadfence_block();
    *sh.consumed = d;                      // every reply is in the ring
    if (ps < P) sh.rem[ps] = rem_p;
    *n_relaxed_out = n_rel;
    if (kClock) {
      stats[0] = steps;
      stats[1] = n_rel;
      stats[2] = dry;
      stats[3] = clock64() - t_start;
      stats[4] = waited;
      stats[6] = d;
      stats[7] = 0;
    }
  }
}

template <bool kWide, bool kClock>
__global__ void __launch_bounds__(kThreads, 1)
relaxed_deletemin(const uint8_t* __restrict__ deq,
                  const int32_t* __restrict__ shard_of,
                  const int32_t* __restrict__ avail,
                  const int32_t* __restrict__ firsts,
                  int32_t* __restrict__ tier, int32_t* __restrict__ pos,
                  uint8_t* __restrict__ matched,
                  int32_t* __restrict__ taken_out,
                  int32_t* __restrict__ n_relaxed_out, long long* stats,
                  int n, int P, int k, int n_shards, uint32_t recip) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int produced_s, consumed_s;
  __shared__ int warp_tot[kProducers / 32];
  __shared__ WalkState st;
  Shared sh;
  sh.idx = reinterpret_cast<int32_t*>(smem);
  sh.shard = sh.idx + kRing;
  sh.rtier = sh.shard + kRing;
  sh.rpos = sh.rtier + kRing + 32;
  sh.rem = sh.rpos + kRing + 32;
  sh.head = sh.rem + P;
  sh.hmod = sh.head + P;
  sh.low = reinterpret_cast<uint32_t*>(sh.hmod + P);
  sh.produced = &produced_s;
  sh.consumed = &consumed_s;
  sh.warp_tot = warp_tot;
  const repro::FastMod mod{static_cast<uint32_t>(n_shards), recip};
  for (int r = threadIdx.x; r < kRing; r += kThreads)
    sh.shard[r] = 0;                       // a valid shard before its first
  for (int c = threadIdx.x; c < P; c += kThreads) {
    const int32_t f = firsts[c];
    sh.rem[c] = avail[c];
    sh.head[c] = f;
    sh.hmod[c] = mod.floor_of(f);
  }
  if (threadIdx.x == 0) {
    produced_s = 0;
    consumed_s = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < kWalkers)
    walk<kWide, kClock>(n_relaxed_out, P, k, mod, sh, st, stats);
  else if (warp & 3)                      // warps 4, 8, 12 wait
    produce<kClock>(deq, shard_of, tier, pos, matched, n, mod.n, sh, stats);
  __syncthreads();
  for (int c = threadIdx.x; c < P; c += kThreads)
    taken_out[c] = static_cast<int32_t>(static_cast<uint32_t>(avail[c]) -
                                        static_cast<uint32_t>(sh.rem[c]));
}

template <bool kWide, bool kClock>
int launch(const void* deq, const void* shard_of, const void* avail,
           const void* firsts, void* tier, void* pos, void* matched,
           void* taken, void* n_relaxed, void* stats, int n, int P, int k,
           int n_shards, int64_t smem, cudaStream_t stream) {
  auto* kern = relaxed_deletemin<kWide, kClock>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(deq), static_cast<const int32_t*>(shard_of),
      static_cast<const int32_t*>(avail), static_cast<const int32_t*>(firsts),
      static_cast<int32_t*>(tier), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(matched), static_cast<int32_t*>(taken),
      static_cast<int32_t*>(n_relaxed), static_cast<long long*>(stats), n, P,
      k, n_shards, repro::modulo_recip(static_cast<uint32_t>(n_shards)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a launch: the ring (four words an entry, 64
// spare), three words a tier, and low[]'s bits when n_shards > 64.
extern "C" int64_t repro_relaxed_smem(int P, int n_shards) {
  const int64_t words = n_shards > 64 ? (n_shards + 32) / 32 : 0;
  return (4 * static_cast<int64_t>(kRing) + 64 +
          3 * static_cast<int64_t>(P) + words) * sizeof(int32_t);
}

// deq: [n] bool; shard_of: [n] int32 in [0, n_shards); avail/firsts: [P]
// int32, the tier sizes after the wave's enqueues and the heads.  Writes
// tier/pos: [n] int32 (-1 and ⊥ where no element was taken), matched: [n]
// bool, taken: [P] int32 and n_relaxed: one int32.  With stats non-null
// (kStats int64) the clock build runs and writes there its steps, relaxed
// serves, dry events, walk cycles, the walker's wait cycles, the
// producers' cycles in write-backs before a round, and the dequeues walked.  k >= 0 and n_shards >= 1; the caller checks P and n_shards
// against the shared memory.  Returns cudaGetLastError() after the launch.
extern "C" int repro_relaxed_deletemin(const void* deq, const void* shard_of,
                                       const void* avail, const void* firsts,
                                       void* tier, void* pos, void* matched,
                                       void* taken, void* n_relaxed,
                                       void* stats, int n, int P, int k,
                                       int n_shards, void* stream) {
  const int64_t smem = repro_relaxed_smem(P, n_shards);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool wide = n_shards > 64;
  if (stats != nullptr)
    return wide ? launch<true, true>(deq, shard_of, avail, firsts, tier, pos,
                                     matched, taken, n_relaxed, stats, n, P,
                                     k, n_shards, smem, s)
                : launch<false, true>(deq, shard_of, avail, firsts, tier,
                                      pos, matched, taken, n_relaxed, stats,
                                      n, P, k, n_shards, smem, s);
  return wide ? launch<true, false>(deq, shard_of, avail, firsts, tier, pos,
                                    matched, taken, n_relaxed, stats, n, P,
                                    k, n_shards, smem, s)
              : launch<false, false>(deq, shard_of, avail, firsts, tier, pos,
                                     matched, taken, n_relaxed, stats, n, P,
                                     k, n_shards, smem, s);
}

extern "C" int repro_relaxed_stats_words() { return kStats; }
