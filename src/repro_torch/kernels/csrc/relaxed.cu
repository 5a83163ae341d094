// Skeap's relaxed batch-DeleteMin over one wave: each dequeue, in wave
// order, takes the head of the best non-empty tier p*, or the first tier
// in [p*, p* + k] whose head is owned by the dequeue's own shard.
//
// Replaces the reference's lax.scan in repro/core/scan_queue.py:294-316
// (priority_queue_scan, relaxation > 0), which has no Pallas kernel.  Each
// step reads the per-tier counts the step before it wrote, so the walk
// over a wave's dequeues is sequential.  One block of kThreads threads
// runs it, tile by tile:
//
//   1. every thread writes the ⊥ defaults for its kPer consecutive ops and
//      counts their dequeues; a block-wide exclusive prefix of the counts
//      compacts the tile's dequeue indices (and their shards) into shared
//      memory, in wave order;
//   2. warp 0 walks them.  Its lanes hold a window of 32 tiers in
//      registers: lane j holds tier base + j's remaining size, head, and
//      the head's floor modulo n_shards (taken again whenever the head
//      moves: a +1 step would be wrong where the head wraps and n_shards
//      does not divide 2^32).  A ballot over "non-empty" gives p*.  Then
//      a batch: lane j looks at dequeue d + j, which takes p* when p*
//      still holds an element for it and either its shard owns p*'s head
//      or no tier in (p*, p* + k] has a head its shard owns (the tiers
//      below p* do not move while only p* serves); a ballot gives the
//      first dequeue that stops the batch, and every dequeue before it
//      is resolved at once.  The dequeue that stopped it (a relaxed
//      serve) goes alone: a ballot over "non-empty, owned here and
//      within [p*, p* + k]" gives q (the lowest set lane, so ties go to
//      the lowest tier, as jnp.argmax), and the lane that holds q writes
//      the reply and steps its tier.  p* never falls within a wave (the
//      sizes are fixed after the enqueues and the counts only rise), so
//      the window only moves up: when [p*, p* + k] leaves it, the lanes
//      write it back to shared memory (one entry a tier, any P up to the
//      shared memory) and load the next.  With P <= 32 it never moves.
//      A relaxation wider than the window (k > 31) takes the one-at-a-
//      time path and looks past the window in shared memory.
//
// Heads are int32 and wrap as in JAX (unsigned adds); the owner test is a
// floor modulo, as jnp.mod.
//
// What bounds it on an H100: latency, not bytes.  The wave moves ~14
// bytes an op (flags, shard, three outputs): 65,536 ops are 0.9 MB, about
// 0.27 us at 3.35 TB/s.  Each dequeue depends on the ones before it
// through the tiers they took, so the walk is one warp's dependent chain:
// one batch step a 32 dequeues that take p*, one single step a relaxed
// serve.  That latency, not the bytes, binds.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // consecutive ops per thread
constexpr int kTile = kThreads * kPer;     // ops per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kBottom = -1;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// floor modulo, as jnp.mod: in [0, n) for a negative head too
__device__ __forceinline__ int floor_mod(int32_t h, int n) {
  const int r = h % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads)
relaxed_deletemin(const uint8_t* __restrict__ deq,
                  const int32_t* __restrict__ shard_of,
                  const int32_t* __restrict__ avail,
                  const int32_t* __restrict__ firsts,
                  int32_t* __restrict__ tier, int32_t* __restrict__ pos,
                  uint8_t* __restrict__ matched,
                  int32_t* __restrict__ taken_out,
                  int32_t* __restrict__ n_relaxed_out, int n, int P, int k,
                  int n_shards) {
  extern __shared__ int32_t smem[];
  int32_t* s_rem = smem;                   // [P] remaining size of a tier
  int32_t* s_head = s_rem + P;             // [P] its head position
  int32_t* s_hmod = s_head + P;            // [P] head mod n_shards
  int32_t* didx = s_hmod + P;              // [kTile] op index of a dequeue
  int32_t* dshard = didx + kTile;          // [kTile] its issuing shard
  __shared__ int32_t warp_off[kWarps];
  __shared__ int32_t tile_count;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < P; c += kThreads) {
    s_rem[c] = avail[c];
    s_head[c] = firsts[c];
    s_hmod[c] = floor_mod(firsts[c], n_shards);
  }
  __syncthreads();
  // warp 0's window: tiers [base, base + 32), lane j holds tier base + j
  int base = 0;
  int32_t rem = 0, head = 0, hmod = 0;
  if (warp == 0 && lane < P) {
    rem = s_rem[lane];
    head = s_head[lane];
    hmod = s_hmod[lane];
  }
  bool empty = false;                      // every tier ran dry
  int n_rel = 0;                           // relaxed serves (lane 0)

  for (int tb = 0; tb < n; tb += kTile) {
    // ---- 1. defaults, and the tile's dequeues compacted in order ----
    const int i0 = tb + threadIdx.x * kPer;
    uint32_t mask = 0;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = i0 + j;
      if (i < n) {
        tier[i] = -1;
        pos[i] = kBottom;
        matched[i] = 0;
        if (deq[i]) {
          mask |= 1u << j;
          ++cnt;
        }
      }
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kWarps ? warp_off[lane] : 0;
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += v;
      }
      if (lane < kWarps) warp_off[lane] = wi - w;
      if (lane == kWarps - 1) tile_count = wi;
    }
    __syncthreads();
    int off = warp_off[warp] + incl - cnt;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if ((mask >> j) & 1u) {
        didx[off] = i0 + j;
        dshard[off] = shard_of[i0 + j];
        ++off;
      }
    }
    __syncthreads();

    // ---- 2. warp 0 walks the tile's dequeues ----
    if (warp == 0 && !empty) {
      const int m = tile_count;
      for (int d = 0; d < m;) {
        const bool ne = rem > 0;
        const unsigned b = __ballot_sync(kFull, ne);
        const int f = b ? __ffs(b) - 1 : 32;        // p* = base + f
        const int hi = min(base + f + k, P - 1);    // window end, clipped
        if (f == 32 || (f > 0 && hi > base + 31)) {
          // [p*, p* + k] leaves the window: write it back, move it up
          if (base + lane < P) {
            s_rem[base + lane] = rem;
            s_head[base + lane] = head;
            s_hmod[base + lane] = hmod;
          }
          base += f;
          if (base >= P) {                 // every tier is empty: this
            empty = true;                  // dequeue and all later ones
            break;                         // keep their ⊥ defaults
          }
          __syncwarp();
          const int c = base + lane;
          rem = c < P ? s_rem[c] : 0;
          head = c < P ? s_head[c] : 0;
          hmod = c < P ? s_hmod[c] : 0;
          continue;                        // the same dequeue again
        }
        if (hi <= base + 31) {
          // the batch: lane j's dequeue d + j takes p* unless it stops
          const int rem_p = __shfl_sync(kFull, rem, f);
          const int32_t head_p = __shfl_sync(kFull, head, f);
          const bool in = d + lane < m;
          const int s_j = in ? dshard[d + lane] : -1;
          const int32_t h_j = wrap_add(head_p, lane);
          bool lower = false;              // a tier below p* owned here
          for (int c = f + 1; c <= hi - base; ++c) {
            const int rc = __shfl_sync(kFull, rem, c);
            const int hc = __shfl_sync(kFull, hmod, c);
            lower |= rc > 0 && hc == s_j;
          }
          const bool stop = !in || lane >= rem_p ||
                            (lower && floor_mod(h_j, n_shards) != s_j);
          const unsigned sb = __ballot_sync(kFull, stop);
          const int jb = sb ? __ffs(sb) - 1 : 32;
          if (lane < jb) {
            const int i = didx[d + lane];
            tier[i] = base + f;
            pos[i] = h_j;
            matched[i] = 1;
          }
          if (lane == f) {
            rem -= jb;
            head = wrap_add(head, jb);
            hmod = floor_mod(head, n_shards);
          }
          d += jb;
          if (jb > 0) continue;
        }
        // one dequeue alone: a relaxed serve, or [p*, p* + k] wider than
        // the window
        const int s = dshard[d];
        const bool loc = ne && lane >= f && base + lane <= hi && hmod == s;
        const unsigned bl = __ballot_sync(kFull, loc);
        int ql = bl ? __ffs(bl) - 1 : f;
        if (!bl && hi > base + 31) {
          // k > 31: the rest of [p*, p* + k] lies past the window, in
          // shared memory (p* = base here); look there, 32 tiers a ballot
          int c0 = base + 32;
          for (; c0 <= hi; c0 += 32) {
            const int c = c0 + lane;
            const bool hit = c <= hi && s_rem[c] > 0 && s_hmod[c] == s;
            const unsigned bb = __ballot_sync(kFull, hit);
            if (bb) {
              c0 += __ffs(bb) - 1;
              break;
            }
          }
          if (c0 <= hi) {                  // tier c0 serves, from memory
            if (lane == 0) {
              const int i = didx[d];
              tier[i] = c0;
              pos[i] = s_head[c0];
              matched[i] = 1;
              s_rem[c0] -= 1;
              s_head[c0] = wrap_add(s_head[c0], 1);
              s_hmod[c0] = floor_mod(s_head[c0], n_shards);
            }
            __syncwarp();
            ql = -1;                       // no lane of the window serves
          }
        }
        if (lane == ql) {
          const int i = didx[d];
          tier[i] = base + ql;
          pos[i] = head;
          matched[i] = 1;
          rem -= 1;
          head = wrap_add(head, 1);
          hmod = floor_mod(head, n_shards);
        }
        n_rel += ql != f;
        ++d;
      }
    }
    __syncthreads();
  }

  if (warp == 0 && base + lane < P) s_rem[base + lane] = rem;
  __syncthreads();
  for (int c = threadIdx.x; c < P; c += kThreads)
    taken_out[c] = static_cast<int32_t>(static_cast<uint32_t>(avail[c]) -
                                        static_cast<uint32_t>(s_rem[c]));
  if (threadIdx.x == 0) *n_relaxed_out = n_rel;
}

}  // namespace

extern "C" int64_t repro_relaxed_smem(int P) {
  return (3 * static_cast<int64_t>(P) + 2 * kTile) * sizeof(int32_t);
}

// deq: [n] bool; shard_of: [n] int32; avail/firsts: [P] int32, the tier
// sizes after the wave's enqueues and the heads.  Writes tier/pos: [n]
// int32 (-1 and ⊥ where no element was taken), matched: [n] bool, taken:
// [P] int32 and n_relaxed: one int32.  k >= 0 and n_shards >= 1; the
// caller checks P against the shared memory.  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_relaxed_deletemin(const void* deq, const void* shard_of,
                                       const void* avail, const void* firsts,
                                       void* tier, void* pos, void* matched,
                                       void* taken, void* n_relaxed, int n,
                                       int P, int k, int n_shards,
                                       void* stream) {
  const int64_t smem = repro_relaxed_smem(P);
  cudaError_t err = cudaFuncSetAttribute(
      relaxed_deletemin, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  relaxed_deletemin<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(deq), static_cast<const int32_t*>(shard_of),
      static_cast<const int32_t*>(avail), static_cast<const int32_t*>(firsts),
      static_cast<int32_t*>(tier), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(matched), static_cast<int32_t*>(taken),
      static_cast<int32_t*>(n_relaxed), n, P, k, n_shards);
  return static_cast<int>(cudaGetLastError());
}
