// The wave engine's Stage-4 store rewrite in one pass over the receive
// buffer: apply a wave's PUT rows, then its GET rows, and write the
// ok ‖ value reply.
//
// Replaces no TPU kernel: the reference's ring_commit
// (repro/dqueue/wave_engine.py:143) is plain jnp, fused by XLA.  The
// port's plain version (kernels/ring_commit/ref.py) runs a scatter, two
// index fills, two int64 gathers and a cat over every row of the dense
// receive buffer recv[n_dst, n_src, L, 2+W] (slot ‖ tag ‖ payload): at 64
// shards 4,194,304 rows for the 65,536 ops of a wave, 63 in 64 of them
// fill sentinels that all land on their shard's junk slot.
//
// What bounds it on an H100: bytes.  The receive rows read once and the
// reply [n_dst, n_src, L, 1+W] written once, (3 + 2W) * 4 bytes a row:
// 184.5 MB at 64 shards, W = 4, 0.055 ms at 3.35 TB/s.  On the pipelined
// path recv is a view of the exchanged request ‖ reply buffer, rows
// (3 + 2W) * 4 bytes apart of which the kernel reads the first 8 (the
// tag, then slot and payload of the rare active row), so DRAM serves the
// 32-byte sectors those 8 bytes touch: 8 in 11 of the wider buffer at
// W = 4.
//
// Design.  One thread-block cluster per destination shard (up to
// kMaxCluster blocks, as many as the launcher finds fill the card); block
// b of a cluster takes a contiguous chunk of the shard's n_src * L rows.
//  1. Each thread loads the tag of kUnroll rows at once (consecutive
//     threads on consecutive rows; scalar loads, since a row of the
//     pipelined view is only 4-byte aligned), applies a PUT row at once
//     (value words and full bit) and lists a GET row's (row, slot) in
//     shared memory; the block writes zeros over its chunk of the reply
//     with 16-byte stores.
//  2. Cluster barrier, release then acquire: every PUT of the shard has
//     landed before any GET reads.  Each listed GET reads its slot's full
//     bit and value from L2 (ld.global.cg: another SM of the cluster
//     wrote them, and L1 is not coherent) and writes its reply row: ok =
//     full && slot < junk, the value whatever the full bit says.
//  3. Cluster barrier: every GET has read before any full bit clears (the
//     plain version gathers, then clears).  The GET slots' full bits are
//     cleared; block 0 of the cluster clears the junk slot's.
// The junk slot is never written otherwise, so its full bit stays 0 and
// its values stay what they were.  A block with more than kListCap GET
// rows (the queues' waves send a shard about L GETs in all, over its
// whole cluster) rescans its chunk for GET rows in steps 2 and 3 instead
// of reading the list, so every input is applied in full.  Block 0 of
// the grid writes the commit-time overflow flag, always 0.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;         // rows a thread loads at once
constexpr int kListCap = 2048;     // GET rows a block lists (16 KB)
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int32_t kTagPut = 1;     // core/wave_tags.py's TAG_PUT
constexpr int32_t kTagGet = 2;     // core/wave_tags.py's TAG_GET

struct Recv {
  const int32_t* p;
  int64_t s0, s1, s2, s3;          // element strides of [n, n_src, L, C]
  int L;

  // the first word of row r = s * L + j of destination d
  __device__ __forceinline__ const int32_t* row(int d, int r) const {
    const int s = r / L;
    return p + d * s0 + s * s1 + (r - s * L) * s2;
  }
  __device__ __forceinline__ int32_t word(const int32_t* row,
                                          int c) const {
    return __ldg(row + c * s3);
  }
};

struct Shard {                     // destination d's store and reply
  int32_t* vals;                   // [junk + 1, W]
  uint8_t* full;                   // [junk + 1]
  int32_t* reply;                  // [n_src * L, 1 + W]
  int W, junk;

  __device__ __forceinline__ void put(const Recv& in,
                                      const int32_t* row) const {
    const int32_t slot = in.word(row, 0);
    if (slot < 0 || slot >= junk) return;          // the junk row eats
    int32_t* v = vals + static_cast<int64_t>(slot) * W;
    for (int c = 0; c < W; ++c) v[c] = in.word(row, 2 + c);
    full[slot] = 1;
  }
  // a GET row's reply: ok ‖ value of its slot, read past L1
  __device__ __forceinline__ void get(int r, int32_t slot) const {
    if (slot < 0 || slot > junk) return;           // the zeros stand
    int32_t* out = reply + static_cast<int64_t>(r) * (1 + W);
    const int32_t* v = vals + static_cast<int64_t>(slot) * W;
    out[0] = slot < junk && __ldcg(full + slot) != 0;
    for (int c = 0; c < W; ++c) out[1 + c] = __ldcg(v + c);
  }
  __device__ __forceinline__ void clear(int32_t slot) const {
    if (slot >= 0 && slot < junk) full[slot] = 0;  // remove on read
  }
};

// zeros over words [0, n) of p (4-byte aligned): 16-byte stores between a
// scalar head and tail
__device__ __forceinline__ void zero_words(int32_t* p, int64_t n) {
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  head = head < n ? head : n;
  if (threadIdx.x < head) p[threadIdx.x] = 0;
  int4* q = reinterpret_cast<int4*>(p + head);
  const int64_t n4 = (n - head) / 4;
  for (int64_t i = threadIdx.x; i < n4; i += kThreads)
    q[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = head + n4 * 4 + threadIdx.x; i < n; i += kThreads)
    p[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
ring_commit(Recv in, int32_t* __restrict__ vals, uint8_t* __restrict__ full,
            int32_t* __restrict__ reply, uint8_t* __restrict__ overflow,
            int rows, int W, int junk, int blocks) {
  __shared__ int2 list[kListCap];
  __shared__ int n_list;
  cg::cluster_group cluster = cg::this_cluster();
  const int d = blockIdx.x / blocks;
  const int b = blockIdx.x - d * blocks;
  const int chunk = (rows + blocks - 1) / blocks;
  const int lo = min(rows, b * chunk), hi = min(rows, lo + chunk);
  const int64_t slots = static_cast<int64_t>(junk) + 1;
  const Shard sh{vals + d * slots * W, full + d * slots,
                 reply + static_cast<int64_t>(d) * rows * (1 + W), W, junk};
  if (threadIdx.x == 0) n_list = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = 0;
  zero_words(sh.reply + static_cast<int64_t>(lo) * (1 + W),
             static_cast<int64_t>(hi - lo) * (1 + W));
  __syncthreads();                                 // n_list is 0
  for (int r0 = lo + threadIdx.x; r0 < hi; r0 += kThreads * kUnroll) {
    const int32_t* row[kUnroll];
    int32_t tag[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kThreads;
      row[u] = in.row(d, r < hi ? r : lo);
      tag[u] = r < hi ? in.word(row[u], 1) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (tag[u] == kTagPut) {
        sh.put(in, row[u]);
      } else if (tag[u] == kTagGet) {
        const int i = atomicAdd(&n_list, 1);
        if (i < kListCap)
          list[i] = make_int2(r0 + u * kThreads, in.word(row[u], 0));
      }
    }
  }
  cluster.sync();                    // the shard's PUTs before its GETs
  const int n = n_list;
  const bool listed = n <= kListCap;
  if (listed) {
    for (int i = threadIdx.x; i < n; i += kThreads)
      sh.get(list[i].x, list[i].y);
  } else {
    for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
      const int32_t* w = in.row(d, r);
      if (in.word(w, 1) == kTagGet) sh.get(r, in.word(w, 0));
    }
  }
  cluster.sync();                    // every GET read before a clear
  if (listed) {
    for (int i = threadIdx.x; i < n; i += kThreads) sh.clear(list[i].y);
  } else {
    for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
      const int32_t* w = in.row(d, r);
      if (in.word(w, 1) == kTagGet) sh.clear(in.word(w, 0));
    }
  }
  if (b == 0 && threadIdx.x == 0) sh.full[junk] = 0;
}

}  // namespace

// recv: int32 with element strides s0..s3 of [n_dst, n_src, L, 2+W];
// vals [n_dst, junk+1, W] int32 and full [n_dst, junk+1] bool, contiguous,
// updated in place; reply [n_dst, n_src, L, 1+W] int32 and overflow (one
// bool), both written here.  blocks: a destination's cluster, in [1,
// kMaxCluster].  Returns the launch's error code.
extern "C" int repro_ring_commit(const void* recv, int64_t s0, int64_t s1,
                                 int64_t s2, int64_t s3, void* vals,
                                 void* full, void* reply, void* overflow,
                                 int n_dst, int n_src, int L, int W,
                                 int junk, int blocks, void* stream) {
  if (n_dst <= 0) return 0;
  if (blocks < 1 || blocks > kMaxCluster) return cudaErrorInvalidValue;
  const Recv in{static_cast<const int32_t*>(recv), s0, s1, s2, s3, L};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(n_dst * blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ring_commit, in, static_cast<int32_t*>(vals),
      static_cast<uint8_t*>(full), static_cast<int32_t*>(reply),
      static_cast<uint8_t*>(overflow), n_src * L, W, junk, blocks);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
