// Consistent-hash owner and per-shard histogram of a batch of positions.
//
// Replaces repro/kernels/hash_route/kernel.py:hash_route_kernel (Pallas,
// body _route_kernel with the _mix32 splitmix finalizer, a one-hot matmul
// histogram accumulated across a sequential grid).  Here each thread takes
// four elements at a time (16-byte position and 4-byte flag loads where
// the pointers allow, kUnroll groups loaded before any is routed) in a
// grid-stride loop, the hash is uint32 arithmetic, and the owner is
// (h >> 8) % n_shards by a reciprocal taken once a launch (modulo.cuh), or
// -1 where the element is invalid.
//
// One launch a call, no zero-fill and no state between calls: the grid is
// one thread-block cluster.  Each block counts into a shared-memory
// histogram (integer atomics: exact whatever order they land in), zeroed
// before a cluster barrier; then every block but 0 adds its nonzero
// counts into block 0's histogram through distributed shared memory, and
// after a second barrier block 0 writes the counts.  A grid of one block
// is launched without a cluster (its implicit cluster is that block).  So
// the kernel can be captured in a CUDA graph and replayed on any stream.
//
// What bounds it on an H100: at the migrations' sizes (at most 65,536
// positions, 16 blocks of 4,096) one launch's floor.  Each element reads
// 5 bytes (int32 position, bool valid) and writes 4 (int32 owner); a
// cluster holds at most 16 SMs, so at 16 M elements (151 MB, 45 us at
// 3.35 TB/s) what 16 SMs can load and count binds instead.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "modulo.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kVec = 4;                    // elements a thread a group
constexpr int kUnroll = 4;                 // groups a thread loads at once
constexpr int kMaxCluster = 16;            // H100's non-portable limit

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int32_t route(int32_t p, bool v, int32_t* hist,
                                         const repro::FastMod& mod) {
  if (!v) return -1;
  const int32_t o = static_cast<int32_t>(
      mod.of(mix32(static_cast<uint32_t>(p)) >> 8));
  atomicAdd(&hist[o], 1);
  return o;
}

__device__ __forceinline__ int4 route4(int4 p, uint32_t v, int32_t* hist,
                                       const repro::FastMod& mod) {
  return make_int4(route(p.x, v & 0xffu, hist, mod),
                   route(p.y, (v >> 8) & 0xffu, hist, mod),
                   route(p.z, (v >> 16) & 0xffu, hist, mod),
                   route(p.w, v >> 24, hist, mod));
}

__global__ void __launch_bounds__(kThreads, 1)
hash_route(const int32_t* __restrict__ pos, const uint8_t* __restrict__ valid,
           int32_t* __restrict__ owner, int32_t* __restrict__ counts,
           int n, int n_shards, uint32_t recip) {
  extern __shared__ int32_t hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  for (int j = tid; j < n_shards; j += kThreads) hist[j] = 0;
  cluster.sync();                          // block 0's zeros before adds
  const repro::FastMod mod{static_cast<uint32_t>(n_shards), recip};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const bool vec = (reinterpret_cast<uintptr_t>(pos) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(owner) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
  const int64_t groups = vec ? n / kVec : 0;
  const int4* pos4 = reinterpret_cast<const int4*>(pos);
  const uint32_t* valid4 = reinterpret_cast<const uint32_t*>(valid);
  int4* owner4 = reinterpret_cast<int4*>(owner);
  for (; g + (kUnroll - 1) * stride < groups; g += kUnroll * stride) {
    int4 p[kUnroll];
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = pos4[g + u * stride];
      v[u] = valid4[g + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      owner4[g + u * stride] = route4(p[u], v[u], hist, mod);
  }
  for (; g < groups; g += stride) owner4[g] = route4(pos4[g], valid4[g],
                                                     hist, mod);
  for (int64_t i = groups * kVec + static_cast<int64_t>(blockIdx.x) *
                   kThreads + tid; i < n; i += stride)
    owner[i] = route(pos[i], valid[i], hist, mod);
  __syncthreads();
  if (cluster.block_rank() != 0) {
    int32_t* to = cluster.map_shared_rank(hist, 0);
    for (int j = tid; j < n_shards; j += kThreads)
      if (hist[j]) atomicAdd(&to[j], hist[j]);
  }
  cluster.sync();                          // every block's adds landed
  if (cluster.block_rank() == 0)
    for (int j = tid; j < n_shards; j += kThreads) counts[j] = hist[j];
}

}  // namespace

// Allows the launches' clusters above the portable 8: an H100 schedules
// kMaxCluster blocks of kThreads in one cluster.  Once a device, before
// the first launch; returns the error code.
extern "C" int repro_hash_route_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      hash_route, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

// owner: [n] int32 and counts: [n_shards] int32, both written here (no
// zeroing).  blocks: the grid, one cluster when above 1, in [1,
// kMaxCluster].  Returns the launch's error code.
extern "C" int repro_hash_route(const void* pos, const void* valid,
                                void* owner, void* counts, int n,
                                int n_shards, int blocks, void* stream) {
  if (n <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(n_shards) * sizeof(int32_t);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, hash_route, static_cast<const int32_t*>(pos),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(owner),
      static_cast<int32_t*>(counts), n, n_shards,
      repro::modulo_recip(static_cast<uint32_t>(n_shards)));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
