// Consistent-hash owner and per-shard histogram of a batch of positions.
//
// Replaces repro/kernels/hash_route/kernel.py:hash_route_kernel (Pallas,
// body _route_kernel with the _mix32 splitmix finalizer, a one-hot matmul
// histogram accumulated across a sequential grid).  Here each element is
// handled by one thread (a grid-stride loop over a grid capped at a few
// blocks per SM), the hash is uint32 arithmetic, and the owner is
// (h >> 8) % n_shards, or -1 where the element is invalid.
//
// What bounds it on an H100: memory.  Each element reads 5 bytes (int32
// position, bool valid) and writes 4 (int32 owner): 9 B/element, so 16 M
// elements move 151 MB, 45 us at 3.35 TB/s.  The histogram would bound it
// instead if every element did a global atomic; so each block counts into
// a shared-memory histogram with atomicAdd and adds it to the global one
// (zeroed by the wrapper) once at its end.  Integer atomics make the
// counts exact whatever order they land in.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kThreads)
hash_route(const int32_t* __restrict__ pos, const uint8_t* __restrict__ valid,
           int32_t* __restrict__ owner, int32_t* __restrict__ counts,
           int64_t n, int n_shards) {
  extern __shared__ int32_t hist[];
  for (int j = threadIdx.x; j < n_shards; j += kThreads) hist[j] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    int32_t o = -1;
    if (valid[i]) {
      const uint32_t h = mix32(static_cast<uint32_t>(pos[i]));
      o = static_cast<int32_t>((h >> 8) % static_cast<uint32_t>(n_shards));
      atomicAdd(&hist[o], 1);
    }
    owner[i] = o;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_shards; j += kThreads)
    if (hist[j]) atomicAdd(&counts[j], hist[j]);
}

}  // namespace

// owner: [n] int32 output; counts: [n_shards] int32, zeroed by the caller
// and accumulated here.  max_blocks caps the grid (the wrapper passes a few
// blocks per SM).  Returns cudaGetLastError() after the launch.
extern "C" int repro_hash_route(const void* pos, const void* valid,
                                void* owner, void* counts, int n,
                                int n_shards, int max_blocks, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  hash_route<<<blocks, kThreads, n_shards * sizeof(int32_t),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(owner), static_cast<int32_t*>(counts), n,
      n_shards);
  return static_cast<int>(cudaGetLastError());
}
