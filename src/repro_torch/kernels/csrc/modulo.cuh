// x mod n without a division: a reciprocal of n taken once a launch.
//
// m = floor((2^32 - 1) / n).  For any uint32 x, q = umulhi(x, m) is
// floor(x / n) or one less: x·m / 2^32 <= x / n, and the gap is x·(2^32 -
// n·m) / (n·2^32) < x / 2^32 < 1, since n·m >= 2^32 - n.  So r = x - q·n
// lies in [0, 2n) and one compare and subtract makes it exact, for every n
// >= 1 (n = 1 gives m = 2^32 - 1, r <= 1).  Shared by relaxed.cu (head
// owners, the floor modulo of an int32 head as jnp.mod) and hash_route.cu
// ((h >> 8) % n_shards); ref.py of each holds the same arithmetic against
// Python's % on the CPU.
#pragma once

#include <cstdint>

namespace repro {

struct FastMod {
  uint32_t n, m;                 // m = 0xffffffff / n, from modulo_recip

  __device__ __forceinline__ uint32_t of(uint32_t x) const {
    const uint32_t r = x - __umulhi(x, m) * n;
    return r >= n ? r - n : r;
  }
  // floor modulo of a signed head, in [0, n) for a negative one too:
  // h < 0 gives n - 1 - ((-h - 1) mod n), and -h - 1 fits int32
  __device__ __forceinline__ int floor_of(int32_t h) const {
    return h >= 0 ? static_cast<int>(of(static_cast<uint32_t>(h)))
                  : static_cast<int>(n - 1 - of(static_cast<uint32_t>(
                        -(h + 1))));
  }
};

inline uint32_t modulo_recip(uint32_t n) { return 0xffffffffu / n; }

}  // namespace repro
