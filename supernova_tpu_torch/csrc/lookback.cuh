// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016) for a one-pass scan of tiles.
//
// Each tile publishes a 64-bit status word per scanned value: first its
// own AGGREGATE, then, once it knows everything before it, its inclusive
// PREFIX.  A tile's exclusive prefix is the sum of the aggregates of the
// tiles before it, walking back until one that has published a prefix.
// Tiles are numbered in the order their blocks start (take_tile), so a tile
// only ever waits on tiles whose blocks already run: no deadlock, whatever
// order the hardware schedules blocks in.
//
// Status word: tag (6 bits, 1..63) << 58 | flag (2 bits) << 56 | value (56
// bits).  A word whose tag is not the current pass's is not yet written,
// so one status array serves several passes after a single zeroing.  The
// value and its flag travel in one aligned 64-bit store, so a reader needs
// no fence: it sees the whole word or the old one.

#pragma once

#include <cstdint>

namespace lookback {

constexpr unsigned long long kAggregate = 1ull;
constexpr unsigned long long kPrefix = 2ull;
constexpr unsigned long long kValueMask = (1ull << 56) - 1ull;
constexpr int kMaxTag = 63;

__device__ __forceinline__ void publish(unsigned long long* word, unsigned tag,
                                        unsigned long long flag, unsigned long long value) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 58) | (flag << 56) | (value & kValueMask);
  *reinterpret_cast<volatile unsigned long long*>(word) = w;
}

// Exclusive prefix of `tile` (>= 1): the sum of the values of tiles
// tile-1, tile-2, ... down to the first that published a PREFIX.  The word
// of tile j is status[j * stride].
__device__ __forceinline__ unsigned long long exclusive_prefix(
    const unsigned long long* status, long long tile, long long stride, unsigned tag) {
  unsigned long long sum = 0;
  for (long long j = tile - 1; j >= 0; --j) {
    const volatile unsigned long long* p =
        reinterpret_cast<const volatile unsigned long long*>(status + j * stride);
    unsigned long long w;
    do {
      w = *p;
    } while (static_cast<unsigned>(w >> 58) != tag || ((w >> 56) & 3ull) == 0ull);
    sum += w & kValueMask;
    if (((w >> 56) & 3ull) == kPrefix) break;
  }
  return sum;
}

// The next tile number of this pass, in block start order (call from one
// thread; broadcast through shared memory).
__device__ __forceinline__ long long take_tile(unsigned* counter) {
  return static_cast<long long>(atomicAdd(counter, 1u));
}

}  // namespace lookback
