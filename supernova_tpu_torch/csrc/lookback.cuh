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

// ---- Max variant: a running maximum of exact int64 values (K5).
//
// A maximum needs every bit of an int64, so the flag cannot share the
// value's word.  Tile j owns two words: status[2j] its flag (0 = not yet
// written, kAggregate, kPrefix) and status[2j + 1] its value.  The value is
// stored first and the flag after it with release semantics; a reader
// loads the flag with acquire semantics and then the value.  A tile
// overwrites its aggregate with its inclusive prefix before it raises its
// flag to kPrefix, so a reader that saw kAggregate may read the prefix
// instead: harmless, because the prefix is the maximum of that tile and
// every tile before it, and max is idempotent.  The scratch is zeroed
// before every launch (no tag).
namespace lookback::maxscan {

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return static_cast<long long>(v);
}

// Publish `value` under `flag` for tile `tile` (one thread).
__device__ __forceinline__ void publish(unsigned long long* status, long long tile,
                                       unsigned long long flag, long long value) {
  unsigned long long* w = status + 2 * tile;
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(w + 1),
               "l"(static_cast<unsigned long long>(value)) : "memory");
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(w), "l"(flag) : "memory");
}

// Exclusive prefix of `tile` (>= 1): the maximum of the values of tiles
// tile-1, tile-2, ... down to the first that published a PREFIX, read 32
// tiles a step by one whole warp (lane i reads the i-th tile back).  Every
// lane returns the result; `ident` is the maximum's identity.
__device__ __forceinline__ long long exclusive_prefix_warp(const unsigned long long* status,
                                                           long long tile, long long ident) {
  const int lane = threadIdx.x & 31;
  long long acc = ident;
  for (long long hi = tile - 1;; hi -= 32) {
    const long long j = hi - lane;
    unsigned long long flag = kPrefix;  // before tile 0: nothing, as a prefix
    long long v = ident;
    if (j >= 0) {
      do {
        flag = load_acquire(status + 2 * j);
      } while (flag == 0ull);
      v = load_relaxed(status + 2 * j + 1);
    }
    const unsigned pre = __ballot_sync(0xffffffffu, flag == kPrefix);
    // lanes up to the nearest prefix take part
    const int last = pre ? __ffs(pre) - 1 : 31;
    long long x = lane <= last ? v : ident;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long y = __shfl_xor_sync(0xffffffffu, x, o);
      x = y > x ? y : x;
    }
    acc = x > acc ? x : acc;
    if (pre) return acc;
  }
}

}  // namespace lookback::maxscan
