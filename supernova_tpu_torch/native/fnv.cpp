// 64-bit FNV-1a over a byte string, continuing from hash h: the inner loop
// of BaseGraph.checksum (dbg/graph.py), which Python runs at ~0.7 us a byte.
#include <cstdint>

extern "C" uint64_t fnv1a_64(const uint8_t* data, int64_t n, uint64_t h) {
  for (int64_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= 0x100000001B3ULL;
  }
  return h;
}
