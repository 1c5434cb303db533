// K5 — device-wide inclusive max-scan for Hopper (sm_90a), in one pass.
//
// Replaces no Pallas kernel.  The JAX package takes these running maxima
// with jax.lax.cummax (supernova_tpu/kmer/count.py, core/kmer_codec.py,
// align/pather.py), which XLA lowers itself.  The kernel was added because
// torch.cummax on a 1-D CUDA tensor is ATen's innermost-dim scan, which
// gives the tensor's one row one block: that block walked the count's
// 472.7M positions at ~3 ns an element, and wrote an int64 index array that
// no caller reads.
//
// Computes out[i] = max(x[0], ..., x[i]), x[j] = mask[j] ? v[j] : fill,
// where v is `values` (int32 or int64) or, without values, j itself
// (int64); without a mask every element takes part.
//
// Bound: device-memory traffic.  Each element's value is read once (none
// without values), its mask byte once, and its result written once: 17 B
// an int64 element with values and a mask, 9 B without values.
//
// Design: ONE launch; the wrapper zeroes 2 * ceil(n / kTile) + 1 int64
// words of scratch before it (a flag and a value word per tile, then the
// tile counter).  Each block
//   1. takes its tile number in block start order (lookback::take_tile), so
//      it only waits on tiles whose blocks already run;
//   2. scans its tile of kTile elements: warp w owns the tile's w-th stretch
//      of kStretch contiguous elements and walks it in rounds of 32 x V
//      elements (V = one 16-byte vector of values: 2 int64 or 4 int32).
//      Each lane loads its V values with one 16-byte load and their mask
//      bytes with one V-byte load (coalesced across the warp; every round's
//      loads are issued before any is used), takes their running maximum
//      in registers, then a warp-shuffle inclusive scan of the lanes'
//      maxima, carried from round to round.  Every element's in-warp
//      running maximum stays in registers;
//   3. one shared-memory pass over the warps' maxima gives each warp the
//      maximum before it, and the tile its aggregate;
//   4. warp 0 publishes the aggregate and finds the tile's exclusive prefix
//      by decoupled look-back, 32 tiles a step (lookback.cuh, max variant:
//      an exact int64 value word beside a flag word); lane 0 then
//      publishes the inclusive prefix;
//   5. every element is written as max(tile prefix, warp prefix, its
//      in-warp running maximum), with 16-byte stores.
// Elements past n are the identity (the type's minimum) and are not
// written.  A misaligned input (a view at an odd offset) and the ragged
// last stretch take element-wise loads and stores.  Offsets are 64-bit,
// so n may pass 2^31.  The kernel writes no index array.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // elements a thread holds
constexpr int kTile = kThreads * kItems;
constexpr int kStretch = 32 * kItems;  // a warp's contiguous elements
constexpr int kMinBlocks = 4;  // resident blocks a SM must fit (the register cap)

// launch modes (bits)
constexpr int kInt64 = 1;
constexpr int kHasValues = 2;
constexpr int kHasMask = 4;

template <typename T>
struct Lowest;
template <>
struct Lowest<long long> {
  static constexpr long long value = -9223372036854775807LL - 1;
};
template <>
struct Lowest<int> {
  static constexpr int value = -2147483647 - 1;
};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}

// V = 16 / sizeof(T) values at p (16-byte aligned) in one load.
__device__ __forceinline__ void load_vec(const long long* p, long long (&v)[2]) {
  const longlong2 q = *reinterpret_cast<const longlong2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load_vec(const int* p, int (&v)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void store_vec(long long* p, const long long* v) {
  *reinterpret_cast<longlong2*>(p) = make_longlong2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(int* p, const int* v) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// V mask bytes at p (V-byte aligned) in one load, byte k in bits 8k..8k+7.
template <int V>
__device__ __forceinline__ unsigned load_mask(const uint8_t* p) {
  if constexpr (V == 2) {
    return *reinterpret_cast<const unsigned short*>(p);
  } else {
    return *reinterpret_cast<const unsigned*>(p);
  }
}

template <typename T, bool kValues, bool kMask>
__device__ __forceinline__ void scan_tile(const T* __restrict__ values,
                                          const uint8_t* __restrict__ mask, T* __restrict__ out,
                                          long long n, T fill, bool vec_ok,
                                          unsigned long long* __restrict__ status,
                                          long long tile, long long* s_warp,
                                          long long* s_prefix) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int kRounds = kItems / V;
  constexpr T kLow = Lowest<T>::value;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long start = tile * kTile + static_cast<long long>(wid) * kStretch + lane * V;

  // 1. every round's loads, then x = mask ? value : fill (past n: the identity)
  T x[kItems];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long e0 = start + static_cast<long long>(r) * 32 * V;
    T v[V];
    unsigned m = ~0u;
    if (vec_ok && e0 + V <= n) {
      if constexpr (kValues) {
        load_vec(values + e0, v);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = static_cast<T>(e0 + k);
      }
      if constexpr (kMask) m = load_mask<V>(mask + e0);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const long long e = e0 + k;
        if constexpr (kValues) {
          v[k] = e < n ? values[e] : T(0);
        } else {
          v[k] = static_cast<T>(e);
        }
        if constexpr (kMask) {
          if (e >= n || mask[e] == 0) m &= ~(0xFFu << (8 * k));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool on = ((m >> (8 * k)) & 0xFFu) != 0u;
      x[r * V + k] = e0 + k < n ? (on ? v[k] : fill) : kLow;
    }
  }

  // 2. in-warp running maxima, round after round
  T carry = kLow;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    T* y = x + r * V;
#pragma unroll
    for (int k = 1; k < V; ++k) y[k] = tmax(y[k - 1], y[k]);
    T t = y[V - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = tmax(t, u);
    }
    T before = __shfl_up_sync(0xffffffffu, t, 1);
    if (lane == 0) before = kLow;
    const T total = __shfl_sync(0xffffffffu, t, 31);
    before = tmax(before, carry);
#pragma unroll
    for (int k = 0; k < V; ++k) y[k] = tmax(y[k], before);
    carry = tmax(carry, total);
  }

  // 3. the warps' maxima: each warp's prefix and the tile's aggregate
  if (lane == 0) s_warp[wid] = carry;
  __syncthreads();
  T wbefore = kLow, agg = kLow;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T s = static_cast<T>(s_warp[w]);
    if (w < wid) wbefore = tmax(wbefore, s);
    agg = tmax(agg, s);
  }

  // 4. decoupled look-back by warp 0
  if (wid == 0) {
    long long prefix = kLow;
    if (tile == 0) {
      if (lane == 0) lookback::maxscan::publish(status, 0, lookback::kPrefix, agg);
    } else {
      if (lane == 0) lookback::maxscan::publish(status, tile, lookback::kAggregate, agg);
      prefix = lookback::maxscan::exclusive_prefix_warp(status, tile, kLow);
      if (lane == 0)
        lookback::maxscan::publish(status, tile, lookback::kPrefix,
                                   tmax<long long>(prefix, agg));
    }
    if (lane == 0) *s_prefix = prefix;
  }
  __syncthreads();
  const T p = tmax(static_cast<T>(*s_prefix), wbefore);

  // 5. stores
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long e0 = start + static_cast<long long>(r) * 32 * V;
    T* y = x + r * V;
#pragma unroll
    for (int k = 0; k < V; ++k) y[k] = tmax(y[k], p);
    if (vec_ok && e0 + V <= n) {
      store_vec(out + e0, y);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (e0 + k < n) out[e0 + k] = y[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_max_kernel(const void* __restrict__ values, const uint8_t* __restrict__ mask,
                void* __restrict__ out, long long n, long long fill, int mode, int vec_ok,
                unsigned long long* __restrict__ status, unsigned* __restrict__ counter) {
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_prefix, s_tile;
  if (threadIdx.x == 0) s_tile = lookback::take_tile(counter);
  __syncthreads();
  const long long tile = s_tile;
  const bool vec = vec_ok != 0;
  using L = long long;
  const auto* v64 = static_cast<const L*>(values);
  const auto* v32 = static_cast<const int*>(values);
  auto* o64 = static_cast<L*>(out);
  auto* o32 = static_cast<int*>(out);
  const int f32 = static_cast<int>(fill);
  switch (mode) {
    case kInt64 | kHasValues | kHasMask:
      scan_tile<L, true, true>(v64, mask, o64, n, fill, vec, status, tile, s_warp, &s_prefix);
      break;
    case kInt64 | kHasValues:
      scan_tile<L, true, false>(v64, mask, o64, n, fill, vec, status, tile, s_warp, &s_prefix);
      break;
    case kInt64 | kHasMask:
      scan_tile<L, false, true>(v64, mask, o64, n, fill, vec, status, tile, s_warp, &s_prefix);
      break;
    case kInt64:
      scan_tile<L, false, false>(v64, mask, o64, n, fill, vec, status, tile, s_warp, &s_prefix);
      break;
    case kHasValues | kHasMask:
      scan_tile<int, true, true>(v32, mask, o32, n, f32, vec, status, tile, s_warp, &s_prefix);
      break;
    case kHasValues:
      scan_tile<int, true, false>(v32, mask, o32, n, f32, vec, status, tile, s_warp, &s_prefix);
      break;
    default:
      break;
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0u;
}

}  // namespace

// Elements per tile (one look-back flag and value word each).
extern "C" int sn_scan_max_tile_elems() { return kTile; }

// values: n elements of esize bytes (4 or 8), or null for each element's
// own index (esize 8); mask: n bytes (0 = the element takes `fill`), or
// null for none; out: n elements of esize bytes; fill: cast to the element
// type; scratch: scratch_words int64 words, at least 2 * ceil(n / tile) +
// 1, zeroed.
extern "C" int sn_scan_max(const void* values, const void* mask, void* out, long long n,
                           int esize, long long fill, void* scratch, long long scratch_words,
                           void* stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  if (n < 0 || (esize != 4 && esize != 8) || (values == nullptr && esize != 8) ||
      ntiles >= (1LL << 31) || scratch_words < 2 * ntiles + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ntiles == 0) return static_cast<int>(cudaGetLastError());
  const int mode = (esize == 8 ? kInt64 : 0) | (values != nullptr ? kHasValues : 0) |
                   (mask != nullptr ? kHasMask : 0);
  const unsigned per_vec = 16u / static_cast<unsigned>(esize);  // elements (mask bytes) a vector
  const int vec_ok = (values == nullptr || aligned(values, 16u)) && aligned(out, 16u) &&
                     (mask == nullptr || aligned(mask, per_vec));
  auto* status = static_cast<unsigned long long*>(scratch);
  scan_max_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      values, static_cast<const uint8_t*>(mask), out, n, fill, mode, vec_ok, status,
      reinterpret_cast<unsigned*>(status + 2 * ntiles));
  return static_cast<int>(cudaGetLastError());
}
