// K4 — stable multi-key onesweep radix argsort for Hopper (sm_90a).
//
// Replaces: supernova_tpu/ops/pallas/sort.py, sort_bitonic_pallas (bodies
// _tile_sort_kernel, _local_merge_kernel, _cross_kernel): an ascending
// lexicographic sort of 32-bit operands by the first num_keys of them.
// Here it is an argsort: the permutation that sorts rows by 1..6 keys
// (first key most significant), STABLE, so ties keep their input order and
// the permutation is unique.  The wrapper (ops/kernels/sort.py) gathers
// payloads by it.  Each key is an int64 column holding a value in
// [0, 2^32); only its low 32 bits are read.
//
// Bound: device-memory traffic.  The function must read every key once
// (8 B a row a key) and write the int64 permutation (8 B a row).  Integer
// work only: the tensor cores have no role in a sort.  An LSD radix sort
// moves more, and this design's own floor is, per row: one read of every
// key for the histograms (8 B a key), 16 B a live 8-bit digit pass (32-bit
// key and 32-bit row index, read and written), and for every key after the
// first a gather of key[idx] in its first pass (a random 8 B read that
// costs a 32 B sector).
//
// Design.  The TPU kernel is a bitonic network: O(n log^2 n) compare-
// exchanges in VMEM tiles, padded to a power of two, unstable.  On Hopper a
// radix sort does O(n) work per digit and is stable by construction:
//   * ONE histogram launch (hist_kernel) reads every key once and counts the
//     256 values of each of its four 8-bit digits; a row's digit does not
//     depend on the order, so no pass needs a count of its own.  The wrapper
//     reads the histograms back in one copy (the sort's one host
//     synchronisation), skips every digit that puts all n rows in one bin,
//     and plans one pass per live digit, keys from the last to the first;
//   * ONE launch per live digit (onesweep_kernel, Adinets & Merrill,
//     "Onesweep", 2022).  A block takes its tile number from an atomic
//     counter, ranks its 6144 rows stably by position — lanes by peer masks
//     (an atomic OR of lane bits into a warp-private mask per digit) and
//     lane order, rounds by warp-private shared counters, warps by a
//     shared-memory prefix — publishes its per-digit counts, writes the tile digit-sorted
//     into shared memory, finds each digit's global offset by decoupled
//     look-back over the preceding tiles (lookback.cuh) plus the digit's
//     exclusive histogram prefix, and copies each digit's run out, so
//     neighbouring threads store to neighbouring addresses;
//   * a key's first pass reads it straight from the int64 column: the
//     sort's first pass at row i (the index is the identity), a later key's
//     first pass at key[idx[i]] (the gather fused into the pass); the key's
//     last pass writes no key, and the sort's last pass writes the int64
//     permutation instead of the 32-bit index;
//   * row indices are 32-bit inside (n < 2^31); status words are 64-bit.
// Digits stay 8 bits wide.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
// Rows a thread ranks, and the blocks a SM must hold (the register cap):
// 24 and 2 measured fastest on an H100 among 16-32 rows at 1-3 blocks.
constexpr int kItems = 24;
constexpr int kMinBlocks = 2;
constexpr int kTile = kThreads * kItems;  // rows per tile of a pass
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kItems * 32;  // rows of a tile one warp ranks
constexpr int kRadix = 256;             // == kThreads: thread t owns digit t
constexpr int kDigits = 4;              // 8-bit digits of a 32-bit key
constexpr int kMaxKeys = 6;
constexpr int kHistRows = 4;  // rows a histogram thread loads per step

// Where a pass reads its keys: the staged 32-bit keys of the previous pass,
// the int64 column in row order (the sort's first pass), or the int64
// column at the previous pass's row indices (a later key's first pass).
enum Src { kStaged = 0, kColumn = 1, kGather = 2 };

struct Keys {
  const long long* key[kMaxKeys];
};

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// hist[blockIdx.y][d][v] += rows of key blockIdx.y whose digit d is v.  A
// thread counts a digit value that repeats in its rows before it adds it,
// so constant digits (sentinels, a key's unused high bits) cost no
// contended atomics.
__global__ void __launch_bounds__(kThreads)
hist_kernel(Keys keys, long long n, unsigned* __restrict__ hist) {
  __shared__ unsigned s[kDigits * kRadix];
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kThreads) s[i] = 0;
  __syncthreads();
  const long long* __restrict__ key = keys.key[blockIdx.y];
  unsigned cur[kDigits], cnt[kDigits];
#pragma unroll
  for (int d = 0; d < kDigits; ++d) cur[d] = cnt[d] = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i0 < n;
       i0 += stride * kHistRows) {
    unsigned k[kHistRows];
#pragma unroll
    for (int r = 0; r < kHistRows; ++r) {
      const long long i = i0 + r * stride;
      k[r] = i < n ? static_cast<unsigned>(key[i]) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kHistRows; ++r) {
      if (i0 + r * stride >= n) break;
#pragma unroll
      for (int d = 0; d < kDigits; ++d) {
        const unsigned v = (k[r] >> (8 * d)) & 0xFFu;
        if (cnt[d] && v != cur[d]) {
          atomicAdd(&s[d * kRadix + cur[d]], cnt[d]);
          cnt[d] = 0;
        }
        cur[d] = v;
        ++cnt[d];
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kDigits; ++d)
    if (cnt[d]) atomicAdd(&s[d * kRadix + cur[d]], cnt[d]);
  __syncthreads();
  unsigned* out = hist + static_cast<long long>(blockIdx.y) * kDigits * kRadix;
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kThreads)
    if (s[i]) atomicAdd(&out[i], s[i]);
}

// Exclusive scan of one value per thread over the 256-thread block.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* s_warp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  unsigned pre = 0;
  for (int w = 0; w < wid; ++w) pre += s_warp[w];
  __syncthreads();  // s_warp is reused by the next call
  return pre + x - v;
}

// One stable pass by the 8-bit digit at `shift`.  Warp w owns the tile's
// rows [w * kWarpRows, (w + 1) * kWarpRows), 32 a round in row order, held
// in registers, so the tile's row order is (warp, round, lane).
//   1. rank: per round, the lanes of one digit (found by an atomic OR of
//      their lane bits into a warp-private mask per digit) take the warp's
//      running count of that digit plus their rank among the lower lanes;
//      the group's first lane advances the count;
//   2. thread t (digit t) turns the per-warp counts into each warp's start
//      inside the tile's run of digit t, publishes the tile's count of t
//      (an aggregate, or tile 0's prefix), and scans the tile's counts and
//      the digit's histogram over the digits;
//   3. every row goes to shared memory at its tile-local position
//      (digit-sorted);
//   4. thread t looks back over the preceding tiles for digit t's
//      exclusive prefix, publishes its own inclusive prefix, and sets the
//      run's global start (histogram prefix + look-back prefix);
//   5. the tile is copied out in shared order: row j of the sorted tile to
//      its run's global start + its offset in the run.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
onesweep_kernel(int src, int write_keys, int write_perm, const unsigned* __restrict__ kv_in,
                const unsigned* __restrict__ idx_in, const long long* __restrict__ column,
                long long n, int shift, const unsigned* __restrict__ bins,
                unsigned* __restrict__ counter, unsigned long long* __restrict__ status,
                unsigned tag, unsigned* __restrict__ kv_out, unsigned* __restrict__ idx_out,
                long long* __restrict__ perm_out) {
  extern __shared__ unsigned s_sorted[];  // the tile digit-sorted: keys, then indices
  unsigned* s_key = s_sorted;
  unsigned* s_idx = s_sorted + kTile;
  __shared__ unsigned s_cnt[kWarps][kRadix];    // per-warp digit counts, then starts
  __shared__ unsigned s_match[kWarps][kRadix];  // per-warp lanes holding each digit
  __shared__ unsigned s_global[kRadix];       // global start of each digit's run - local start
  __shared__ unsigned s_scan[kWarps];
  __shared__ long long s_tile;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned below = lanes_below(lane);

  if (tid == 0) s_tile = lookback::take_tile(counter);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_cnt[w][tid] = s_match[w][tid] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;
  const long long wbase = base + static_cast<long long>(wid) * kWarpRows;

  unsigned k[kItems], x[kItems], rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = wbase + r * 32 + lane;
    const bool v = i < n;
    if (src == kStaged) {
      k[r] = v ? kv_in[i] : 0u;
      x[r] = v ? idx_in[i] : 0u;
    } else if (src == kColumn) {
      k[r] = v ? static_cast<unsigned>(column[i]) : 0u;
      x[r] = static_cast<unsigned>(i);
    } else {
      x[r] = v ? idx_in[i] : 0u;
    }
  }
  if (src == kGather) {
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      k[r] = wbase + r * 32 + lane < n ? static_cast<unsigned>(column[x[r]]) : 0u;
  }

  // 1. rank inside the warp: the lanes holding a digit OR their bits into
  // the warp's mask of that digit, read it back as their peer group, and
  // the group's first lane advances the warp's count of the digit and
  // clears the mask
  unsigned* match = s_match[wid];
  unsigned* cnt = s_cnt[wid];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool v = wbase + r * 32 + lane < n;
    const unsigned digit = (k[r] >> shift) & 0xFFu;
    if (v) atomicOr(&match[digit], 1u << lane);
    __syncwarp();
    const unsigned peers = v ? match[digit] : 0u;
    const unsigned before = v ? cnt[digit] : 0u;
    const unsigned lower = peers & below;
    __syncwarp();  // every lane has read its group's mask and count
    if (v && lower == 0) {
      cnt[digit] = before + __popc(peers);
      match[digit] = 0u;
    }
    __syncwarp();
    rank[r] = before + __popc(lower);
  }
  __syncthreads();

  // 2. per digit: warp starts, the tile's count (published), tile-local start
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_cnt[w][tid];
    s_cnt[w][tid] = count;
    count += c;
  }
  unsigned long long* mine = status + tile * kRadix + tid;
  lookback::publish(mine, tag, tile == 0 ? lookback::kPrefix : lookback::kAggregate, count);
  const unsigned local = block_exclusive_scan(count, s_scan);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_cnt[w][tid] += local;
  const unsigned bin_base = block_exclusive_scan(bins[tid], s_scan);

  // 3. the tile, digit-sorted, into shared memory
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (wbase + r * 32 + lane < n) {
      const unsigned pos = s_cnt[wid][(k[r] >> shift) & 0xFFu] + rank[r];
      s_key[pos] = k[r];
      s_idx[pos] = x[r];
    }
  }

  // 4. look back for digit tid's offset among the earlier tiles
  unsigned long long prefix = 0;
  if (tile > 0) {
    prefix = lookback::exclusive_prefix(status + tid, tile, kRadix, tag);
    lookback::publish(mine, tag, lookback::kPrefix, prefix + count);
  }
  s_global[tid] = bin_base + static_cast<unsigned>(prefix) - local;
  __syncthreads();

  // 5. copy each digit's run to its global offset
  const long long left = n - base;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = tid; j < tile_n; j += kThreads) {
    const unsigned kj = s_key[j];
    const unsigned g = s_global[(kj >> shift) & 0xFFu] + static_cast<unsigned>(j);
    if (write_keys) kv_out[g] = kj;
    if (write_perm) {
      perm_out[g] = static_cast<long long>(s_idx[j]);
    } else {
      idx_out[g] = s_idx[j];
    }
  }
}

}  // namespace

// Rows per tile of a onesweep pass.
extern "C" int sn_radix_tile_rows() { return kTile; }

// hist[k][d][v] (int32, nkeys x 4 x 256) = rows of key k whose 8-bit digit
// d is v.  key_ptrs: host array of nkeys device pointers to int64 columns.
extern "C" int sn_radix_hist(const void* key_ptrs, int nkeys, long long n, void* hist,
                             void* stream) {
  if (nkeys < 1 || nkeys > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  Keys keys;
  const auto* p = static_cast<const unsigned long long*>(key_ptrs);
  for (int j = 0; j < kMaxKeys; ++j)
    keys.key[j] = j < nkeys ? reinterpret_cast<const long long*>(p[j]) : nullptr;
  cudaMemsetAsync(hist, 0, sizeof(unsigned) * nkeys * kDigits * kRadix, s);
  if (n > 0) {
    const long long want = (n + kThreads * 16LL - 1) / (kThreads * 16LL);
    const unsigned bx = static_cast<unsigned>(want < 264 ? want : 264);
    hist_kernel<<<dim3(bx, nkeys), kThreads, 0, s>>>(keys, n, static_cast<unsigned*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

// One stable onesweep pass by the 8-bit digit at `shift`.
//   src: 0 read (kv_in, idx_in); 1 read column[i], index i; 2 read
//        idx_in[i] and column[idx_in[i]];
//   write_keys: also write the 32-bit keys to kv_out;
//   write_perm: write the indices widened to int64 into perm_out instead
//               of idx_out.
// bins: the 256 histogram bins of this key's digit; counter: one zeroed
// uint32; status: status_words uint64 words, at least
// 256 * ceil(n / sn_radix_tile_rows()),
// zeroed before the sort's first pass; tag: this pass's number in the
// sort, 1..63.
extern "C" int sn_radix_onesweep(int src, int write_keys, int write_perm, const void* kv_in,
                                 const void* idx_in, const void* column, long long n, int shift,
                                 const void* bins, void* counter, void* status,
                                 long long status_words, int tag, void* kv_out, void* idx_out,
                                 void* perm_out, void* stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  if (src < kStaged || src > kGather || tag < 1 || tag > lookback::kMaxTag ||
      status_words < ntiles * kRadix)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kSorted = 2 * kTile * sizeof(unsigned);
  const int err = static_cast<int>(cudaFuncSetAttribute(
      onesweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSorted));
  if (err) return err;
  onesweep_kernel<<<static_cast<unsigned>(ntiles), kThreads, kSorted,
                    static_cast<cudaStream_t>(stream)>>>(
      src, write_keys, write_perm, static_cast<const unsigned*>(kv_in),
      static_cast<const unsigned*>(idx_in), static_cast<const long long*>(column), n, shift,
      static_cast<const unsigned*>(bins), static_cast<unsigned*>(counter),
      static_cast<unsigned long long*>(status), static_cast<unsigned>(tag),
      static_cast<unsigned*>(kv_out), static_cast<unsigned*>(idx_out),
      static_cast<long long*>(perm_out));
  return static_cast<int>(cudaGetLastError());
}
