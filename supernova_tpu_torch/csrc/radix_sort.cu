// K4 — stable multi-key LSD radix argsort for Hopper (sm_90a).
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
// (8 B a row a key) and write the int64 permutation (8 B a row).  An LSD
// radix sort moves more: per 8-bit digit pass it reads the staged 32-bit
// digit source twice (count, then scatter) and the 32-bit row index once,
// and writes both again: 20 B a row a pass, up to 4 passes a key, plus one
// gather per key (4 B index read, a random 8 B key read that costs a 32 B
// sector, 4 B written) and one read of every key to find its live digits.
//
// Design.  The TPU kernel is a bitonic network: O(n log^2 n) compare-
// exchanges in VMEM tiles, padded to a power of two, unstable.  On Hopper a
// radix sort does O(n) work per digit and is stable by construction:
//   * keys are processed from the last to the first; per key, the 32-bit
//     values are staged contiguously ONCE, gathered by the current
//     permutation (sn_radix_gather), and every 8-bit digit pass then reads
//     them sequentially;
//   * one pass (sn_radix_pass) = three launches: a per-tile digit count
//     (4096-row tiles), an exclusive scan of the counts over (digit, tile)
//     (one block per digit), and a scatter.  Stability inside a tile is
//     where an LSD sort goes wrong (shared-memory atomics rank equal
//     digits in an arbitrary order), so the scatter ranks by position,
//     never by atomics: lanes by peer masks built from eight warp ballots
//     (one per digit bit) and their lane order, rounds and warps by
//     shared-memory prefix counts, as csrc/compact.cu ranks its kept rows.
//     It writes the tile digit-sorted into shared memory, then copies each
//     digit's run to its global offset, so neighbouring threads store to
//     neighbouring addresses.  (The per-tile count may use atomics: a
//     count does not depend on order.);
//   * a pass whose digit puts all n rows in one bucket leaves the order as
//     it is and is skipped: sn_radix_bits reduces every key to the AND and
//     the OR of its rows up front (a digit is constant iff its bits agree
//     in both), and the wrapper reads them with one device-to-host copy per
//     sort;
//   * row indices are 32-bit inside (n < 2^31) and widened to the int64
//     permutation at the end (sn_radix_perm).
// Onesweep (one pass per digit with decoupled look-back), wider digits and
// TMA staging are left to a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // rows per tile of a pass
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kItems * 32;  // rows of a tile one warp ranks
constexpr int kRadix = 256;  // == kThreads: thread t owns digit t
constexpr int kScanThreads = 1024;

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// and_or[0] &= every row's low 32 bits, and_or[1] |= them (warp
// reductions, then one atomic per warp).
__global__ void __launch_bounds__(kThreads)
bits_kernel(const long long* __restrict__ key, long long n, unsigned* __restrict__ and_or) {
  unsigned a = 0xFFFFFFFFu, o = 0u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const unsigned k = static_cast<unsigned>(key[i]);
    a &= k;
    o |= k;
  }
  a = __reduce_and_sync(0xffffffffu, a);
  o = __reduce_or_sync(0xffffffffu, o);
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(&and_or[0], a);
    atomicOr(&and_or[1], o);
  }
}

// For a valid lane: the mask of the valid lanes of its warp whose digit
// equals its own (eight ballots, one per digit bit).
__device__ __forceinline__ unsigned digit_peers(unsigned digit, bool valid) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (digit >> b) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// Stage one key's 32-bit values in permutation order.  init: the first key
// processed, idx becomes the identity.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const long long* __restrict__ key, unsigned* __restrict__ idx, long long n,
              int init, unsigned* __restrict__ kv) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  if (init) {
    idx[i] = static_cast<unsigned>(i);
    kv[i] = static_cast<unsigned>(key[i]);
  } else {
    kv[i] = static_cast<unsigned>(key[idx[i]]);
  }
}

// Per-tile digit counts, digit-major: counts[digit * ntiles + tile].
__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const unsigned* __restrict__ kv, long long n, int shift,
                  unsigned* __restrict__ counts, long long ntiles) {
  __shared__ unsigned s[kRadix];
  s[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&s[(kv[i] >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  counts[threadIdx.x * ntiles + blockIdx.x] = s[threadIdx.x];
}

// One block per digit: exclusive scan of that digit's per-tile counts
// (offsets) and the digit's total.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const unsigned* __restrict__ counts, long long ntiles,
            unsigned* __restrict__ offsets, unsigned* __restrict__ totals) {
  __shared__ unsigned warp_sum[kScanThreads / 32];
  __shared__ unsigned carry;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned* row = counts + blockIdx.x * ntiles;
  unsigned* out = offsets + blockIdx.x * ntiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < ntiles; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const unsigned v = i < ntiles ? row[i] : 0u;
    unsigned x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[wid] = x;
    __syncthreads();
    if (wid == 0) {  // inclusive scan of the 32 warp sums
      unsigned s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    const unsigned excl = carry + (wid > 0 ? warp_sum[wid - 1] : 0u) + x - v;
    if (i < ntiles) out[i] = excl;
    __syncthreads();  // every thread has read carry and warp_sum
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
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

// Stable scatter of one tile by one digit.  Warp w owns the tile's rows
// [w * kWarpRows, (w + 1) * kWarpRows), 32 a round in row order, held in
// registers, so the tile's row order is (warp, round, lane).  Ranking takes
// three block barriers: (1) each warp counts its digits (lanes grouped by
// digit_peers, the group's first lane adds the group's size);
// (2) thread t turns digit t's per-warp counts into the tile-local start of
// each warp's share; (3) each warp places its rows into shared memory,
// digit-sorted, a lane after the lower lanes of its group and a round
// after the earlier rounds.  Then each digit's run of the tile is copied
// to its global offset, neighbouring threads on neighbouring addresses.
// Three blocks a SM (80 registers a thread): at the compiler's own 95 the
// SM holds two, and the scatter runs slower on an H100.
__global__ void __launch_bounds__(kThreads, 3)
scatter_kernel(const unsigned* __restrict__ kv_in, const unsigned* __restrict__ idx_in,
               long long n, int shift, const unsigned* __restrict__ offsets,
               const unsigned* __restrict__ totals, long long ntiles,
               unsigned* __restrict__ kv_out, unsigned* __restrict__ idx_out) {
  __shared__ unsigned s_kv[kTile];
  __shared__ unsigned s_idx[kTile];
  __shared__ unsigned s_local[kRadix];   // tile-local start of each digit's run
  __shared__ unsigned s_global[kRadix];  // global start of that run
  __shared__ unsigned s_warp[kWarps][kRadix];  // per-warp digit counts, then starts
  __shared__ unsigned s_scan[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned below = lanes_below(lane);
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long wbase = base + static_cast<long long>(wid) * kWarpRows;

#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w][tid] = 0;
  unsigned k[kItems], x[kItems], peers[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = wbase + r * 32 + lane;
    k[r] = i < n ? kv_in[i] : 0u;
    x[r] = i < n ? idx_in[i] : 0u;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool v = wbase + r * 32 + lane < n;
    const unsigned digit = (k[r] >> shift) & 0xFFu;
    peers[r] = digit_peers(digit, v);
    if (v && (peers[r] & below) == 0) s_warp[wid][digit] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();

  unsigned tile_count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_count += s_warp[w][tid];
  const unsigned local = block_exclusive_scan(tile_count, s_scan);
  const unsigned digit_base = block_exclusive_scan(totals[tid], s_scan);
  s_local[tid] = local;
  s_global[tid] = digit_base + offsets[tid * ntiles + blockIdx.x];
  unsigned start = local;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp[w][tid];
    s_warp[w][tid] = start;
    start += c;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool v = wbase + r * 32 + lane < n;
    const unsigned digit = (k[r] >> shift) & 0xFFu;
    unsigned at = 0;
    if (v) {
      at = s_warp[wid][digit];
      const unsigned pos = at + __popc(peers[r] & below);
      s_kv[pos] = k[r];
      s_idx[pos] = x[r];
    }
    __syncwarp();  // every lane has read its group's start
    if (v && (peers[r] & below) == 0) s_warp[wid][digit] = at + __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();

  const long long left = n - base;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = tid; j < tile_n; j += kThreads) {
    const unsigned kj = s_kv[j];
    const unsigned digit = (kj >> shift) & 0xFFu;
    const unsigned g = s_global[digit] + (static_cast<unsigned>(j) - s_local[digit]);
    kv_out[g] = kj;
    idx_out[g] = s_idx[j];
  }
}

__global__ void __launch_bounds__(kThreads)
perm_kernel(const unsigned* __restrict__ idx, long long n, long long* __restrict__ perm) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) perm[i] = idx ? static_cast<long long>(idx[i]) : i;
}

unsigned grid_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// and_or[2] = (AND, OR) of the low 32 bits of one int64 key column.
extern "C" int sn_radix_bits(const void* key, long long n, void* and_or, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  unsigned* ao = static_cast<unsigned*>(and_or);
  cudaMemsetAsync(ao, 0xFF, sizeof(unsigned), s);
  cudaMemsetAsync(ao + 1, 0, sizeof(unsigned), s);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    const unsigned grid = static_cast<unsigned>(blocks < 132 * 8 ? blocks : 132 * 8);
    bits_kernel<<<grid, kThreads, 0, s>>>(static_cast<const long long*>(key), n, ao);
  }
  return static_cast<int>(cudaGetLastError());
}

// kv[i] = low 32 bits of key[idx[i]]; init: idx[i] = i first.
extern "C" int sn_radix_gather(const void* key, void* idx, long long n, int init, void* kv,
                               void* stream) {
  if (n > 0)
    gather_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(key), static_cast<unsigned*>(idx), n, init,
        static_cast<unsigned*>(kv));
  return static_cast<int>(cudaGetLastError());
}

// One stable pass by the 8-bit digit at `shift` of (kv_in, idx_in) into
// (kv_out, idx_out).  counts/offsets: 256 * ceil(n / 4096) uint32 scratch;
// totals: 256 uint32 scratch.
extern "C" int sn_radix_pass(const void* kv_in, const void* idx_in, long long n, int shift,
                             void* counts, void* offsets, void* totals, void* kv_out,
                             void* idx_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kTile - 1) / kTile;
  tile_count_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      static_cast<const unsigned*>(kv_in), n, shift, static_cast<unsigned*>(counts), ntiles);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  scan_kernel<<<kRadix, kScanThreads, 0, s>>>(static_cast<const unsigned*>(counts), ntiles,
                                              static_cast<unsigned*>(offsets),
                                              static_cast<unsigned*>(totals));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  scatter_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      static_cast<const unsigned*>(kv_in), static_cast<const unsigned*>(idx_in), n, shift,
      static_cast<const unsigned*>(offsets), static_cast<const unsigned*>(totals), ntiles,
      static_cast<unsigned*>(kv_out), static_cast<unsigned*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

// perm[i] = idx[i] widened to int64 (the identity when idx is null).
extern "C" int sn_radix_perm(const void* idx, long long n, void* perm, void* stream) {
  if (n > 0)
    perm_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(idx), n, static_cast<long long*>(perm));
  return static_cast<int>(cudaGetLastError());
}
