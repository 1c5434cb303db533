// K2 — stable stream compaction for Hopper (sm_90a).
//
// Replaces: supernova_tpu/ops/pallas/compact.py, compact_stream_pallas
// (body _compact_kernel).  Moves the rows where valid[i] holds to the front
// of up to 8 columns (4- or 8-byte elements), keeping their order, and
// writes n_valid.  Rows past n_valid are left unspecified; the caller
// zeroes them (ops/segments.py:compact_sorted_words).
//
// Bound: device-memory traffic — one byte of mask read twice, every column
// read once and its kept rows written once.
//
// Design: three launches, each row written straight to its final offset.
//   1. count:   each block counts the valid rows of its 4096-row tile.
//   2. scan:    one block scans the per-tile counts (exclusive) and writes
//               the total, looping over chunks of 1024 tiles.
//   3. scatter: each block walks its tile in 16 rounds of 256 rows; a warp
//               ballot + popcount ranks the kept rows of each warp, a
//               shared-memory prefix over the 8 warps ranks the warps, and
//               every kept row is copied to tile offset + running rank.
// Rounds go in row order and ranks follow lane order, so the compaction is
// stable.  The TPU kernel's in-block log-shift network and its phase-2
// stitch (Mosaic cannot DMA to an unaligned offset) have no counterpart:
// a thread can store to any address.  Decoupled look-back (one pass
// instead of three) is left to a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;
constexpr int kScanThreads = 1024;

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int esize[kMaxCols];
  int ncols;
};

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ valid, long long n, int* __restrict__ counts) {
  __shared__ int warp_total[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    c += (i < n && valid[i] != 0) ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_total[wid] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_total[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, long long nblocks,
            long long* __restrict__ offsets, long long* __restrict__ total) {
  __shared__ long long warp_sum[kScanThreads / 32];
  __shared__ long long carry;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < nblocks; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < nblocks ? counts[i] : 0;
    long long x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[wid] = x;
    __syncthreads();
    if (wid == 0) {  // inclusive scan of the 32 warp sums
      long long s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    const long long excl = carry + (wid > 0 ? warp_sum[wid - 1] : 0) + x - v;
    if (i < nblocks) offsets[i] = excl;
    __syncthreads();  // every thread has read carry and warp_sum
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__device__ __forceinline__ void copy_row(const Columns& cols, long long src, long long dst) {
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    if (k >= cols.ncols) break;
    if (cols.esize[k] == 8) {
      static_cast<int64_t*>(cols.out[k])[dst] = static_cast<const int64_t*>(cols.in[k])[src];
    } else {
      static_cast<int32_t*>(cols.out[k])[dst] = static_cast<const int32_t*>(cols.in[k])[src];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ valid, long long n,
               const long long* __restrict__ offsets, Columns cols) {
  __shared__ int warp_count[kWarps];
  __shared__ int warp_prefix[kWarps];
  __shared__ int round_total;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  long long out = offsets[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    const bool v = i < n && valid[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_count[wid] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        warp_prefix[w] = s;
        s += warp_count[w];
      }
      round_total = s;
    }
    __syncthreads();
    if (v) copy_row(cols, i, out + warp_prefix[wid] + rank);
    out += round_total;
    __syncthreads();  // warp_count/warp_prefix/round_total are rewritten next round
  }
}

}  // namespace

extern "C" int sn_compact(const void* valid, long long n, int ncols,
                          const void* in_ptrs, const void* out_ptrs,
                          const void* esizes, void* counts, void* offsets,
                          void* n_valid, void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  const auto* in = static_cast<const unsigned long long*>(in_ptrs);
  const auto* out = static_cast<const unsigned long long*>(out_ptrs);
  const auto* es = static_cast<const int*>(esizes);
  for (int k = 0; k < kMaxCols; ++k) {
    cols.in[k] = k < ncols ? reinterpret_cast<const void*>(in[k]) : nullptr;
    cols.out[k] = k < ncols ? reinterpret_cast<void*>(out[k]) : nullptr;
    cols.esize[k] = k < ncols ? es[k] : 0;
  }
  cols.ncols = ncols;
  auto s = static_cast<cudaStream_t>(stream);
  const long long nblocks = (n + kTile - 1) / kTile;
  if (nblocks == 0) {
    cudaMemsetAsync(n_valid, 0, sizeof(long long), s);
    return static_cast<int>(cudaGetLastError());
  }
  const auto* mask = static_cast<const uint8_t*>(valid);
  count_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      mask, n, static_cast<int*>(counts));
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  scan_kernel<<<1, kScanThreads, 0, s>>>(static_cast<const int*>(counts), nblocks,
                                          static_cast<long long*>(offsets),
                                          static_cast<long long*>(n_valid));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  scatter_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      mask, n, static_cast<const long long*>(offsets), cols);
  return static_cast<int>(cudaGetLastError());
}
