// K2 — stable stream compaction for Hopper (sm_90a), in one pass.
//
// Replaces: supernova_tpu/ops/pallas/compact.py, compact_stream_pallas
// (body _compact_kernel).  Moves the rows where valid[i] holds to the front
// of 1..8 columns (4- or 8-byte elements), keeping their order, and writes
// n_valid.  Given fill values, it writes column k's fill to its rows
// [n_valid, n) (the count path's zero and sentinel tails); without them
// those rows are left unspecified.
//
// Bound: device-memory traffic.  The function reads the mask (1 B a row)
// and the kept rows of every column and writes the kept rows; with fill it
// writes all n rows of every column.  Kept rows are sparse on the count
// path (3% of the occurrence rows), so reading a kept row of a column
// costs a whole 32 B sector.  This design's floor is therefore
//   n + kept * ncols * 32 + kept * row_bytes   bytes without fill,
//   n + kept * ncols * 32 + n * row_bytes      bytes with fill.
//
// Design: ONE launch; the wrapper zeroes ceil(n / kTile) + 1 int64 words of
// scratch before it (a look-back status word per tile, then the tile
// counter).  Each block
//   1. takes its tile number in block start order (lookback::take_tile), so
//      it only waits on tiles whose blocks already run;
//   2. loads the tile's mask, each thread kItems contiguous bytes with one
//      16-byte vector load (byte loads where the mask's address is not
//      16-byte aligned, and in the ragged last tile);
//   3. ranks the kept rows in row order by a warp-shuffle block scan of the
//      threads' counts;
//   4. publishes its kept count and finds its output offset P by decoupled
//      look-back (lookback.cuh); meanwhile the other threads write the
//      tile's kept rows to shared memory in rank order;
//   5. copies the kept rows: thread j of the block moves kept row j of every
//      column to output row P + j, so stores are coalesced and each load
//      touches one sector per kept row per column;
//   6. with fill, writes the fill to its share of the tail: its d dropped
//      rows take output rows [n - D - d, n - D), where D = tile start - P is
//      the count of rows dropped before the tile.  These ranges partition
//      [n_valid, n) (in reverse tile order) and never meet the kept rows;
//      the block writes its range with 16-byte stores;
//   7. the last tile writes n_valid = P + its kept count.
// The tile shape and register cap are fixed constants, chosen on an H100 at
// the count's shape (61.8M rows x 5 columns, 3.4% kept) among 4096- and
// 8192-row tiles at 1-8 blocks a SM: 4096 rows at 6 blocks (39 registers,
// no spill).
// Rank order is row order, so the compaction is stable.  The TPU kernel's
// in-block log-shift network and its phase-2 stitch (Mosaic cannot DMA to
// an unaligned offset) have no counterpart: a thread stores to any address.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // mask bytes a thread loads: one 16-byte vector
constexpr int kMinBlocks = 6;  // resident blocks a SM must fit (the register cap)
constexpr int kTile = kThreads * kItems;
static_assert(kItems == 16, "one 16-byte mask load a thread");
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;
constexpr unsigned kTag = 1;  // the scratch is zeroed before every launch

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  long long fill[kMaxCols];
  int esize[kMaxCols];
  int ncols;
  int has_fill;
};

// Bit r set: the thread's row r (of `rows`) is kept.
__device__ __forceinline__ unsigned load_bits(const uint8_t* __restrict__ valid, long long row,
                                              int rows, bool vector) {
  unsigned bits = 0;
  if (vector) {
    const uint4 v = *reinterpret_cast<const uint4*>(valid + row);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        bits |= (((w[q] >> (8 * b)) & 0xFFu) != 0u ? 1u : 0u) << (4 * q + b);
  } else {
    for (int r = 0; r < rows; ++r) bits |= (valid[row + r] != 0 ? 1u : 0u) << r;
  }
  return bits;
}

__device__ __forceinline__ uint4 splat(long long v) {
  const unsigned lo = static_cast<unsigned>(v), hi = static_cast<unsigned>(v >> 32);
  return make_uint4(lo, hi, lo, hi);
}
__device__ __forceinline__ uint4 splat(int v) {
  const unsigned u = static_cast<unsigned>(v);
  return make_uint4(u, u, u, u);
}

// The block writes `value` to out[0, count): 16-byte stores between a head
// and a tail of single elements (out is aligned to its element).
template <typename T>
__device__ __forceinline__ void fill_rows(T* out, int count, T value) {
  constexpr int kPer = 16 / sizeof(T);
  const int skew = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(out) & 15u)) & 15u);
  const int head = skew / static_cast<int>(sizeof(T)) < count ? skew / static_cast<int>(sizeof(T))
                                                              : count;
  const int nvec = (count - head) / kPer;
  const int tail = head + nvec * kPer;
  if (static_cast<int>(threadIdx.x) < head) out[threadIdx.x] = value;
  if (static_cast<int>(threadIdx.x) < count - tail) out[tail + threadIdx.x] = value;
  uint4* body = reinterpret_cast<uint4*>(out + head);
  const uint4 v = splat(value);
  for (int j = threadIdx.x; j < nvec; j += kThreads) body[j] = v;
}

// Exclusive scan of one count per thread over the block; `total` gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = s_warp[w];
    if (w < wid) before += s;
    sum += s;
  }
  total = sum;
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_kernel(const uint8_t* __restrict__ valid, long long n, int vector_ok, Columns cols,
               unsigned long long* __restrict__ status, unsigned* __restrict__ counter,
               long long* __restrict__ n_valid) {
  __shared__ unsigned short s_rows[kTile];  // kept rows' offsets in the tile, in rank order
  __shared__ int s_warp[kWarps];
  __shared__ long long s_tile, s_prefix;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = lookback::take_tile(counter);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;
  const long long left = n - base;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  const int first = tid * kItems;
  const int rows = tile_n - first < 0 ? 0 : (tile_n - first < kItems ? tile_n - first : kItems);
  const unsigned bits = load_bits(valid, base + first, rows, vector_ok && rows == kItems);

  int kept;
  const int rank = block_exclusive_scan(__popc(bits), s_warp, kept);
  if (tid == 0) {
    unsigned long long* mine = status + tile;
    unsigned long long prefix = 0;
    if (tile == 0) {
      lookback::publish(mine, kTag, lookback::kPrefix, kept);
    } else {
      lookback::publish(mine, kTag, lookback::kAggregate, kept);
      prefix = lookback::exclusive_prefix(status, tile, 1, kTag);
      lookback::publish(mine, kTag, lookback::kPrefix, prefix + kept);
    }
    s_prefix = static_cast<long long>(prefix);
    if (tile == gridDim.x - 1) *n_valid = static_cast<long long>(prefix) + kept;
  }
  int r = rank;
  for (unsigned b = bits; b; b &= b - 1u)
    s_rows[r++] = static_cast<unsigned short>(first + __ffs(b) - 1);
  __syncthreads();
  const long long prefix = s_prefix;

  for (int j = tid; j < kept; j += kThreads) {
    const long long src = base + s_rows[j];
    const long long dst = prefix + j;
    long long v[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < cols.ncols)
        v[k] = cols.esize[k] == 8 ? static_cast<const long long*>(cols.in[k])[src]
                                  : static_cast<const int*>(cols.in[k])[src];
    }
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k >= cols.ncols) break;
      if (cols.esize[k] == 8) {
        static_cast<long long*>(cols.out[k])[dst] = v[k];
      } else {
        static_cast<int*>(cols.out[k])[dst] = static_cast<int>(v[k]);
      }
    }
  }

  if (cols.has_fill) {
    const int dropped = tile_n - kept;
    const long long start = n - (base - prefix) - dropped;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k >= cols.ncols) break;
      if (cols.esize[k] == 8) {
        fill_rows(static_cast<long long*>(cols.out[k]) + start, dropped, cols.fill[k]);
      } else {
        fill_rows(static_cast<int*>(cols.out[k]) + start, dropped,
                  static_cast<int>(cols.fill[k]));
      }
    }
  }
}

}  // namespace

// Rows per tile (one look-back status word each).
extern "C" int sn_compact_tile_rows() { return kTile; }

// valid: n bytes (0 = dropped); in_ptrs/out_ptrs: host arrays of ncols
// device pointers; esizes: host int[ncols], each 4 or 8; fills: host
// long long[ncols] (cast to the column's type) or null for no fill;
// scratch: scratch_words int64 words, at least ceil(n / tile) + 1, zeroed;
// n_valid: one int64.
extern "C" int sn_compact(const void* valid, long long n, int ncols, const void* in_ptrs,
                          const void* out_ptrs, const void* esizes, const void* fills,
                          void* scratch, long long scratch_words, void* n_valid, void* stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  if (ncols < 1 || ncols > kMaxCols || n < 0 || ntiles >= (1LL << 31) ||
      scratch_words < ntiles + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  const auto* in = static_cast<const unsigned long long*>(in_ptrs);
  const auto* out = static_cast<const unsigned long long*>(out_ptrs);
  const auto* es = static_cast<const int*>(esizes);
  const auto* fl = static_cast<const long long*>(fills);
  for (int k = 0; k < kMaxCols; ++k) {
    const bool on = k < ncols;
    if (on && es[k] != 4 && es[k] != 8) return static_cast<int>(cudaErrorInvalidValue);
    cols.in[k] = on ? reinterpret_cast<const void*>(in[k]) : nullptr;
    cols.out[k] = on ? reinterpret_cast<void*>(out[k]) : nullptr;
    cols.esize[k] = on ? es[k] : 0;
    cols.fill[k] = on && fl ? fl[k] : 0;
  }
  cols.ncols = ncols;
  cols.has_fill = fl != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  if (ntiles == 0) {
    cudaMemsetAsync(n_valid, 0, sizeof(long long), s);
    return static_cast<int>(cudaGetLastError());
  }
  auto* status = static_cast<unsigned long long*>(scratch);
  const int vector_ok = (reinterpret_cast<uintptr_t>(valid) & 15u) == 0u;
  compact_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(valid), n, vector_ok, cols, status,
      reinterpret_cast<unsigned*>(status + ntiles), static_cast<long long*>(n_valid));
  return static_cast<int>(cudaGetLastError());
}
