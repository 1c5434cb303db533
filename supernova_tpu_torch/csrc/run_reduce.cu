// K3 — fused per-run reduction over the sorted occurrence stream, for
// Hopper (sm_90a).
//
// Replaces: supernova_tpu/ops/pallas/run_reduce.py, run_reduce_pallas
// (body _run_reduce_kernel).  Input: the occurrence stream sorted by
// (w0, w1, w2, pk), pk = barcode(22b)<<10 | left mask<<6 | right mask<<2 |
// valid<<1.  At every run-END row (words differ from the next row; past the
// last row the next words are the all-ones sentinel) it computes, over the
// run: the count of valid rows, the count of distinct barcodes (a valid row
// whose barcode field is new within the run, 0 < bc != 0x3FFFFF), whether a
// valid row has the ignored barcode 0x3FFFFF, and the OR of the left and
// right masks of valid rows.  Outputs, at every row (zero off run ends):
//   keep  = end & real & count >= min_freq & (ignored | nbc >= min_bc)
//   count = the run's valid count
//   stats = min(nbc, 4095)<<9 | lm<<5 | rm<<1 | ignored
// keep uses the unclamped nbc.  (The TPU kernel leaves a running partial
// in `count` at non-end rows; nothing downstream reads it.)
//
// Bound: device-memory traffic — 32 bytes read per row (four int64
// columns), 9 bytes written.
//
// Design: a balanced segmented reduction; no thread walks a run.  Every
// quantity is a sum or an OR of a per-row contribution that needs only the
// row and its predecessor (start flag, valid, new-barcode flag, the
// ignored bit, the mask bits), so the run totals are a segmented inclusive
// scan under (start_r ? r : l + r), sums for the counts and OR for the
// bits — associative, so any split gives the same result.  Two launches:
//   1. tail_kernel: one warp per 2048-row tile walks back from the tile's
//      end, 32 rows a step, to the tile's last run start, and writes the
//      tile's tail aggregate (the contributions from that start on, and
//      whether the tile has a start at all);
//   2. run_reduce_kernel: one block per tile computes the rows'
//      contributions (coalesced loads, one row a thread a round) into
//      shared memory, each thread reduces 8 consecutive rows, and a
//      segmented scan over the block (warp shuffles, then the warps) gives
//      each thread its carry; a tile whose first run began earlier takes
//      the carry from the earlier tiles' tail aggregates, 32 tiles a step,
//      back to the first tile with a start.  Run-end rows write the
//      outputs, every other row writes zeros.
// Work per tile is bounded by tiles, not rows: a run of a million rows
// costs its tiles one tail each and a walk over at most ~490 aggregates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // consecutive rows a thread reduces (two uint4 of flags)
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kSent = 0xFFFFFFFFLL;
constexpr uint64_t kBcIgnored = 0x3FFFFFull;

// Per-row flag word: bits 0-8 the row's stats bits (lm<<5 | rm<<1 | ign,
// zero unless valid), then the flags below.
constexpr unsigned kStatBits = 0x1FFu;
constexpr unsigned kValid = 1u << 9;
constexpr unsigned kNewBc = 1u << 10;
constexpr unsigned kStart = 1u << 11;
constexpr unsigned kReal = 1u << 12;
// Aggregate: counts and the OR of the stats bits; kHasStart marks an
// aggregate whose rows include a run start (it does not reach further back).
constexpr unsigned kHasStart = 1u << 31;

struct Agg {
  unsigned cnt, nbc, bits;
};

__device__ __forceinline__ Agg combine(const Agg& l, const Agg& r) {
  return (r.bits & kHasStart) ? r : Agg{l.cnt + r.cnt, l.nbc + r.nbc, l.bits | r.bits};
}

__device__ __forceinline__ Agg contribution(unsigned f) {
  return Agg{(f >> 9) & 1u, (f >> 10) & 1u, (f & kStatBits) | ((f & kStart) ? kHasStart : 0u)};
}

struct Cols {
  const int64_t* w0;
  const int64_t* w1;
  const int64_t* w2;
  const int64_t* pk;
};

__device__ __forceinline__ bool starts_run(const Cols& c, long long i) {
  return i == 0 || c.w0[i - 1] != c.w0[i] || c.w1[i - 1] != c.w1[i] || c.w2[i - 1] != c.w2[i];
}

// The flag word of row i (0 <= i < n).
__device__ __forceinline__ unsigned row_flags(const Cols& c, long long i) {
  const int64_t a = c.w0[i], b = c.w1[i], d = c.w2[i];
  const uint64_t p = static_cast<uint64_t>(c.pk[i]);
  bool start = true;
  uint64_t prev_bcf = 0;
  if (i > 0) {
    start = c.w0[i - 1] != a || c.w1[i - 1] != b || c.w2[i - 1] != d;
    prev_bcf = static_cast<uint64_t>(c.pk[i - 1]) >> 10;
  }
  unsigned f = (start ? kStart : 0u) | ((a == kSent && b == kSent && d == kSent) ? 0u : kReal);
  if ((p >> 1) & 1u) {
    const uint64_t bcf = p >> 10;
    f |= kValid;
    if (bcf > 0 && bcf != kBcIgnored && (start || bcf != prev_bcf)) f |= kNewBc;
    f |= static_cast<unsigned>(((p >> 6) & 15u) << 5 | ((p >> 2) & 15u) << 1) |
         (bcf == kBcIgnored ? 1u : 0u);
  }
  return f;
}

__device__ __forceinline__ Agg warp_sum(Agg a) {
  return Agg{__reduce_add_sync(0xffffffffu, a.cnt), __reduce_add_sync(0xffffffffu, a.nbc),
             __reduce_or_sync(0xffffffffu, a.bits)};
}

// tails[t] = (cnt, nbc, bits) of tile t's rows from its last run start on
// (kHasStart set), or of all its rows when it has no start.
__global__ void __launch_bounds__(kThreads)
tail_kernel(Cols c, long long n, long long ntiles, uint4* __restrict__ tails) {
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= ntiles) return;
  const long long lo = tile * kTile;
  const long long hi = lo + kTile < n ? lo + kTile : n;
  Agg acc{0u, 0u, 0u};
  for (long long top = hi; top > lo; top -= 32) {
    const long long j = top - 1 - lane;  // lane 0 holds the highest row
    const unsigned f = j >= lo ? row_flags(c, j) : 0u;
    const unsigned starts = __ballot_sync(0xffffffffu, (f & kStart) != 0u);
    const int last = starts ? __ffs(starts) - 1 : 31;  // the lane of the last start
    Agg a = lane <= last ? contribution(f) : Agg{0u, 0u, 0u};
    a = warp_sum(a);
    acc = Agg{acc.cnt + a.cnt, acc.nbc + a.nbc, acc.bits | a.bits};
    if (starts) break;
  }
  if (lane == 0) tails[tile] = make_uint4(acc.cnt, acc.nbc, acc.bits, 0u);
}

__device__ __forceinline__ Agg shfl_up(const Agg& a, int o) {
  return Agg{__shfl_up_sync(0xffffffffu, a.cnt, o), __shfl_up_sync(0xffffffffu, a.nbc, o),
             __shfl_up_sync(0xffffffffu, a.bits, o)};
}

__global__ void __launch_bounds__(kThreads)
run_reduce_kernel(Cols c, long long n, int min_freq, int min_bc,
                  const uint4* __restrict__ tails, bool* __restrict__ keep,
                  int32_t* __restrict__ count, int32_t* __restrict__ stats) {
  __shared__ __align__(16) unsigned s_f[kTile + 4];  // flag words; [tile_n]: the next row's
  __shared__ Agg s_warp[kWarps];
  __shared__ Agg s_carry;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long tile = blockIdx.x;
  const long long base = tile * kTile;
  const long long left = n - base;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;

  // the rows' flag words, one row a thread a round (coalesced)
#pragma unroll 4
  for (int r = tid; r < kTile; r += kThreads) s_f[r] = r < tile_n ? row_flags(c, base + r) : 0u;
  if (tid == 0) s_f[tile_n] = (base + tile_n < n && starts_run(c, base + tile_n)) ? kStart : 0u;
  __syncthreads();

  // warp 0: the carry into the tile's first run from the earlier tiles
  if (wid == 0) {
    Agg carry{0u, 0u, 0u};
    if (!(s_f[0] & kStart)) {  // then tile > 0: row 0 starts a run
      for (long long top = tile; top > 0; top -= 32) {
        const long long j = top - 1 - lane;  // lane 0 holds the nearest tile
        const uint4 t = j >= 0 ? tails[j] : make_uint4(0u, 0u, 0u, 0u);
        const unsigned has = __ballot_sync(0xffffffffu, (t.z & kHasStart) != 0u);
        const int last = has ? __ffs(has) - 1 : 31;
        Agg a = lane <= last ? Agg{t.x, t.y, t.z} : Agg{0u, 0u, 0u};
        a = warp_sum(a);
        carry = Agg{carry.cnt + a.cnt, carry.nbc + a.nbc, carry.bits | a.bits};
        if (has) break;
      }
    }
    if (lane == 0) s_carry = Agg{carry.cnt, carry.nbc, carry.bits & ~kHasStart};
  }

  // each thread: its kItems consecutive rows, reduced
  const int r0 = tid * kItems;
  unsigned f[kItems + 1];
  const uint4 f0 = reinterpret_cast<const uint4*>(s_f + r0)[0];
  const uint4 f1 = reinterpret_cast<const uint4*>(s_f + r0)[1];
  f[0] = f0.x, f[1] = f0.y, f[2] = f0.z, f[3] = f0.w;
  f[4] = f1.x, f[5] = f1.y, f[6] = f1.z, f[7] = f1.w;
  f[8] = s_f[r0 + kItems];
  Agg agg{0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kItems; ++k) agg = combine(agg, contribution(f[k]));

  // segmented exclusive scan of the threads' aggregates
  Agg x = agg;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Agg y = shfl_up(x, o);
    if (lane >= o) x = combine(y, x);
  }
  if (lane == 31) s_warp[wid] = x;
  Agg excl = shfl_up(x, 1);
  if (lane == 0) excl = Agg{0u, 0u, 0u};
  __syncthreads();
  Agg run = s_carry;
  for (int w = 0; w < wid; ++w) run = combine(run, s_warp[w]);
  run = combine(run, excl);

  // outputs
  unsigned char kp[kItems];
  int32_t ct[kItems], st[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = combine(run, contribution(f[k]));
    const long long i = base + r0 + k;
    const bool end = i + 1 < n ? (f[k + 1] & kStart) != 0u : (f[k] & kReal) != 0u;
    kp[k] = 0;
    ct[k] = 0;
    st[k] = 0;
    if (end) {
      const int cnt = static_cast<int>(run.cnt), nbc = static_cast<int>(run.nbc);
      kp[k] = (f[k] & kReal) && cnt >= min_freq && ((run.bits & 1u) || nbc >= min_bc);
      ct[k] = cnt;
      st[k] = static_cast<int32_t>((static_cast<unsigned>(nbc < 4095 ? nbc : 4095) << 9) |
                                   (run.bits & kStatBits));
    }
  }
  const long long i0 = base + r0;
  if (r0 + kItems <= tile_n) {
    uint2 kv;
    kv.x = kp[0] | kp[1] << 8 | kp[2] << 16 | static_cast<unsigned>(kp[3]) << 24;
    kv.y = kp[4] | kp[5] << 8 | kp[6] << 16 | static_cast<unsigned>(kp[7]) << 24;
    *reinterpret_cast<uint2*>(keep + i0) = kv;
    reinterpret_cast<int4*>(count + i0)[0] = make_int4(ct[0], ct[1], ct[2], ct[3]);
    reinterpret_cast<int4*>(count + i0)[1] = make_int4(ct[4], ct[5], ct[6], ct[7]);
    reinterpret_cast<int4*>(stats + i0)[0] = make_int4(st[0], st[1], st[2], st[3]);
    reinterpret_cast<int4*>(stats + i0)[1] = make_int4(st[4], st[5], st[6], st[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (r0 + k < tile_n) {
        keep[i0 + k] = kp[k];
        count[i0 + k] = ct[k];
        stats[i0 + k] = st[k];
      }
    }
  }
}

}  // namespace

// Rows per tile of the reduction.
extern "C" int sn_run_reduce_tile_rows() { return kTile; }

// keep/count/stats must be 16-byte aligned (fresh allocations); tails:
// tail_slots x 16 bytes of scratch, at least
// ceil(n / sn_run_reduce_tile_rows()) slots.
extern "C" int sn_run_reduce(const void* w0, const void* w1, const void* w2,
                             const void* pk, long long n, int min_freq, int min_bc,
                             void* tails, long long tail_slots, void* keep, void* count,
                             void* stats, void* stream) {
  if (n <= 0) return 0;
  const long long ntiles = (n + kTile - 1) / kTile;
  if (tail_slots < ntiles) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Cols c{static_cast<const int64_t*>(w0), static_cast<const int64_t*>(w1),
               static_cast<const int64_t*>(w2), static_cast<const int64_t*>(pk)};
  tail_kernel<<<static_cast<unsigned>((ntiles + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      c, n, ntiles, static_cast<uint4*>(tails));
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  run_reduce_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      c, n, min_freq, min_bc, static_cast<const uint4*>(tails), static_cast<bool*>(keep),
      static_cast<int32_t*>(count), static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}
