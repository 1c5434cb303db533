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
// Design: the TPU grid runs in order, so its kernel carries an open run's
// partial sums across blocks in SMEM.  Hopper blocks run in no order, so
// nothing crosses blocks here: one thread per row, and each run-end thread
// walks back to its run's start and accumulates the eleven partials itself.
// Every row is visited by exactly one walk, so total work is O(n); the
// walk's rows were just read by neighbouring threads and sit in L1/L2.
// Long high-copy runs leave one thread with a long walk (load imbalance);
// acceptable for now.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSent = 0xFFFFFFFFLL;
constexpr uint64_t kBcIgnored = 0x3FFFFFull;

__global__ void __launch_bounds__(kThreads)
run_reduce_kernel(const int64_t* __restrict__ w0, const int64_t* __restrict__ w1,
                  const int64_t* __restrict__ w2, const int64_t* __restrict__ pk,
                  long long n, int min_freq, int min_bc, bool* __restrict__ keep,
                  int32_t* __restrict__ count, int32_t* __restrict__ stats) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t a = w0[i], b = w1[i], c = w2[i];
  const bool real = !(a == kSent && b == kSent && c == kSent);
  const bool end = (i + 1 < n) ? (w0[i + 1] != a || w1[i + 1] != b || w2[i + 1] != c)
                               : real;
  if (!end) {
    keep[i] = false;
    count[i] = 0;
    stats[i] = 0;
    return;
  }
  int cnt = 0, nbc = 0;
  bool ign = false;
  uint32_t lm = 0, rm = 0;
  for (long long j = i;; --j) {
    const uint64_t p = static_cast<uint64_t>(pk[j]);
    const bool start = j == 0 || w0[j - 1] != a || w1[j - 1] != b || w2[j - 1] != c;
    if ((p >> 1) & 1u) {
      const uint64_t bcf = p >> 10;
      ++cnt;
      const bool new_pair = start || bcf != (static_cast<uint64_t>(pk[j - 1]) >> 10);
      if (bcf > 0 && bcf != kBcIgnored && new_pair) ++nbc;
      if (bcf == kBcIgnored) ign = true;
      lm |= static_cast<uint32_t>((p >> 6) & 15u);
      rm |= static_cast<uint32_t>((p >> 2) & 15u);
    }
    if (start) break;
  }
  keep[i] = real && cnt >= min_freq && (ign || nbc >= min_bc);
  count[i] = cnt;
  stats[i] = static_cast<int32_t>((static_cast<uint32_t>(nbc < 4095 ? nbc : 4095) << 9) |
                                  (lm << 5) | (rm << 1) | (ign ? 1u : 0u));
}

}  // namespace

extern "C" int sn_run_reduce(const void* w0, const void* w1, const void* w2,
                             const void* pk, long long n, int min_freq, int min_bc,
                             void* keep, void* count, void* stats, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  run_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(w0), static_cast<const int64_t*>(w1),
      static_cast<const int64_t*>(w2), static_cast<const int64_t*>(pk), n, min_freq,
      min_bc, static_cast<bool*>(keep), static_cast<int32_t*>(count),
      static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}
