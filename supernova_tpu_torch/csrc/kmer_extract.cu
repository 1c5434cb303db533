// K1 — sliding 48-mer word extraction for Hopper (sm_90a).
//
// Replaces: supernova_tpu/ops/pallas/kmer_extract.py, sliding_words_pallas
// (body _extract_kernel).  For each start p < n it writes the three words
// packing bases p..p+47, 16 bases per word, 2 bits per base, MSB first,
// zero-extended to int64 (the port's word layout).
//
// Bound: device-memory traffic.  Each position reads one 4-byte code and
// writes three 8-byte words (28 bytes/position, ~2.5 GB at 90M positions);
// the 48 shift-ors per position are cheap integer work.
//
// Design: one thread per output position.  A block stages its tile of
// 256 + 47 codes in shared memory with coalesced loads, so every code is
// read from device memory about once (not 48 times), and each thread builds
// its words from consecutive shared-memory cells (no bank conflicts).
// Stores are coalesced int64 writes.  The TPU kernel's lane-roll layout
// (rolled copies selected at the 128-lane seam) has no counterpart here.
// The ragged edge is masked: positions >= n write nothing, codes past the
// end of the input read as 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 48;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kmer_extract_kernel(const int32_t* __restrict__ codes, long long n, long long m,
                    int64_t* __restrict__ w0, int64_t* __restrict__ w1,
                    int64_t* __restrict__ w2) {
  __shared__ uint32_t tile[kThreads + kK - 1];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  for (int i = threadIdx.x; i < kThreads + kK - 1; i += kThreads) {
    const long long p = base + i;
    tile[i] = p < m ? static_cast<uint32_t>(codes[p]) : 0u;
  }
  __syncthreads();
  const long long p = base + threadIdx.x;
  if (p >= n) return;
  uint32_t words[3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc = (acc << 2) | tile[threadIdx.x + w * 16 + i];
    words[w] = acc;
  }
  w0[p] = static_cast<int64_t>(words[0]);
  w1[p] = static_cast<int64_t>(words[1]);
  w2[p] = static_cast<int64_t>(words[2]);
}

}  // namespace

extern "C" int sn_kmer_extract(const void* codes, long long n, long long m,
                               void* w0, void* w1, void* w2, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  kmer_extract_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, m, static_cast<int64_t*>(w0),
      static_cast<int64_t*>(w1), static_cast<int64_t*>(w2));
  return static_cast<int>(cudaGetLastError());
}
