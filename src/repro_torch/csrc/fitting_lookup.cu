// Batched bounded-window rank search over a sorted f32 key column: the
// FITing-Tree lookup's last step, one warp per query.
//
// Replaces the TPU kernel src/repro/kernels/fitting_lookup.py,
// fitting_lookup_pallas (body _lookup_kernel).  Per query q with window start
// qlo and window W = 2e+2 it computes
//
//     rank  = qlo + #{ j in [qlo, qlo+W) : key(j) < q }   (<= for side right)
//     found = any( j in [qlo, qlo+W) : key(j) == q )
//
// where key(j) = keys[j] for j < n and +inf past the column.  That is the
// reference's +inf padding to n_pad, bit for bit, without materialising it:
// the caller clamps qlo to [0, n_pad - W] exactly as the reference does, so
// a window may reach past n, and a padded key compares like any key.
//
// The TPU kernel bucketed queries by key block to feed a sequential grid and
// fell back to XLA when a bucket overflowed.  Here every query reads its own
// window, so there are no buckets, no capacity and no fallback.
//
// What bounds it on an H100: the key column (4n bytes; 32 MB at the smoke's
// n = 2^23, at most 64 MB for n < 2^24, where f32 keys stay exact) is read
// once from DRAM and, at 32 MB, fits the 50 MB L2; the rest is Q*(4+4+4+1)
// bytes of queries, window starts, ranks and flags.  The window re-reads
// (Q*W*4 bytes) are served by L2.  Design: lanes stride the window 32 keys
// at a time, so each step is one coalesced 128-byte load per warp and
// neighbouring queries' windows overlap in L2; counts come from
// __ballot_sync + __popc and `found` from __any_sync, so there is no shared
// memory and no block-level reduction.  Lane 0 writes the two results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kRight>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fitting_lookup_kernel(const float* __restrict__ keys, int64_t n,
                      const float* __restrict__ queries,
                      const int32_t* __restrict__ qlo, int64_t nq,
                      int32_t window, int32_t* __restrict__ rank,
                      bool* __restrict__ found) {
  const int lane = threadIdx.x & 31;
  const int64_t qi =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (qi >= nq) return;  // qi is uniform across the warp: it leaves whole

  const float q = queries[qi];
  const int64_t lo = qlo[qi];
  const int64_t hi = lo + window;
  int count = 0;
  bool any_eq = false;
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t j = base + lane;
    const bool in_win = j < hi;
    const float k = (in_win && j < n) ? __ldg(keys + j) : CUDART_INF_F;
    const bool below = in_win && (kRight ? (k <= q) : (k < q));
    count += __popc(__ballot_sync(kFullMask, below));
    any_eq |= __any_sync(kFullMask, in_win && k == q) != 0;
  }
  if (lane == 0) {
    rank[qi] = static_cast<int32_t>(lo + count);
    found[qi] = any_eq;
  }
}

}  // namespace

// Launches on `stream` without synchronising and allocates nothing; returns
// cudaGetLastError() (0 on success).  All pointers are device pointers.
extern "C" int fitting_lookup_launch(const float* keys, int64_t n,
                                     const float* queries,
                                     const int32_t* qlo, int64_t nq,
                                     int64_t window, int side_right,
                                     int32_t* rank, bool* found,
                                     void* stream) {
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (nq + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t w = static_cast<int32_t>(window);
  if (side_right) {
    fitting_lookup_kernel<true><<<grid, block, 0, s>>>(keys, n, queries, qlo,
                                                       nq, w, rank, found);
  } else {
    fitting_lookup_kernel<false><<<grid, block, 0, s>>>(keys, n, queries, qlo,
                                                        nq, w, rank, found);
  }
  return static_cast<int>(cudaGetLastError());
}
