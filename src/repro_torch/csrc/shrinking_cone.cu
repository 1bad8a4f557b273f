// ShrinkingCone (FITing-Tree Alg. 2) over many sorted f64 runs in one
// launch: the re-fit of a shard's dirty segments at publish
// (core/tree.py FITingTree.flush).  One warp fits one run.
//
// Replaces no TPU kernel: the JAX package fits on the host in numpy
// (src/repro/core/segmentation.py shrinking_cone), and so did the port
// until a publish re-fitting some 800 runs of about 1,900 keys a shard
// spent nearly all its time in that Python loop's per-run overhead.
//
// Function.  Run r is keys[off[r] .. off[r+1]), positions counted from
// its first key.  Exactly as shrinking_cone (core/segmentation.py), whose
// chunks this warp's 32-key steps replace: a segment opens at its origin
// (ox, oy) with the cone [0, +inf); each next key x at position y gives
// dx = x - ox, dy = y - oy and
//   dx == 0: ok iff dy <= error, the cone unchanged;
//   else     s = dy / dx, hi = (dy + error) / dx, lo = (dy - error) / dx,
//            ok iff lo_acc <= s <= hi_acc (paper), or
//            iff lo <= hi_acc and hi >= lo_acc (clamped),
// where [lo_acc, hi_acc] is the cone over the segment's earlier keys.  An
// ok key narrows the cone to [max(lo_acc, lo), min(hi_acc, hi)]; the first
// key that is not ok closes the segment and opens the next one there.
// Output: is_start[i] = 1 where key i opens a segment (every run's first
// key does), and in clamped mode slope[i] at each start: the segment's
// endpoint slope clamped into its last cone, as _close_slope gives it.
//
// Bits.  Every value is an IEEE f64 subtraction, addition or division
// (correctly rounded: explicit _rn intrinsics, nothing to contract into an
// FMA), and min / max are exact, so their order does not matter: no NaN
// arises on sorted finite keys, and no -0.0 (dy - error is +0.0 when
// equal, dx > 0).  The starts and slopes therefore equal shrinking_cone's
// bit for bit.
//
// Design.  Lane j of a step takes key pos + j and computes its s, hi and
// lo.  The cone before lane j is the carried cone narrowed by lanes < j:
// an exclusive prefix min of hi and max of lo, by warp shuffles.  A ballot
// finds the first lane that is not ok.  With none, the cone takes all 32
// lanes and the step advances 32 keys; else the segment closes at that
// lane and the next step starts just after it, with a fresh cone.  So a
// step costs one coalesced 256-byte read, three divisions a lane, ten
// shuffle rounds of doubles and a ballot.
//
// What bounds it on an H100: not bytes.  A shard's dirty runs are some
// 12 MB of keys read once and 1.5 MB of flags written, 4 us at 3.35 TB/s;
// each run is a dependent chain of steps (about n/32 plus one a segment),
// each waiting on its load and its divisions, so a launch lasts about as
// long as its longest run's chain.  Runs go one a warp, eight warps a
// block: a shard's ~800 runs are ~100 blocks, one wave on the card's 132
// SMs.  A single long run (a compaction's) gets no parallelism within it.
//
// Precondition: each run non-empty, ascending, finite (what a merged run
// of a FITingTree holds); the wrapper checks the offsets.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// _close_slope(xs, s0, s1, sl_lo, sl_hi) of core/segmentation.py, with
// Python's min / max: max(a, b) is b only where b > a, min(a, b, c) keeps
// the first of equals.
__device__ double close_slope(const double* keys, int64_t s0, int64_t s1,
                              double sl_lo, double sl_hi) {
  const double dx = __dsub_rn(keys[s1], keys[s0]);
  if (dx <= 0.0) return 0.0;
  double s = __ddiv_rn(static_cast<double>(s1 - s0), dx);
  if (!isfinite(s)) s = 1e300;
  const double hi = isfinite(sl_hi) ? sl_hi : s;
  const double a = sl_lo > s ? sl_lo : s;
  const double b = sl_lo > hi ? sl_lo : hi;
  double m = a;
  if (b < m) m = b;
  if (1e300 < m) m = 1e300;
  return m;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
shrinking_cone_kernel(const double* __restrict__ keys,
                      const int64_t* __restrict__ off, int64_t n_runs,
                      double error, int clamped,
                      uint8_t* __restrict__ is_start,
                      double* __restrict__ slope) {
  const int lane = threadIdx.x % kWarp;
  const int64_t run =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (run >= n_runs) return;  // whole warps leave together
  const int64_t end = off[run + 1];
  int64_t cur = off[run];     // the open segment's origin
  double ox = keys[cur];
  double sl_hi = CUDART_INF, sl_lo = 0.0;
  if (lane == 0) is_start[cur] = 1;
  int64_t pos = cur + 1;
  while (pos < end) {
    const int64_t i = pos + lane;
    const bool valid = i < end;
    double s = CUDART_INF, hc = CUDART_INF, lc = -CUDART_INF;
    bool dup = false, ok = true;
    if (valid) {
      const double dx = __dsub_rn(keys[i], ox);
      const double dy = static_cast<double>(i - cur);
      dup = dx == 0.0;
      if (dup) {
        ok = dy <= error;
      } else {
        s = __ddiv_rn(dy, dx);
        hc = __ddiv_rn(__dadd_rn(dy, error), dx);
        lc = __ddiv_rn(__dsub_rn(dy, error), dx);
      }
    }
    // inclusive prefix min of hi and max of lo over the lanes
    double h_in = hc, l_in = lc;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const double h = __shfl_up_sync(kFull, h_in, d);
      const double l = __shfl_up_sync(kFull, l_in, d);
      if (lane >= d) {
        h_in = fmin(h_in, h);
        l_in = fmax(l_in, l);
      }
    }
    // the cone before this lane's key: carried, narrowed by lanes before
    double h_ex = __shfl_up_sync(kFull, h_in, 1);
    double l_ex = __shfl_up_sync(kFull, l_in, 1);
    if (lane == 0) {
      h_ex = CUDART_INF;
      l_ex = -CUDART_INF;
    }
    const double hi_acc = fmin(sl_hi, h_ex);
    const double lo_acc = fmax(sl_lo, l_ex);
    if (valid && !dup) {
      ok = clamped ? (lc <= hi_acc && hc >= lo_acc)
                   : (lo_acc <= s && s <= hi_acc);
    }
    const unsigned bad = __ballot_sync(kFull, valid && !ok);
    if (bad == 0) {
      sl_hi = fmin(sl_hi, __shfl_sync(kFull, h_in, kWarp - 1));
      sl_lo = fmax(sl_lo, __shfl_sync(kFull, l_in, kWarp - 1));
      pos += kWarp;
      continue;
    }
    const int b = __ffs(bad) - 1;
    const int64_t brk = pos + b;
    const double c_hi = __shfl_sync(kFull, hi_acc, b);
    const double c_lo = __shfl_sync(kFull, lo_acc, b);
    if (lane == 0) {
      if (clamped) slope[cur] = close_slope(keys, cur, brk - 1, c_lo, c_hi);
      is_start[brk] = 1;
    }
    cur = brk;
    ox = keys[cur];
    sl_hi = CUDART_INF;
    sl_lo = 0.0;
    pos = brk + 1;
  }
  if (clamped && lane == 0)
    slope[cur] = close_slope(keys, cur, end - 1, sl_lo, sl_hi);
}

}  // namespace

// Fit runs [off[r], off[r+1]) of keys (r < n_runs; off holds n_runs + 1
// ascending entries, device pointers all).  is_start (one byte a key) must
// be zero on entry; slope (one double a key) is written at each start in
// clamped mode and may be null otherwise.  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() (0 on
// success).
extern "C" int shrinking_cone_launch(const double* keys, const int64_t* off,
                                     int64_t n_runs, double error,
                                     int clamped, uint8_t* is_start,
                                     double* slope, cudaStream_t stream) {
  if (n_runs == 0) return static_cast<int>(cudaGetLastError());
  if (clamped && slope == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  shrinking_cone_kernel<<<static_cast<unsigned>(blocks),
                          kWarp * kWarpsPerBlock, 0, stream>>>(
      keys, off, n_runs, error, clamped, is_start, slope);
  return static_cast<int>(cudaGetLastError());
}
