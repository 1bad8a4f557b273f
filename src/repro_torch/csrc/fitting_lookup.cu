// The FITing-Tree lookup on the card: route, predict, bounded-window search
// and duplicate snap of a batch of f32 queries, fused into one launch
// (fitting_search_launch), plus the window search alone over given window
// starts (fitting_lookup_launch).  Both run the same device code.
//
// Replaces the TPU kernel src/repro/kernels/fitting_lookup.py,
// fitting_lookup_pallas (body _lookup_kernel), together with the XLA work
// that src/repro/index/engine.py runs around it (predict_positions, the
// window clamp, snap_leftmost / snap_side).  Per query q:
//
//   1. route:   sid = clamp(#{i : !(seg_start[i] > q)} - 1, 0, S-1), the
//               upper bound torch.searchsorted(right=True) computes;
//   2. predict: pred = clamp(base + sat(nan0(rint((q - seg_start) * slope))),
//               base, seg_end), f32 product, round half to even, NaN -> 0,
//               saturated at +-2^31 and added in int64, as predict_positions;
//   3. window:  lo = clamp(pred - e, 0, n_pad - W), W = 2e + 2;
//               rank  = lo + #{ j in [lo, lo+W) : key(j) < q }  (<= if right)
//               found = any( j in [lo, lo+W) : key(j) == q )
//               where key(j) = keys[j] for j < n and +inf past the column
//               (the reference's +inf padding to n_pad);
//   4. snap:    left side (and lookup hits): if rank > 0 and
//               keys[min(rank-1, n-1)] == q, rank = lower_bound(keys, q);
//               right side: if rank < n and keys[rank] == q,
//               rank = upper_bound(keys, q), both over the whole column,
//               with torch.searchsorted's comparisons;
//   5. lookup:  out = found ? snapped rank : -1.
//
// Design.  What costs is the 32-byte L2 sectors a query reads: the key
// column (32 MB at n = 2^23) sits in L2, every query reads its own part of
// it, and the card serves a few L2 sectors a nanosecond, whatever the
// bytes used in each.  (A warp serving its 32 queries' windows with probes
// every 32 keys and one coalesced 32-key chunk read some 10 sectors a
// query and ran 0.13 to 0.15 ms at e = 64, slower than the 0.11 ms of a
// whole-column torch.searchsorted; chip_smoke.py, H100 80GB HBM3 at
// 700 W.)  So one thread answers one query and reads as few sectors as it
// can:
//   * Route: a block stages all four segment fields in shared memory when
//     S <= 4096 (64 KB; e >= 64 on the smoke's data), else 8192 samples of
//     seg_start; a thread bisects them there and bisects the entries
//     between two samples in global memory (2 steps in one sector at
//     S < 32k).  Blocks are persistent, so the staging is paid once per
//     block.
//   * Window: a bisection over sector boundaries.  Each step reads the
//     last key of one sector, log2(W / 8) steps in all, until the rank is
//     bracketed inside one sector, which is read whole (two aligned
//     float4s) and counted.  The sector of the last step is mostly the one
//     read last, an L1 hit.  It relies on the column being sorted; the
//     count then equals the twin's count over the whole window, and an
//     equal key, if the window has one, is the one at the rank (left) or
//     just before it (right), both known from the reads.
//   * Snap, on the device: with the window sorted, a counted key never
//     equals q, so a duplicate run reaches past the window only where the
//     rank sits on the window's edge and the key just beyond it equals q.
//     There, and only there (rare), the thread reads that key and bisects
//     the column's side of the rank: no host sync, no second launch.
//
// Sectors a query reads: the query and the result (coalesced, 8 bytes);
// the route, none when the fields are staged, else 1 plus the 4 field
// sectors; the window, log2(W / 8) + 1 at most: e = 16 (W = 34) 3 to 4,
// e = 64 (W = 130) 5 to 6, e = 256 (W = 514) 7 to 8.  At e = 64 that is
// about 6 sectors (192 B), against about 10 for a whole-column
// torch.searchsorted's 23 dependent reads (its upper levels are shared by
// all queries and stay in L1).
//
// What bounds it on an H100: the work's bytes are Q*(4+4) of queries and
// results plus the key column read once (4n bytes; 32 MB at n = 2^23,
// which fits the 50 MB L2), so the bound is bytes; the kernel itself is
// held by the L2 sectors above; its dependent reads (log2(W / 8) + 2)
// are hidden by the thousand or so queries each SM keeps in flight.
//
// Precondition: keys ascending, no NaN (what a SegmentTable holds).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 512;
constexpr int kStageFields = 4096;        // stage all four fields up to S
constexpr int kSamples = 8192;            // else this many seg_start samples

enum Mode { kLookup = 0, kSearchLeft = 1, kSearchRight = 2 };

// key(j): the column, +inf past its end (the reference's padding).
__device__ __forceinline__ float key_at(const float* __restrict__ keys,
                                        int64_t n, int64_t j) {
  return j < n ? __ldg(keys + j) : CUDART_INF_F;
}

template <bool kRight>
__device__ __forceinline__ bool below(float k, float q) {
  return kRight ? (k <= q) : (k < q);
}

// The window search over [lo, lo + w) for one query, a 32-byte sector at a
// time.  r, the first index of the window whose key is not below q (lo + w
// if none), is bracketed in [a, b]; each step reads the last key of the
// sector before a sector boundary m inside (a, b) and keeps the side r is
// on, until [a, b) lies in one sector, which is then read (two aligned
// float4s, one sector) and counted.  The keys read next to the bracket,
// key(a-1) and key(b), are kept: they decide `found` where r sits on the
// bracket's edge.  Relies on the window being sorted (see above).
template <bool kRight>
__device__ __forceinline__ void window_rank(const float* __restrict__ keys,
                                            int64_t n, float q, int64_t lo,
                                            int w, int64_t& rank,
                                            bool& found) {
  const int64_t hi = lo + w;
  int64_t a = lo, b = hi;
  float ka = CUDART_NAN_F, kb = CUDART_NAN_F;  // key(a-1), key(b) once read
  while (b > a && (a >> 3) != ((b - 1) >> 3)) {
    int64_t m = ((a + b) >> 1) & ~int64_t(7);
    if (m <= a) m += 8;
    const float x = key_at(keys, n, m - 1);
    if (below<kRight>(x, q)) {
      a = m;
      ka = x;
    } else {
      b = m - 1;
      kb = x;
    }
  }
  // [a, b) within one sector: read it whole.
  const int64_t f = a & ~int64_t(7);
  float v[8];
  const bool aligned = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  if (b > a && aligned && f + 7 < n) {
    const float4* p = reinterpret_cast<const float4*>(keys + f);
    const float4 v0 = __ldg(p), v1 = __ldg(p + 1);
    v[0] = v0.x, v[1] = v0.y, v[2] = v0.z, v[3] = v0.w;
    v[4] = v1.x, v[5] = v1.y, v[6] = v1.z, v[7] = v1.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = b > a ? key_at(keys, n, f + i) : CUDART_NAN_F;
  }
  int cnt = 0;
  float at_r = kb, before_r = ka;  // key(r), key(r-1) where r is an edge
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t j = f + i;
    if (j >= a && j < b && below<kRight>(v[i], q)) ++cnt;
  }
  rank = a + cnt;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t j = f + i;
    if (j >= a && j < b) {
      if (j == rank) at_r = v[i];
      if (j == rank - 1) before_r = v[i];
    }
  }
  // An equal key lies in the window only next to r: key(r) on the left
  // (not below, the first such), key(r-1) on the right (the last below).
  found = kRight ? (rank > lo && before_r == q) : (rank < hi && at_r == q);
}

// The first index in [a, b) at which !(arr[i] > q) (kUpper) or
// !(arr[i] >= q) stops holding, a prefix of sorted arr: torch.searchsorted's
// comparisons, so a NaN query goes to b like there.
template <bool kUpper>
__device__ int64_t bound(const float* __restrict__ arr, int64_t a, int64_t b,
                         float q) {
  while (a < b) {
    const int64_t mid = a + ((b - a) >> 1);
    const float x = __ldg(arr + mid);
    if (kUpper ? !(x > q) : !(x >= q)) a = mid + 1; else b = mid;
  }
  return a;
}

struct Index {
  const float* seg_start;
  const float* slope;
  const int32_t* base;
  const int32_t* seg_end;
  int64_t s;
  const float* keys;
  int64_t n;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
fitting_search_kernel(const Index ix, const float* __restrict__ queries,
                      int64_t nq, int error, int64_t n_pad,
                      int32_t* __restrict__ out) {
  constexpr bool kRight = kMode == kSearchRight;
  extern __shared__ float smem[];
  // Shared memory: all four segment fields when S <= kStageFields (then
  // the route and the fields never touch global memory), else kSamples
  // samples of seg_start, every stride-th.
  const bool staged = ix.s <= kStageFields;
  const int64_t stride = staged ? 1 : (ix.s + kSamples - 1) / kSamples;
  const int m = static_cast<int>((ix.s + stride - 1) / stride);
  float* s_start = smem;
  float* s_slope = smem + m;
  int32_t* s_base = reinterpret_cast<int32_t*>(smem + 2 * m);
  int32_t* s_end = s_base + m;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    s_start[i] = __ldg(ix.seg_start + i * stride);
    if (staged) {
      s_slope[i] = __ldg(ix.slope + i);
      s_base[i] = __ldg(ix.base + i);
      s_end[i] = __ldg(ix.seg_end + i);
    }
  }
  __syncthreads();

  const int w = 2 * error + 2;
  const int64_t lo_max = n_pad - w;
  for (int64_t qi = int64_t(blockIdx.x) * kThreads + threadIdx.x; qi < nq;
       qi += int64_t(gridDim.x) * kThreads) {
    const float q = __ldg(queries + qi);
    // 1. route: the samples in shared memory, then the entries between two
    //    samples in global memory.
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!(s_start[mid] > q)) lo = mid + 1; else hi = mid;
    }
    int64_t cnt = lo;
    if (stride > 1 && lo > 0)
      cnt = bound<true>(ix.seg_start, (lo - 1) * stride + 1,
                        min(int64_t(lo) * stride, ix.s), q);
    const int64_t sid = min(max(cnt - 1, int64_t(0)), ix.s - 1);
    // 2. predict, as predict_positions does.
    float s0, slope;
    int64_t base, end;
    if (staged) {
      s0 = s_start[sid], slope = s_slope[sid];
      base = s_base[sid], end = s_end[sid];
    } else {
      s0 = __ldg(ix.seg_start + sid), slope = __ldg(ix.slope + sid);
      base = __ldg(ix.base + sid), end = __ldg(ix.seg_end + sid);
    }
    float local = rintf(__fmul_rn(__fsub_rn(q, s0), slope));
    if (isnan(local)) local = 0.0f;
    local = fminf(fmaxf(local, -2147483648.0f), 2147483648.0f);
    const int64_t pred =
        min(max(base + static_cast<int64_t>(local), base), end);
    // 3. the window.
    const int64_t wlo = min(max(pred - error, int64_t(0)), lo_max);
    int64_t rank;
    bool found;
    window_rank<kRight>(ix.keys, ix.n, q, wlo, w, rank, found);
    // 4. snap.  With the window sorted, a counted neighbour never equals q,
    //    so the run extends past the window only where the rank sits on
    //    its edge and the key beyond it equals q.
    if (kRight) {
      if (rank == wlo + w && rank < ix.n && __ldg(ix.keys + rank) == q)
        rank = bound<true>(ix.keys, rank + 1, ix.n, q);
    } else if (kMode == kSearchLeft || found) {
      if (rank == wlo && rank > 0 && __ldg(ix.keys + rank - 1) == q)
        rank = bound<false>(ix.keys, 0, rank, q);
    }
    out[qi] = static_cast<int32_t>(kMode == kLookup && !found ? -1 : rank);
  }
}

template <bool kRight>
__global__ void __launch_bounds__(kThreads)
fitting_lookup_kernel(const float* __restrict__ keys, int64_t n,
                      const float* __restrict__ queries,
                      const int32_t* __restrict__ qlo, int64_t nq,
                      int32_t window, int32_t* __restrict__ rank,
                      bool* __restrict__ found) {
  const int64_t qi = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (qi >= nq) return;
  int64_t r;
  bool f;
  window_rank<kRight>(keys, n, __ldg(queries + qi), __ldg(qlo + qi), window,
                      r, f);
  rank[qi] = static_cast<int32_t>(r);
  found[qi] = f;
}

// What a persistent grid is sized from on one device: its SM count and, for
// each size class (samples staged, fields staged), the blocks an SM holds.
// Both belong to a device, as does the kernel's opt-in to more than 48 KB
// of dynamic shared memory, so each device asks once, under a lock (the
// launchers may be called from several host threads), and a failed ask is
// asked again at the next launch.
struct Occupancy {
  int sms = 0;              // 0 until asked
  int per_sm[2] = {0, 0};
};
constexpr int kMaxDevices = 64;

template <int kMode>
cudaError_t occupancy(Occupancy& out) {
  static std::mutex mu;
  static Occupancy occ[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Occupancy& o = occ[dev];
  if (o.sms == 0) {
    Occupancy fresh;
    err = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fitting_search_kernel<kMode>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStageFields * 16);
    for (int staged = 0; staged < 2 && err == cudaSuccess; ++staged) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fresh.per_sm[staged], fitting_search_kernel<kMode>, kThreads,
          staged ? kStageFields * 16 : kSamples * 4);
      if (fresh.per_sm[staged] < 1) fresh.per_sm[staged] = 1;
    }
    if (err != cudaSuccess) return err;
    o = fresh;
  }
  out = o;
  return cudaSuccess;
}

// Persistent grid: as many blocks as stay resident at once on the current
// device (its SM count times the blocks an SM holds at this shared-memory
// size class), at most one a thread per query.
template <int kMode>
int launch_search(const Index& ix, const float* queries, int64_t nq, int e,
                  int64_t n_pad, int32_t* out, cudaStream_t st) {
  Occupancy occ;
  const cudaError_t err = occupancy<kMode>(occ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool staged = ix.s <= kStageFields;
  const int64_t stride = (ix.s + kSamples - 1) / kSamples;
  const int smem = static_cast<int>(
      staged ? ix.s * 16 : (ix.s + stride - 1) / stride * 4);
  const int64_t want = (nq + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(occ.sms) * occ.per_sm[staged];
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  fitting_search_kernel<kMode><<<grid, kThreads, smem, st>>>(ix, queries, nq,
                                                             e, n_pad, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The window search alone over given window starts qlo (a thread a query).
// Launches on `stream` without synchronising and allocates nothing; returns
// cudaGetLastError() (0 on success).  All pointers are device pointers.
extern "C" int fitting_lookup_launch(const float* keys, int64_t n,
                                     const float* queries,
                                     const int32_t* qlo, int64_t nq,
                                     int64_t window, int side_right,
                                     int32_t* rank, bool* found,
                                     void* stream) {
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((nq + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t w = static_cast<int32_t>(window);
  if (side_right) {
    fitting_lookup_kernel<true><<<grid, kThreads, 0, s>>>(keys, n, queries,
                                                          qlo, nq, w, rank,
                                                          found);
  } else {
    fitting_lookup_kernel<false><<<grid, kThreads, 0, s>>>(keys, n, queries,
                                                           qlo, nq, w, rank,
                                                           found);
  }
  return static_cast<int>(cudaGetLastError());
}

// The whole lookup in one launch.  mode: 0 lookup (rank or -1), 1 search
// left, 2 search right.  out is int32[nq].  Needs s >= 1, n >= 1 and
// n_pad >= max(n, 2*error + 2).  Launches on `stream` without synchronising
// and allocates nothing; returns cudaGetLastError() (0 on success).
extern "C" int fitting_search_launch(const float* seg_start,
                                     const float* slope,
                                     const int32_t* base,
                                     const int32_t* seg_end, int64_t s,
                                     const float* keys, int64_t n,
                                     const float* queries, int64_t nq,
                                     int64_t error, int64_t n_pad, int mode,
                                     int32_t* out, void* stream) {
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  if (s < 1 || n < 1 || error < 0 || n_pad < n || n_pad < 2 * error + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Index ix{seg_start, slope, base, seg_end, s, keys, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = static_cast<int>(error);
  switch (mode) {
    case kLookup:
      return launch_search<kLookup>(ix, queries, nq, e, n_pad, out, st);
    case kSearchLeft:
      return launch_search<kSearchLeft>(ix, queries, nq, e, n_pad, out, st);
    case kSearchRight:
      return launch_search<kSearchRight>(ix, queries, nq, e, n_pad, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
