// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + u_t, run over time
// independently for every (batch, channel): the prefill scan of each
// RecurrentGemma recurrent block.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py,
// rglru_scan_pallas (body _rglru_kernel).  Inputs u, a are (B, T, W) f32,
// contiguous; h0 is (B, W) f32 or null (zeros).  Outputs: every state h
// (B, T, W) and the last one (B, W), both f32.
//
// The TPU kernel tiled channels into 128-lane blocks (grid (B, W/128)) and
// kept a (T, 128) tile of a and u resident in VMEM while a fori_loop walked
// time.  Here one thread owns one (batch, channel) and keeps its state in a
// register; a warp's 32 threads are 32 neighbouring channels, so every load
// and store of a time step is one coalesced 128-byte access.  Any W works:
// the Pallas kernel's W % 128 == 0 was a TPU tiling limit.
//
// What bounds it on an H100: it must read u and a and write h once,
// 3*B*T*W*4 bytes (0.8 GB at B = 4, T = W = 4096: 0.24 ms at 3.35 TB/s).
// But there are only B*W threads (16k at B = 4, W = 4096: about one block
// of 128 per SM), each walking T dependent steps, so it is bound by memory
// latency, not bandwidth.  The design issues the loads of kUnroll steps
// before the kUnroll dependent multiply-adds that use them, so each thread
// keeps 2*kUnroll loads in flight.  A chunked two-pass scan (parallel over
// time chunks, then a carry fix-up) would fill the card; that is later work.
//
// Rounding: each step is a product rounded to f32, then a sum rounded to
// f32 (__fmul_rn / __fadd_rn, never contracted into an FMA), exactly as the
// sequential plain twin computes it, so the two agree bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ u, const float* __restrict__ a,
                  const float* __restrict__ h0, int64_t t_len, int64_t w,
                  float* __restrict__ h_out, float* __restrict__ h_last) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (c >= w) return;
  const int64_t base = b * t_len * w + c;
  float h = h0 != nullptr ? h0[b * w + c] : 0.0f;
  int64_t t = 0;
  for (; t + kUnroll <= t_len; t += kUnroll) {
    float av[kUnroll];
    float uv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t off = base + (t + i) * w;
      av[i] = __ldg(a + off);
      uv[i] = __ldg(u + off);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), uv[i]);
      h_out[base + (t + i) * w] = h;
    }
  }
  for (; t < t_len; ++t) {
    const int64_t off = base + t * w;
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(u + off));
    h_out[off] = h;
  }
  h_last[b * w + c] = h;
}

}  // namespace

// Launches on `stream` without synchronising and allocates nothing; returns
// cudaGetLastError() (0 on success).  All pointers are device pointers;
// h0 may be null.
extern "C" int rglru_scan_launch(const float* u, const float* a,
                                 const float* h0, int64_t b, int64_t t_len,
                                 int64_t w, float* h_out, float* h_last,
                                 cudaStream_t stream) {
  if (b <= 0 || w <= 0 || t_len < 0 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  rglru_scan_kernel<<<grid, kThreads, 0, stream>>>(u, a, h0, t_len, w, h_out,
                                                   h_last);
  return static_cast<int>(cudaGetLastError());
}
