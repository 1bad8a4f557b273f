// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + u_t, run over time
// independently for every (batch, channel): the prefill scan of each
// RecurrentGemma recurrent block.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py,
// rglru_scan_pallas (body _rglru_kernel).  Inputs u, a are (B, T, W) f32,
// contiguous; h0 is (B, W) f32 or null (zeros).  Outputs: every state h
// (B, T, W) and the last one (B, W), both f32.  With T = 0, h_last = h0.
//
// The TPU kernel tiled channels into 128-lane blocks (grid (B, W/128)) and
// kept a (T, 128) tile of a and u resident in VMEM while a fori_loop walked
// time.  Blocks on Hopper cannot hold a whole (T, 128) tile, and the time
// chain is sequential per channel, so here a channel's state stays in one
// thread's register for all of T and the tiles stream past it.
//
// What bounds it on an H100: bytes.  It must read u and a and write h once,
// plus h0 and h_last: 3*B*T*W*4 + 2*B*W*4 bytes, 0.2404 ms at B = 4,
// T = W = 4096 and 0.0451 ms at B = 1, T = 3072, W = 4096 (the batcher's
// prefill) at 3.35 TB/s.  The arithmetic is 2 flops a step; one warp's
// chain of 4096 dependent multiply-adds takes about 25 us.
//
// Two kernels:
//
// 1. rglru_scan_tma_kernel (the TMA path), where TMA can read the inputs: a
//    16-byte aligned base and row stride, so W % 4 == 0, and T > 0.  The
//    first design (2 below) gives one thread to each (batch, channel), grid
//    (ceil(W/128), B): at the headline shape that is about one block of 128
//    threads an SM with 32 loads of 4 bytes in flight each, 16 KB an SM,
//    several times too little to keep HBM busy, so it is bound by latency
//    (about half its bound); at B = 1 its 32 blocks leave 100 of the 132
//    SMs idle.  The design against that:
//    * the tile: a block owns C = 32 * kConsumerWarps channels of one batch
//      row, so the grid ceil(W/C) x B is 128 blocks at B = 1, W = 4096
//      (C = 32) and 512 at B = 4;
//    * the ring: kStages stages in dynamic shared memory, each holding the
//      (kTileT, C) tiles of a and u, fed by one elected thread of a
//      producer warp through 3-D tensor maps over (W, T, B) (boxes of C x
//      kTileT x 1, unswizzled: a lane reads one float of a 128-byte row,
//      conflict-free) with full / empty mbarriers and expect_tx.  A block
//      keeps up to kStages * 2 * kTileT * C * 4 bytes of loads in flight:
//      48 KB at kTileT 64, kStages 3.  With the two output tiles a block
//      takes 64 KB of shared memory, so at B = 1 an SM holds one block
//      (48 KB of loads in flight) and at B = 4 three (144 KB).
//      Out-of-range boxes zero-fill (a ragged T, a W that is not a
//      multiple of C); the consumer never steps past T;
//    * the consumer: each warp owns 32 neighbouring channels, one a lane.
//      It copies a whole tile of a and u into registers, releases the
//      stage at once, then walks the tile in time order with h in a
//      register.  Reading the tile step by step instead left each shared
//      load behind the previous step's store (the compiler cannot tell
//      them apart), which measured far slower at B = 1;
//    * the output: each step's h goes into an output tile in shared
//      memory (two, alternating), and one thread TMA-stores a finished
//      tile (clipped at T and W) while the next one fills.  The
//      alternative, one coalesced 128-byte st.global a warp a step, was
//      measured slower at B = 1, where each SM has a single consumer warp
//      and every store stalls it, and no faster at B = 4.
//    The tile (64 steps x 32 channels), the 3 stages and the TMA store
//    were chosen by measurement on an NVIDIA H100 80GB HBM3 at 700 W:
//    neither 2 nor 4 stages, nor 32-step tiles, was faster at both
//    shapes; 64-channel tiles were level at B = 1 and faster at B = 4, but
//    halve the grid at B = 1, so narrower widths would leave SMs idle.
//    chip_smoke.py times the kept design at both shapes, beside the
//    first design (2 below) on the same inputs.
//
// 2. rglru_scan_unaligned_kernel (the unaligned path), for every other
//    input (any W, any base): the first design.  One thread owns one
//    (batch, channel); a warp's 32 threads are 32 neighbouring channels, so
//    every load and store of a time step is one coalesced access.  Each
//    thread issues the loads of kUnroll steps before the kUnroll dependent
//    multiply-adds that use them.
//
// A chunked two-pass scan (parallel over time chunks, then a carry fix-up)
// was not built: it computes h = local + A_prefix * carry, which rounds in
// another order than the sequential twin, and it reads a and u twice.
//
// Rounding, both kernels: each step is a product rounded to f32, then a sum
// rounded to f32 (__fmul_rn / __fadd_rn, never contracted into an FMA), in
// time order, exactly as the sequential plain twin computes it, so the
// kernels and the twin agree bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC.  Plain C interface, loaded with ctypes; the
//        driver's cuTensorMapEncodeTiled is reached through
//        cudaGetDriverEntryPoint, so nothing links -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ------------------------------------------------------- the unaligned path
constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_unaligned_kernel(const float* __restrict__ u,
                            const float* __restrict__ a,
                            const float* __restrict__ h0, int64_t t_len,
                            int64_t w, float* __restrict__ h_out,
                            float* __restrict__ h_last) {
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

// ------------------------------------------------------------ the TMA path
constexpr int kTileT = 64;                     // time steps a tile
constexpr int kStages = 3;                     // tiles of a and u in flight
constexpr int kConsumerWarps = 1;
constexpr int kTileC = 32 * kConsumerWarps;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kTmaThreads = kConsumers + 32;            // + the producer warp
constexpr int kTileFloats = kTileT * kTileC;
constexpr int kTileBytes = kTileFloats * 4;
// the ring, two output tiles, and room to align the ring to 128 bytes
constexpr int kSmemBytes = (2 * kStages + 2) * kTileBytes + 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.  A wait
// that outlasts any valid schedule (2^26 tries, seconds) is a fault: trap,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// One box from shared memory out through a 3-D tensor map (clipped at the
// tensor's edges), in this thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The consumer warps alone (named barrier 1; the producer warp has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Block (x, y): channels [x*C, x*C + C) of batch row y.  Warps 0 ..
// kConsumerWarps-1 consume, the last warp produces.
__global__ void __launch_bounds__(kTmaThreads)
rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap map_u,
                      const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_h,
                      const float* __restrict__ h0, int t_len, int w,
                      float* __restrict__ h_last) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  auto tile_a = [&](int s) { return ring + (2 * s) * kTileFloats; };
  auto tile_u = [&](int s) { return ring + (2 * s + 1) * kTileFloats; };

  const int warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * kTileC;
  const int b = blockIdx.y;
  const int n_tiles = (t_len + kTileT - 1) / kTileT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                  // the producer warp
    if (threadIdx.x % 32 == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load(&map_a, tile_a(s), &full[s], c0, i * kTileT, b);
        tma_load(&map_u, tile_u(s), &full[s], c0, i * kTileT, b);
      }
    }
    return;
  }

  const int cl = threadIdx.x;                    // the channel in the tile
  const int c = c0 + cl;
  const bool live = c < w;
  float h = (h0 != nullptr && live) ? h0[int64_t(b) * w + c] : 0.0f;
  float* out_ring = ring + 2 * kStages * kTileFloats;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int t0 = i * kTileT;
    const int steps = min(kTileT, t_len - t0);
    float* so = out_ring + (i % 2) * kTileFloats;
    if (i >= 2) {
      // the store issued from this slot two tiles ago has read it
      if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      consumer_sync();
    }
    mbar_wait(&full[s], (i / kStages) & 1);
    const float* ta = tile_a(s) + cl;
    const float* tu = tile_u(s) + cl;
    if (steps == kTileT) {
      // The whole tile into registers first: the stores below may alias
      // shared memory as far as the compiler knows, so loads written after
      // them would wait on them; and the stage is released a tile early.
      float av[kTileT], uv[kTileT];
#pragma unroll
      for (int j = 0; j < kTileT; ++j) {
        av[j] = ta[j * kTileC];
        uv[j] = tu[j * kTileC];
      }
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < kTileT; ++j) {
        h = __fadd_rn(__fmul_rn(av[j], h), uv[j]);
        so[j * kTileC + cl] = h;
      }
    } else {                                     // the ragged last tile
      for (int j = 0; j < steps; ++j) {
        h = __fadd_rn(__fmul_rn(ta[j * kTileC], h), tu[j * kTileC]);
        so[j * kTileC + cl] = h;
      }
      mbar_arrive(&empty[s]);
    }
    // the tile's generic-proxy writes made visible to the TMA store
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    if (threadIdx.x == 0) {
      tma_store(&map_h, so, c0, t0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (live) h_last[int64_t(b) * w + c] = h;
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------- host: TMA maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A contiguous (B, T, W) f32 tensor as a 3-D map over (W, T, B), innermost
// first, boxes of kTileC x kTileT x 1, unswizzled, zero fill past the edges.
bool make_map(CUtensorMap* map, const float* ptr, int64_t b, int64_t t_len,
              int64_t w) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(w), cuuint64_t(t_len), cuuint64_t(b)};
  const cuuint64_t strides[2] = {cuuint64_t(w) * 4, cuuint64_t(t_len * w) * 4};
  const cuuint32_t box[3] = {kTileC, kTileT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Both launchers run on `stream` without synchronising and allocate
// nothing; all pointers are device pointers, h0 may be null.  They return a
// CUDA error code (0 on success).

// The unaligned path: any W, any base.
extern "C" int rglru_scan_unaligned_launch(const float* u, const float* a,
                                           const float* h0, int64_t b,
                                           int64_t t_len, int64_t w,
                                           float* h_out, float* h_last,
                                           cudaStream_t stream) {
  if (b <= 0 || w <= 0 || t_len < 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  rglru_scan_unaligned_kernel<<<grid, kThreads, 0, stream>>>(
      u, a, h0, t_len, w, h_out, h_last);
  return static_cast<int>(cudaGetLastError());
}

// The TMA path: W % 4 == 0, T > 0, and u, a, h_out 16-byte aligned (the
// wrapper's scan_path checks it), or cudaErrorInvalidValue; or
// kTensorMapError if the driver could not encode a tensor map.
constexpr int kTensorMapError = 1000;

extern "C" int rglru_scan_tma_launch(const float* u, const float* a,
                                     const float* h0, int64_t b,
                                     int64_t t_len, int64_t w, float* h_out,
                                     float* h_last, cudaStream_t stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (b <= 0 || w <= 0 || t_len <= 0 || b > 65535 || w % 4 != 0 ||
      t_len > INT32_MAX || w > INT32_MAX || misaligned(u) || misaligned(a) ||
      misaligned(h_out))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mu, ma, mh;
  if (!make_map(&mu, u, b, t_len, w) || !make_map(&ma, a, b, t_len, w) ||
      !make_map(&mh, h_out, b, t_len, w))
    return kTensorMapError;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rglru_scan_tma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((w + kTileC - 1) / kTileC),
                  static_cast<unsigned>(b));
  rglru_scan_tma_kernel<<<grid, kTmaThreads, kSmemBytes, stream>>>(
      mu, ma, mh, h0, static_cast<int>(t_len), static_cast<int>(w), h_last);
  return static_cast<int>(cudaGetLastError());
}
