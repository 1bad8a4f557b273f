// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + u_t, run over time
// independently for every (batch, channel): the prefill scan of each
// RecurrentGemma recurrent block, and its gradient, the same recurrence run
// backwards in time (kernels 3 and 4 below).
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
// Two forward kernels (the backward's two are 3 and 4 below):
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
// The backward: RGLRUScan's gradient (the reference's custom VJP,
// src/repro/models/blocks.py _rglru_scan_bwd, which runs XLA's reverse
// associative scan; there is no Pallas kernel to port).  From gacc_T = 0,
// for t from T-1 down to 0:
//
//     gacc_t = a_{t+1} * gacc_{t+1} + g_t      (a_T taken as 1)
//     du_t   = gacc_t,   da_t = gacc_t * h_{t-1}   (h_{-1} = 0)
//
// with g, a, h (B, T, W) f32 in and du, da (B, T, W) f32 out.  It must read
// g, a, h and write du, da once: 5*B*T*W*4 bytes, 0.4006 ms at B = 4,
// T = W = 4096 and 0.1002 ms at B = 2, T = 2048, W = 4096 (a training
// step of recurrentgemma-9b) at 3.35 TB/s; bytes bound it.  Run as the
// forward kernel on time-flipped inputs, with the flips, cats and product
// around it in torch ops, it makes about 17 passes over B*T*W*4 bytes.
//
// 3. rglru_scan_bwd_tma_kernel mirrors the forward's TMA design with its
//    own ring: a block owns 32 channels of one batch row and walks the time
//    tiles [i*64, i*64 + 64) from the last to the first, so the ragged tile
//    comes first.  Each stage holds three boxes of the same tile, loaded
//    with shifted time coordinates: g at t0, a at t0 + 1 (so row j is
//    a_{t+1}) and h at t0 - 1 (so row j is h_{t-1}).  Box coordinates are
//    signed and rows outside [0, T) zero-fill, which removes the flips, the
//    cats and every temporary:
//    * the h row at -1 reads 0, the twin's h_{-1};
//    * the a row at T reads 0 where the twin takes 1.  That is bit-equal:
//      gacc_T = +0, and 0 * (+0) = 1 * (+0) = +0, so gacc_{T-1} = +0 + g.
//    The consumer warp copies a full tile of g and a_next into registers,
//    runs the tile's 64 steps in descending time with gacc in a register,
//    then reads h_prev, releases the stage and writes du and da into one of
//    two alternating pairs of output tiles, which one thread TMA-stores
//    (clipped at T and W) while the next tile runs.  Shared memory:
//    kBwdStages * 3 input tiles + 4 output tiles of 8 KB, 104 KB at 3
//    stages, so two blocks fit an SM; the grid ceil(W/32) x B is 256 blocks
//    at B = 2, W = 4096, one wave of two blocks an SM.  The ring's depth
//    and the tile's length were measured by tools/tune_rglru_backward.py on
//    an NVIDIA H100 80GB HBM3 at 700 W at both shapes above: 2, 3 and 4
//    stages of 64-step tiles within 1 % of each other, 32-step tiles 3 to
//    6 % slower at B = 4 and level at B = 2.  Wider tiles are not tried:
//    64 channels would leave SMs idle at B = 2.
//
// 4. rglru_scan_bwd_unaligned_kernel, for every input TMA cannot read (W %
//    4 != 0, a base off 16 bytes): a thread a (batch, channel), walking time
//    downward and issuing kUnroll steps of loads before their dependent
//    multiply-adds, as the forward's unaligned kernel does.
//
// Rounding, all four kernels: each step is a product rounded to f32, then
// a sum rounded to f32 (__fmul_rn / __fadd_rn, never contracted into an
// FMA), in time order (descending for the backward), exactly as the
// sequential plain twins compute it, and da is one __fmul_rn, so the
// kernels and the twins agree bit for bit.
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

// ----------------------------------------------- the backward, unaligned
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_unaligned_kernel(const float* __restrict__ g,
                                const float* __restrict__ a,
                                const float* __restrict__ h, int64_t t_len,
                                int64_t w, float* __restrict__ du,
                                float* __restrict__ da) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (c >= w) return;
  const int64_t base = b * t_len * w + c;
  float acc = 0.0f;                              // gacc_{t+1}, from gacc_T = 0
  int64_t t = t_len;                             // steps [t, T) are done
  for (; t >= kUnroll; t -= kUnroll) {
    float gv[kUnroll], an[kUnroll], hp[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t s = t - 1 - i;
      const int64_t off = base + s * w;
      gv[i] = __ldg(g + off);
      an[i] = s + 1 < t_len ? __ldg(a + off + w) : 1.0f;
      hp[i] = s > 0 ? __ldg(h + off - w) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t off = base + (t - 1 - i) * w;
      acc = __fadd_rn(__fmul_rn(an[i], acc), gv[i]);
      du[off] = acc;
      da[off] = __fmul_rn(acc, hp[i]);
    }
  }
  for (; t > 0; --t) {
    const int64_t s = t - 1;
    const int64_t off = base + s * w;
    const float an = s + 1 < t_len ? __ldg(a + off + w) : 1.0f;
    const float hp = s > 0 ? __ldg(h + off - w) : 0.0f;
    acc = __fadd_rn(__fmul_rn(an, acc), __ldg(g + off));
    du[off] = acc;
    da[off] = __fmul_rn(acc, hp);
  }
}

// ----------------------------------------------------- the backward, TMA
constexpr int kBwdStages = 3;                  // stages of (g, a_next, h_prev)
// the ring, two pairs of output tiles (du, da), room to align the ring
constexpr int kBwdSmemBytes = (3 * kBwdStages + 4) * kTileBytes + 128;

// Block (x, y): channels [x*C, x*C + C) of batch row y, time tiles from the
// last to the first.  Warp 0 consumes, warp 1 produces.
__global__ void __launch_bounds__(kTmaThreads)
rglru_scan_bwd_tma_kernel(const __grid_constant__ CUtensorMap map_g,
                          const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_h,
                          const __grid_constant__ CUtensorMap map_du,
                          const __grid_constant__ CUtensorMap map_da,
                          int t_len) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kBwdStages], empty[kBwdStages];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  // tile k of stage s: 0 g, 1 a_next, 2 h_prev
  auto tile = [&](int s, int k) { return ring + (3 * s + k) * kTileFloats; };

  const int warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * kTileC;
  const int b = blockIdx.y;
  const int n_tiles = (t_len + kTileT - 1) / kTileT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                  // the producer warp
    if (threadIdx.x % 32 == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % kBwdStages;
        const int t0 = (n_tiles - 1 - k) * kTileT;
        mbar_wait(&empty[s], ((k / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 3 * kTileBytes);
        tma_load(&map_g, tile(s, 0), &full[s], c0, t0, b);
        // rows past T-1 and before 0 zero-fill: a_T reads 0, h_{-1} 0
        tma_load(&map_a, tile(s, 1), &full[s], c0, t0 + 1, b);
        tma_load(&map_h, tile(s, 2), &full[s], c0, t0 - 1, b);
      }
    }
    return;
  }

  const int cl = threadIdx.x;                    // the channel in the tile
  float acc = 0.0f;                              // gacc_{t+1}, from gacc_T = 0
  float* out_ring = ring + 3 * kBwdStages * kTileFloats;
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kBwdStages;
    const int t0 = (n_tiles - 1 - k) * kTileT;
    const int steps = min(kTileT, t_len - t0);
    float* so_du = out_ring + (2 * (k % 2)) * kTileFloats;
    float* so_da = so_du + kTileFloats;
    if (k >= 2) {
      // the stores issued from this pair two tiles ago have read it
      if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      consumer_sync();
    }
    mbar_wait(&full[s], (k / kBwdStages) & 1);
    const float* tg = tile(s, 0) + cl;
    const float* ta = tile(s, 1) + cl;
    const float* th = tile(s, 2) + cl;
    if (steps == kTileT) {
      // g and a_next into registers, the tile's chain in registers (gv
      // becomes gacc), then h_prev into av; no shared load follows a
      // shared store, and the stage is released before the stores.
      float gv[kTileT], av[kTileT];
#pragma unroll
      for (int j = 0; j < kTileT; ++j) {
        gv[j] = tg[j * kTileC];
        av[j] = ta[j * kTileC];
      }
#pragma unroll
      for (int j = kTileT - 1; j >= 0; --j) {
        acc = __fadd_rn(__fmul_rn(av[j], acc), gv[j]);
        gv[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < kTileT; ++j) av[j] = th[j * kTileC];
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < kTileT; ++j) {
        so_du[j * kTileC + cl] = gv[j];
        so_da[j * kTileC + cl] = __fmul_rn(gv[j], av[j]);
      }
    } else {                                     // the ragged tile, first
      for (int j = steps - 1; j >= 0; --j) {
        acc = __fadd_rn(__fmul_rn(ta[j * kTileC], acc), tg[j * kTileC]);
        so_du[j * kTileC + cl] = acc;
        so_da[j * kTileC + cl] = __fmul_rn(acc, th[j * kTileC]);
      }
      mbar_arrive(&empty[s]);
    }
    // the tiles' generic-proxy writes made visible to the TMA stores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    if (threadIdx.x == 0) {
      tma_store(&map_du, so_du, c0, t0, b);
      tma_store(&map_da, so_da, c0, t0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
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
  // The runtime calls first: they make the device's primary context
  // current on this thread, which encoding a tensor map needs (a thread
  // whose first CUDA work is this launch, as autograd's may be, has none).
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rglru_scan_tma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mu, ma, mh;
  if (!make_map(&mu, u, b, t_len, w) || !make_map(&ma, a, b, t_len, w) ||
      !make_map(&mh, h_out, b, t_len, w))
    return kTensorMapError;
  const dim3 grid(static_cast<unsigned>((w + kTileC - 1) / kTileC),
                  static_cast<unsigned>(b));
  rglru_scan_tma_kernel<<<grid, kTmaThreads, kSmemBytes, stream>>>(
      mu, ma, mh, h0, static_cast<int>(t_len), static_cast<int>(w), h_last);
  return static_cast<int>(cudaGetLastError());
}

// The backward's launchers: g, a, h in, du, da out, all (B, T, W) f32 on
// the device; T > 0 (the wrapper launches nothing for an empty input).
// The unaligned path: any W, any base.
extern "C" int rglru_scan_bwd_unaligned_launch(const float* g, const float* a,
                                               const float* h, int64_t b,
                                               int64_t t_len, int64_t w,
                                               float* du, float* da,
                                               cudaStream_t stream) {
  if (b <= 0 || w <= 0 || t_len <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  rglru_scan_bwd_unaligned_kernel<<<grid, kThreads, 0, stream>>>(
      g, a, h, t_len, w, du, da);
  return static_cast<int>(cudaGetLastError());
}

// The TMA path: W % 4 == 0 and all five tensors 16-byte aligned (the
// wrapper's scan_path checks it), or cudaErrorInvalidValue; or
// kTensorMapError if the driver could not encode a tensor map.
extern "C" int rglru_scan_bwd_tma_launch(const float* g, const float* a,
                                         const float* h, int64_t b,
                                         int64_t t_len, int64_t w, float* du,
                                         float* da, cudaStream_t stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (b <= 0 || w <= 0 || t_len <= 0 || b > 65535 || w % 4 != 0 ||
      t_len > INT32_MAX - kTileT || w > INT32_MAX || misaligned(g) ||
      misaligned(a) || misaligned(h) || misaligned(du) || misaligned(da))
    return static_cast<int>(cudaErrorInvalidValue);
  // the runtime calls first, as in rglru_scan_tma_launch
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rglru_scan_bwd_tma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mg, ma, mh, mdu, mda;
  if (!make_map(&mg, g, b, t_len, w) || !make_map(&ma, a, b, t_len, w) ||
      !make_map(&mh, h, b, t_len, w) || !make_map(&mdu, du, b, t_len, w) ||
      !make_map(&mda, da, b, t_len, w))
    return kTensorMapError;
  const dim3 grid(static_cast<unsigned>((w + kTileC - 1) / kTileC),
                  static_cast<unsigned>(b));
  rglru_scan_bwd_tma_kernel<<<grid, kTmaThreads, kBwdSmemBytes, stream>>>(
      mg, ma, mh, mdu, mda, static_cast<int>(t_len));
  return static_cast<int>(cudaGetLastError());
}
