// Blocked (flash) attention forward with an online softmax: causal, sliding
// window, tanh logit softcap, grouped-query heads, queries aligned to the end
// of the keys (q_offset = S - Tq), f32 accumulation, output in q's type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention (body _flash_kernel).  For query row i of head h and key j
// of kv head h / (H / Hkv):
//
//     s_ij = dot(q_i, k_j) * scale;  s_ij = tanh(s_ij / cap) * cap (softcap)
//     keep j iff j < S, and j <= i + q_offset (causal), and
//                j > i + q_offset - window (window)
//     o_i  = sum_j softmax_j(s_ij over kept j) * v_j
//
// The TPU kernel ran a sequential grid (B*H, Tq/bq, S/bk) and carried the
// running max, denominator and accumulator in VMEM scratch from one KV grid
// step to the next.  Blocks on Hopper run in parallel and carry nothing, so
// here a block owns one (batch, head, query tile) and walks the KV tiles
// itself in a loop, with the running max m, denominator l and accumulator
// in registers.  Two kernels:
//
// 1. flash_fwd_wgmma_kernel, bf16 at hd 64, 128 and 256: the tensor cores.
//    What bounds it: at the local layer's prefill (B 1, H 16, Hkv 1,
//    T = S = 4096, hd 256, window 2048) the work is 4 * hd operations per
//    kept (query, key) pair, about 103 GFLOP, 0.10 ms at 989 TFLOP/s bf16,
//    against 0.03 ms for its q/k/v/o bytes: operations.  Design, item by
//    item against what held the CUDA-core kernel back:
//    * f32 FMAs on the CUDA cores (67 TFLOP/s at best): both products are
//      wgmma, bf16 operands with f32 accumulation.  S = Q K^T is
//      m64n64k16 with Q and K from shared memory (K-major); O += P V is
//      m64n{hd}k16 with P from registers and V from shared memory
//      (MN-major, transposed by the instruction).
//    * six shared loads per eight FMAs: wgmma reads its operands from
//      shared memory itself; the threads issue no loads in the loop.
//    * K and V widened to f32 in shared memory: they stay bf16, laid out by
//      TMA with the 128-byte swizzle that wgmma reads without bank
//      conflicts (rows of 64 bf16; hd / 64 such column blocks a tile).
//    * 32-key tiles: 64-key tiles; a block holds 128 query rows.
//    * synchronous tile loads between two barriers: one producer warp keeps
//      TMA loads of the next K/V tiles in flight in a 2-stage ring
//      (full/empty mbarriers; tensor maps encoded on the host with
//      cuTensorMapEncodeTiled, passed as __grid_constant__), so loads
//      overlap the math.
//    * P through shared memory: the score accumulator's fragment is already
//      the A-operand fragment of the next wgmma; P is rounded to bf16 in
//      registers and fed from there.
//    Block: warpgroups 0 and 1 consume (64 query rows each; setmaxnreg
//    gives them 240 registers, since O alone takes hd / 2 = 128 f32 a
//    thread at hd 256), warpgroup 2 produces (24 registers).  The online
//    softmax (softcap, scale, row max and sum) runs on the fragment: a
//    thread holds two rows, a row's four lanes reduce with two shuffles.
//    Only tiles on the causal or window edge (or past S) mask element by
//    element.  Shared memory: Q 128 x hd + 2 stages x (K + V) 64 x hd,
//    bf16, 192 KB at hd 256.
//
// 2. flash_fwd_kernel, f32 inputs and bf16 at hd 16 and 32: f32 math on the
//    CUDA cores.  256 threads as 16 row groups x 16 column groups, each
//    thread owning 4 query rows and hd/16 output columns.  Per KV tile of
//    32 keys: K and V are staged in shared memory as f32 (rows padded to
//    hd + 1 floats, so the 16 keys a half-warp reads at one d fall in 16
//    banks), each thread computes its 4 x 2 scores, the row max and sum
//    reduce over the 16 lanes of its row group with shuffles, the
//    probabilities go through shared memory, and each thread adds P V into
//    its accumulator.  Shared memory (64 + 2*32) * (hd + 1) * 4 + 64 * 33 *
//    4 bytes, 140,032 at hd = 256, set with cudaFuncSetAttribute.
//
// Masking, both kernels: a masked score contributes exactly 0 and m starts
// at -1e30, so a tile wholly masked for a row leaves that row's m, l and
// accumulator as they were: it cannot poison them.  KV tiles wholly outside
// the causal window are not visited at all: at T = 4096 with window 2048
// that skips about half of them.  Every row keeps at least its own
// position, so l > 0 at the end; the division still guards it like the
// reference (max(l, 1e-30)).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC.  Plain C interface, loaded with ctypes; the
//        driver's cuTensorMapEncodeTiled is reached through
//        cudaGetDriverEntryPoint, so nothing links -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 32;                   // keys per KV tile
constexpr int kGroups = 16;               // row groups = column groups
constexpr int kThreads = kGroups * kGroups;
constexpr int kRows = kBQ / kGroups;      // query rows per thread
constexpr int kKeys = kBK / kGroups;      // scores per row per thread
constexpr int kLdP = kBK + 1;             // padded row stride of P
constexpr float kNegInf = -1e30f;         // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_st;  // strides in elements; the last dim is dense
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_st;
  int h, hkv, tq, s;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

template <int HD>
constexpr int smem_bytes() {
  return ((kBQ + 2 * kBK) * (HD + 1) + kBQ * kLdP) *
         static_cast<int>(sizeof(float));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int kLd = HD + 1;          // padded row stride of Q, K, V tiles
  constexpr int kCols = HD / kGroups;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                    // [kBQ][kLd]
  float* sk = sq + kBQ * kLd;          // [kBK][kLd]
  float* sv = sk + kBK * kLd;          // [kBK][kLd]
  float* sp = sv + kBK * kLd;          // [kBQ][kLdP]

  const int tid = threadIdx.x;
  const int cg = tid % kGroups;        // column group: 16 lanes of a half-warp
  const int rg = tid / kGroups;        // row group
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int kvh = h / (p.h / p.hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_offset = p.s - p.tq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    sq[r * kLd + d] = qi < p.tq ? to_f32(qg[qi * p.q_st + d]) : 0.0f;
  }

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // The KV tiles that hold a kept key for some row of this query tile.
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + kBQ, p.tq) - 1 + q_offset;
  int k_end = p.s;
  int k_begin = 0;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  if (p.window > 0) k_begin = max(0, qpos_lo - p.window + 1);
  k_begin = k_begin / kBK * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous K, V tile
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int kj = k0 + r;
      const bool in = kj < p.s;
      sk[r * kLd + d] = in ? to_f32(kg[kj * p.k_st + d]) : 0.0f;
      sv[r * kLd + d] = in ? to_f32(vg[kj * p.v_st + d]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sq[(rg * kRows + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = sk[(cg + kGroups * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + rg * kRows + i + q_offset;
      bool keep[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + cg + kGroups * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.0f) x = tanhf(x / p.softcap) * p.softcap;
        keep[j] = kpos < p.s && (!p.causal || kpos <= qpos) &&
                  (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = x;
        if (keep[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kGroups / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pj = keep[j] ? expf(s[i][j] - m_new) : 0.0f;
        rowsum += pj;
        sp[(rg * kRows + i) * kLdP + cg + kGroups * j] = pj;
      }
#pragma unroll
      for (int off = kGroups / 2; off > 0; off /= 2)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      l[i] = l[i] * alpha + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    // P's rows of a row group are written and read by the same half-warp.
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sp[(rg * kRows + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = sv[kk * kLd + cg + kGroups * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + rg * kRows + i;
    if (qi >= p.tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      og[qi * p.o_st + cg + kGroups * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.tq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(b * p.h));
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int b, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, b, stream);
    case 32: return launch<T, 32>(p, b, stream);
    case 64: return launch<T, 64>(p, b, stream);
    case 128: return launch<T, 128>(p, b, stream);
    case 256: return launch<T, 256>(p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 reaches the CUDA-core kernel only at hd 16 and 32 (the wgmma kernel
// takes 64, 128 and 256).
template <>
int launch_hd<__nv_bfloat16>(const Params& p, int b, int hd,
                             cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<__nv_bfloat16, 16>(p, b, stream);
    case 32: return launch<__nv_bfloat16, 32>(p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------------
// The bf16 tensor-core path: TMA ring + wgmma, warp-specialised.
// ------------------------------------------------------------------------

constexpr int kWgBQ = 128;                // query rows per block (2 x 64)
constexpr int kWgBK = 64;                 // keys per KV tile
constexpr int kStages = 2;                // K/V ring depth
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kWgThreads = (kConsumers + 1) * 128;
constexpr int kSubCols = 64;              // bf16 columns in a 128 B row
constexpr float kLog2e = 1.4426950408889634f;

struct WgParams {
  void* o;
  int64_t o_sb, o_sh, o_st;
  int h, hkv, tq, s;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

template <int HD>
struct WgLayout {
  static constexpr int kSub = HD / kSubCols;                 // 128 B columns
  static constexpr int kQBytes = kWgBQ * HD * 2;
  static constexpr int kKVBytes = kWgBK * HD * 2;            // K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
};

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

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor for a 128 B-swizzled tile: rows of 128 B,
// 8-row atoms of 1024 B (SBO), `lbo` bytes between 64-column blocks where
// the operand is MN-major (ignored for K-major), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3ffff) >> 4) | (uint64_t((lbo >> 4) & 0x3fff) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving a wgmma operand's reads or writes across
// a wgmma fence or wait (asm volatile statements keep their order).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, f32) = [D +] A (smem, K-major) * B (smem, K-major), k = 16.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (registers, bf16) * B (smem, MN-major), k = 16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (registers, bf16) * B (smem, MN-major), k = 16.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (registers, bf16) * B (smem, MN-major), k = 16.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  if constexpr (HD == 256) wgmma_rs_n256(o, a, db);
}

// One block: 128 query rows of one (batch, head).  Warpgroups 0 and 1
// consume (64 rows each), warpgroup 2 produces (one thread issues TMA).
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const WgParams p) {
  using L = WgLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, full[kStages], empty[kStages];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                                  // [kSub][kWgBQ][64]
  auto sk = [&](int st) { return base + L::kQBytes + st * L::kStageBytes; };
  auto sv = [&](int st) { return sk(st) + L::kKVBytes; };  // [kSub][kWgBK][64]

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int kvh = h / (p.h / p.hkv);
  const int q0 = blockIdx.x * kWgBQ;
  const int q_offset = p.s - p.tq;
  // The KV tiles that hold a kept key for some row of this block.
  const int qpos_hi = min(q0 + kWgBQ, p.tq) - 1 + q_offset;
  int k_end = p.s;
  int k_begin = 0;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  if (p.window > 0) k_begin = max(0, q0 + q_offset - p.window + 1);
  k_begin = k_begin / kWgBK * kWgBK;
  const int n_tiles = max(0, (k_end - k_begin + kWgBK - 1) / kWgBK);

  if (tid >= kConsumers * 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(&bar_q, L::kQBytes);
      for (int c = 0; c < L::kSub; ++c)
        tma_load(&map_q, sq + c * kWgBQ * 128, &bar_q, c * kSubCols, q0, h,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[st], L::kStageBytes);
        const int k0 = k_begin + i * kWgBK;
        for (int c = 0; c < L::kSub; ++c) {
          tma_load(&map_k, sk(st) + c * kWgBK * 128, &full[st], c * kSubCols,
                   k0, kvh, b);
          tma_load(&map_v, sv(st) + c * kWgBK * 128, &full[st], c * kSubCols,
                   k0, kvh, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = tid / 128;
    const int t = tid % 128;
    const int lane = t % 32;
    const int row0 = wg * 64 + (t / 32) * 16 + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const int qpos0 = q0 + row0 + q_offset;
    const int wg_lo = q0 + wg * 64 + q_offset;            // rows' positions
    const int wg_hi = wg_lo + 63;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    const float scale_log2 = p.scale * kLog2e;
    uint8_t* sq_wg = sq + wg * 64 * 128;

    mbar_wait(&bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int k0 = k_begin + i * kWgBK;
      mbar_wait(&full[st], (i / kStages) & 1);

      // S = Q K^T over HD / 16 steps of k = 16.
      float s[kWgBK / 2];
#pragma unroll
      for (int j = 0; j < kWgBK / 2; ++j) s[j] = 0.0f;
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::kSub; ++c)
#pragma unroll
        for (int kk = 0; kk < kSubCols / 16; ++kk)
          wgmma_ss_n64(s, smem_desc(sq_wg + c * kWgBQ * 128 + kk * 32, 0),
                       smem_desc(sk(st) + c * kWgBK * 128 + kk * 32, 0),
                       c + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      // Online softmax on the fragment: thread holds rows row0, row0 + 8
      // at columns 8j + col0 + {0, 1}; a row's four lanes are adjacent.
      const bool edge = k0 + kWgBK > p.s ||
                        (p.causal && k0 + kWgBK - 1 > wg_lo) ||
                        (p.window > 0 && k0 <= wg_hi - p.window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kWgBK / 2; ++j) {
        const int r = (j / 2) & 1;
        float x = s[j];
        if (p.softcap > 0.0f) {
          x = tanhf(x * p.scale / p.softcap) * p.softcap / p.scale;
        }
        if (edge) {
          const int kpos = k0 + 8 * (j / 4) + col0 + (j & 1);
          const int qpos = qpos0 + 8 * r;
          const bool keep = kpos < p.s && (!p.causal || kpos <= qpos) &&
                            (p.window <= 0 || kpos > qpos - p.window);
          if (!keep) x = -CUDART_INF_F;
        }
        s[j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[kWgBK / 16][4];
#pragma unroll
      for (int j = 0; j < kWgBK / 2; j += 2) {
        const int r = (j / 2) & 1;
        const float p0 = exp2f(fmaf(s[j], scale_log2, -m[r]));
        const float p1 = exp2f(fmaf(s[j + 1], scale_log2, -m[r]));
        l[r] += p0 + p1;
        pa[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j / 2) & 1];

      // O += P V: P from registers, V MN-major from shared memory.
      pin(o);
      pin(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_pv<HD>(o, pa[kk], smem_desc(sv(st) + kk * 16 * 128,
                                           kWgBK * 128));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      mbar_arrive(&empty[st]);
    }

    // Normalise and write this thread's two rows.
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qi = q0 + row0 + 8 * r;
      if (qi >= p.tq) continue;
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = og + int64_t(qi) * p.o_st;
#pragma unroll
      for (int j = 2 * r; j < HD / 2; j += 4) {
        const int col = 8 * (j / 4) + col0;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
      }
    }
  }
}

// ----------------------------------------------------------- host: TMA maps
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

// A (B, rows, heads, hd) bf16 view as a 4-D tensor map (innermost first),
// boxes of 64 columns x box_rows rows, 128-byte swizzle, zero fill past the
// edges.  Strides are in elements.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
              int batch, int64_t s_row, int64_t s_head, int64_t s_batch,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(rows),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s_row) * 2, cuuint64_t(s_head) * 2,
                                 cuuint64_t(s_batch) * 2};
  const cuuint32_t box[4] = {kSubCols, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const CUtensorMap& mq, const CUtensorMap& mk,
                 const CUtensorMap& mv, const WgParams& p, int b,
                 cudaStream_t stream) {
  constexpr int bytes = WgLayout<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.tq + kWgBQ - 1) / kWgBQ),
                  static_cast<unsigned>(b * p.h));
  flash_fwd_wgmma_kernel<HD><<<grid, kWgThreads, bytes, stream>>>(mq, mk, mv,
                                                                  p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16 (q, k, v and o alike).  Strides are in
// elements for the (batch, head, position) axes; the head dim is dense.
// window <= 0 and softcap <= 0 mean none.  Launches on `stream` without
// synchronising and allocates nothing; returns a CUDA error code (0 on
// success).  All pointers are device pointers.
extern "C" int flash_attention_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh,
    int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb,
    int64_t o_sh, int64_t o_st, int b, int h, int hkv, int tq, int s,
    int causal, int window, float softcap, float scale, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || tq <= 0 || s <= 0 ||
      static_cast<int64_t>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    q_sb, q_sh,   q_st,   k_sb,
                 k_sh, k_st, v_sb, v_sh, v_st, o_sb,   o_sh,   o_st,
                 h,    hkv,  tq,   s,    causal, window, softcap, scale};
  switch (dtype) {
    case 0: return launch_hd<float>(p, b, hd, stream);
    case 1: return launch_hd<__nv_bfloat16>(p, b, hd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 tensor-core kernel, hd in {64, 128, 256}.  The same arguments as
// flash_attention_launch without dtype; q, k and v must have 16-byte aligned
// bases and strides that are multiples of 8 elements (TMA's rules; the
// wrapper checks them).  Returns a CUDA error code, or
// kTensorMapError if the driver could not encode a tensor map.
constexpr int kTensorMapError = 1000;

extern "C" int flash_attention_wgmma_launch(
    int hd, const void* q, const void* k, const void* v, void* o,
    int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh,
    int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb,
    int64_t o_sh, int64_t o_st, int b, int h, int hkv, int tq, int s,
    int causal, int window, float softcap, float scale, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || tq <= 0 || s <= 0 ||
      static_cast<int64_t>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // Encoding a tensor map needs the card's context current on this thread,
  // which a thread whose first CUDA work is this launch does not have yet:
  // setting the device makes the runtime's primary context current.
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, hd, tq, h, b, q_st, q_sh, q_sb, kWgBQ) ||
      !make_map(&mk, k, hd, s, hkv, b, k_st, k_sh, k_sb, kWgBK) ||
      !make_map(&mv, v, hd, s, hkv, b, v_st, v_sh, v_sb, kWgBK))
    return kTensorMapError;
  const WgParams p{o, o_sb, o_sh, o_st, h, hkv, tq, s,
                   causal, window, softcap, scale};
  switch (hd) {
    case 64: return launch_wgmma<64>(mq, mk, mv, p, b, stream);
    case 128: return launch_wgmma<128>(mq, mk, mv, p, b, stream);
    case 256: return launch_wgmma<256>(mq, mk, mv, p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
