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
// here one block owns one (batch, head, 64-row query tile) and walks the KV
// tiles itself in a loop, with the running max m, denominator l and the
// 64 x hd accumulator in registers: 256 threads as 16 row groups x 16
// column groups, each thread owning 4 query rows and hd/16 output columns.
// Per KV tile of 32 keys: the tile of K and V is staged in shared memory as
// f32 (rows padded to hd + 1 floats, so the 16 keys a half-warp reads at
// one d fall in 16 banks), each thread computes its 4 x 2 scores, the row
// max and sum reduce over the 16 lanes of its row group with shuffles, the
// probabilities go through shared memory, and each thread adds P V into its
// accumulator.  The Q tile stays in shared memory for the whole walk.
//
// Masking: a masked score contributes exactly 0 (not exp(-1e30 - m)), and m
// starts at -1e30, so a tile wholly masked for a row leaves that row's m, l
// and accumulator as they were: it cannot poison them.  KV tiles wholly
// outside the causal window are not visited at all: at T = 4096 with window
// 2048 that skips about half of them.  Every row keeps at least its own
// position, so l > 0 at the end; the division still guards it like the
// reference (max(l, 1e-30)).
//
// What bounds it on an H100: at the local layer's prefill (B 1, H 16,
// Hkv 1, T = S = 4096, hd 256, window 2048, bf16) the work is 4 * hd
// operations per kept (query, key) pair, about 103 GFLOP, 0.10 ms on the
// tensor cores (989 TFLOP/s bf16); its q/k/v/o bytes take 0.03 ms.  This
// first kernel computes in f32 on the CUDA cores (67 TFLOP/s at best) and
// is further held to shared-memory load bandwidth (six shared loads per
// eight FMAs in the score loop), so it runs tens of times its bound.  The
// warpgroup-MMA (wgmma) + TMA pipeline that the bound asks for is later
// work; this one is the simple, right version.
//
// Head dims: a template over {16, 32, 64, 128, 256}; input types f32 and
// bf16, the two the model runs in.  Shared memory: (64 + 2*32) * (hd + 1)
// * 4 + 64 * 33 * 4 bytes, 140,032 at hd = 256, set with
// cudaFuncSetAttribute above 48 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC.  Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
