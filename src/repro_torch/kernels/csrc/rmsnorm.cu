// RMSNorm for Hopper (sm_90a): three forward launches over one row body,
// and their three backward launches over another (at the end of the file).
//
// Replaces: src/repro/kernels/rmsnorm.py `rmsnorm_pallas` (its `_kernel`):
//   out = (x / sqrt(mean(x^2) + eps)) * gamma, in f32, cast back to x's type.
// The division by sqrt (not x * rsqrt) is kept on purpose: it is the TPU
// kernel's formula, and nvcc's default IEEE division and square root give
// the same rounding as the plain PyTorch version.
//
// Entry points (kernels/rmsnorm.py):
//   repro_rmsnorm       rows of x normed;
//   repro_add_rmsnorm   s = x + y rounded to the type (the residual stream,
//                       PyTorch's `x + y` bit for bit), h = rmsnorm(s);
//   repro_qk_norm_rope  the q- and k-norms of one attention layer, each
//                       row rounded to the type and then rotated
//                       (rotate-half) with __fmul_rn / __fsub_rn /
//                       __fadd_rn, no FMA contraction, and rounded once:
//                       rmsnorm followed by the plain rotary embedding bit
//                       for bit.  q rows and k rows in one launch.
// The three share one row body per width, so a row normed by any of them
// has the same bits: add_rmsnorm's h equals repro_rmsnorm on its s.
//
// What bounds it on this card: bytes, and at decode the launch.  It reads
// x (and y, cos, sin) and gamma once and writes each output once, a few
// flops per element.  On the decode path rows are 8 (d 1024) and 192 (d
// 128, q and k heads): tens of KB, so the launch and one round trip to
// memory set its time, and the lever is fewer launches.  Fusing the
// residual adds and the rotary embedding takes 28 norm launches and about
// 20 elementwise launches per layer off each decode step of qwen3-0.6b.
//
// Design.  A row is held in registers by a group of LPR lanes of one warp:
// a row of NV 16-byte vectors takes LPR = min(NV, 32) lanes, each with
// VPL = NV / LPR vectors (d 1024: 32 lanes x 4 vectors in bf16, x 8 in
// f32; d 128: 16 lanes x 1 in bf16, 32 x 1 in f32), so a warp holds
// 32 / LPR rows.  NV is a compile-time constant for 8..256 vectors (8..128
// for the rotary entry: a head row); every load of a lane -- x, y, gamma
// as float4, cos and sin -- is issued before the reduction, x is read
// once, and the sum of squares is reduced by butterfly shuffles within
// the row's lanes (no shared memory, no __syncthreads).  Rows of other
// widths (a multiple of 8 elements) take one warp per row in a runtime
// loop that reads x again.  The rotary
// partner of an element, d/2 away, sits in lane ^ (NV/2) for NV <= 32 and
// in vector k ^ (NV/2/LPR) of the same lane above.  The forward norms'
// block holds 1, 2, 4 or 8 warps (8 by default; the measured plan of
// kernels/autotune.py picks among them); no row's arithmetic depends on
// it.  No allocation, no synchronisation; launched on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* o) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// v rounded to T and widened back (exact for f32).
template <typename T> __device__ __forceinline__ float rounded(float v);
template <> __device__ __forceinline__ float rounded<float>(float v) { return v; }
template <> __device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// N f32 values from a 16-byte aligned address, as float4 loads.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    o[4 * i] = v.x; o[4 * i + 1] = v.y; o[4 * i + 2] = v.z; o[4 * i + 3] = v.w;
  }
}

// A row of NV 16-byte vectors: LPR lanes, VPL vectors each, RPW rows per
// warp, RPB per block of kWarps warps (the backward and the rotary entry;
// the forward norm's block may have fewer warps, blockDim.x / 32).  Lane
// `sub` of a row holds vectors k * LPR + sub.
template <int NV> struct Layout {
  static constexpr int LPR = NV < 32 ? NV : 32;
  static constexpr int VPL = NV / LPR;
  static constexpr int RPW = 32 / LPR;
  static constexpr int RPB = RPW * kWarps;
};

// The row's sum of squares over its LPR lanes: each lane's terms in order
// by FMA, then a butterfly, so every lane of the row ends with the same
// bits.
template <int LPR, int VPL, int N>
__device__ __forceinline__ float row_sumsq(const float (&v)[VPL][N]) {
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) ss = fmaf(v[k][i], v[k][i], ss);
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
  return ss;
}

// sqrt(ss / d + eps) and (v / rms) * g, each step rounded in f32 by an
// intrinsic, so no launch contracts them differently from another.
__device__ __forceinline__ float rms_of(float ss, int d, float eps) {
  return __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), eps));
}
__device__ __forceinline__ float normed(float v, float rms, float g) {
  return __fmul_rn(__fdiv_rn(v, rms), g);
}

struct RowSlot {
  int row;    // this lane's row
  int sub;    // its lane within the row's LPR lanes
  bool live;  // row < rows (a dead lane still joins the shuffles)
};

// The block's warps come from blockDim.x: a row's arithmetic does not
// depend on the block, so every block size gives the same bits.
template <int NV>
__device__ __forceinline__ RowSlot row_slot(int rows) {
  using L = Layout<NV>;
  const int lane = threadIdx.x & 31;
  const int warps = static_cast<int>(blockDim.x >> 5);
  RowSlot s;
  s.sub = lane % L::LPR;
  s.row = (blockIdx.x * warps + (threadIdx.x >> 5)) * L::RPW + lane / L::LPR;
  s.live = s.row < rows;
  return s;
}

// rmsnorm (kAdd false) or add_rmsnorm (kAdd true) over rows of NV vectors.
template <typename T, int NV, bool kAdd>
__global__ void __launch_bounds__(kThreads)
norm_rows(const T* __restrict__ x, const T* __restrict__ y,
          const float* __restrict__ gamma, T* __restrict__ s_out,
          T* __restrict__ out, int rows, float eps) {
  using L = Layout<NV>;
  constexpr int N = Vec<T>::N;
  constexpr int D = NV * N;
  const RowSlot rs = row_slot<NV>(rows);
  const int64_t base = static_cast<int64_t>(rs.row) * D;
  float v[L::VPL][N], g[L::VPL][N];
  if (rs.live) {
    float w[L::VPL][N];
#pragma unroll
    for (int k = 0; k < L::VPL; ++k) {
      const int e = (k * L::LPR + rs.sub) * N;
      Vec<T>::load(x + base + e, v[k]);
      if constexpr (kAdd) Vec<T>::load(y + base + e, w[k]);
      load_f32<N>(gamma + e, g[k]);
    }
    if constexpr (kAdd) {
#pragma unroll
      for (int k = 0; k < L::VPL; ++k) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[k][i] = rounded<T>(__fadd_rn(v[k][i], w[k][i]));
        Vec<T>::store(s_out + base + (k * L::LPR + rs.sub) * N, v[k]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < L::VPL; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] = 0.f;
  }
  const float ss = row_sumsq<L::LPR>(v);
  const float rms = rms_of(ss, D, eps);
  if (!rs.live) return;
#pragma unroll
  for (int k = 0; k < L::VPL; ++k) {
    float o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = normed(v[k][i], rms, g[k][i]);
    Vec<T>::store(out + base + (k * L::LPR + rs.sub) * N, o);
  }
}

// q rows [0, nq) then k rows [nq, nq + nk), each of NV vectors; token t's
// cos/sin row (D/2 f32) serves its hq q heads and its hkv k heads.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
qk_norm_rope_rows(const T* __restrict__ q, const T* __restrict__ k,
                  const float* __restrict__ gq, const float* __restrict__ gk,
                  const float* __restrict__ cosp, const float* __restrict__ sinp,
                  T* __restrict__ qo, T* __restrict__ ko, int nq, int nk,
                  int hq, int hkv, float eps) {
  using L = Layout<NV>;
  constexpr int N = Vec<T>::N;
  constexpr int D = NV * N;
  constexpr int H = D / 2;
  const RowSlot rs = row_slot<NV>(nq + nk);
  const bool is_q = rs.row < nq;
  const int r = is_q ? rs.row : rs.row - nq;
  const T* src = is_q ? q : k;
  T* dst = is_q ? qo : ko;
  const float* gamma = is_q ? gq : gk;
  const int64_t tok = is_q ? r / hq : r / hkv;
  const int64_t base = static_cast<int64_t>(r) * D;
  float v[L::VPL][N], g[L::VPL][N], c[L::VPL][N], s[L::VPL][N];
  if (rs.live) {
#pragma unroll
    for (int kk = 0; kk < L::VPL; ++kk) {
      const int e = (kk * L::LPR + rs.sub) * N;
      Vec<T>::load(src + base + e, v[kk]);
      load_f32<N>(gamma + e, g[kk]);
      load_f32<N>(cosp + tok * H + (e & (H - 1)), c[kk]);
      load_f32<N>(sinp + tok * H + (e & (H - 1)), s[kk]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < L::VPL; ++kk)
#pragma unroll
      for (int i = 0; i < N; ++i) v[kk][i] = g[kk][i] = c[kk][i] = s[kk][i] = 0.f;
  }
  const float ss = row_sumsq<L::LPR>(v);
  const float rms = rms_of(ss, D, eps);
  // The normed row rounded to T, as the unfused norm stores it.
  float h[L::VPL][N], p[L::VPL][N];
#pragma unroll
  for (int kk = 0; kk < L::VPL; ++kk)
#pragma unroll
    for (int i = 0; i < N; ++i) h[kk][i] = rounded<T>(normed(v[kk][i], rms, g[kk][i]));
  // Each element's partner d/2 away.
#pragma unroll
  for (int kk = 0; kk < L::VPL; ++kk)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (NV / 2 < L::LPR) {
        p[kk][i] = __shfl_xor_sync(kFull, h[kk][i], NV / 2);
      } else {
        p[kk][i] = h[kk ^ (NV / 2 / L::LPR)][i];
      }
    }
  if (!rs.live) return;
#pragma unroll
  for (int kk = 0; kk < L::VPL; ++kk) {
    const int e = (kk * L::LPR + rs.sub) * N;
    float o[N];
    if (e < H) {        // first half: x1 cos - x2 sin
#pragma unroll
      for (int i = 0; i < N; ++i)
        o[i] = __fsub_rn(__fmul_rn(h[kk][i], c[kk][i]), __fmul_rn(p[kk][i], s[kk][i]));
    } else {            // second half: x2 cos + x1 sin
#pragma unroll
      for (int i = 0; i < N; ++i)
        o[i] = __fadd_rn(__fmul_rn(h[kk][i], c[kk][i]), __fmul_rn(p[kk][i], s[kk][i]));
    }
    Vec<T>::store(dst + base + e, o);
  }
}

// Rows of any width d (a multiple of 8): one warp per row, a runtime loop
// over the row's vectors; pass 2 reads x (and y) again.
template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads)
norm_rows_generic(const T* __restrict__ x, const T* __restrict__ y,
                  const float* __restrict__ gamma, T* __restrict__ s_out,
                  T* __restrict__ out, int rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * static_cast<int>(blockDim.x >> 5) +
                  (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = static_cast<int64_t>(row) * d;
  const int nvec = d / N;
  float ss = 0.f;
  for (int vi = lane; vi < nvec; vi += 32) {
    float f[N];
    Vec<T>::load(x + base + vi * N, f);
    if constexpr (kAdd) {
      float w[N];
      Vec<T>::load(y + base + vi * N, w);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = rounded<T>(__fadd_rn(f[i], w[i]));
      Vec<T>::store(s_out + base + vi * N, f);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) ss = fmaf(f[i], f[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
  const float rms = rms_of(ss, d, eps);
  for (int vi = lane; vi < nvec; vi += 32) {
    float f[N], g[N];
    Vec<T>::load(x + base + vi * N, f);
    if constexpr (kAdd) {       // the same rounded sum again, not s_out
      float w[N];
      Vec<T>::load(y + base + vi * N, w);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = rounded<T>(__fadd_rn(f[i], w[i]));
    }
    load_f32<N>(gamma + vi * N, g);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = normed(f[i], rms, g[i]);
    Vec<T>::store(out + base + vi * N, f);
  }
}

// `warps` per block: 1, 2, 4 or 8 (kWarps, the default); the entry
// points check it.
template <typename T, int NV, bool kAdd>
void launch_fixed(const void* x, const void* y, const float* gamma, void* s,
                  void* out, int rows, float eps, int warps, cudaStream_t st) {
  const int rpb = Layout<NV>::RPW * warps;
  const int grid = (rows + rpb - 1) / rpb;
  norm_rows<T, NV, kAdd><<<grid, 32 * warps, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), gamma,
      static_cast<T*>(s), static_cast<T*>(out), rows, eps);
}

template <typename T, bool kAdd>
void launch_norm(const void* x, const void* y, const float* gamma, void* s,
                 void* out, int rows, int d, float eps, int warps,
                 cudaStream_t st) {
  switch (d * static_cast<int>(sizeof(T)) / 16) {
    case 8: return launch_fixed<T, 8, kAdd>(x, y, gamma, s, out, rows, eps, warps, st);
    case 16: return launch_fixed<T, 16, kAdd>(x, y, gamma, s, out, rows, eps, warps, st);
    case 32: return launch_fixed<T, 32, kAdd>(x, y, gamma, s, out, rows, eps, warps, st);
    case 64: return launch_fixed<T, 64, kAdd>(x, y, gamma, s, out, rows, eps, warps, st);
    case 128: return launch_fixed<T, 128, kAdd>(x, y, gamma, s, out, rows, eps, warps, st);
    case 256: return launch_fixed<T, 256, kAdd>(x, y, gamma, s, out, rows, eps, warps, st);
    default: {
      const int grid = (rows + warps - 1) / warps;
      norm_rows_generic<T, kAdd><<<grid, 32 * warps, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(y), gamma,
          static_cast<T*>(s), static_cast<T*>(out), rows, d, eps);
    }
  }
}

template <typename T, int NV>
void launch_qk(const void* q, const void* k, const float* gq, const float* gk,
               const float* cs, const float* sn, void* qo, void* ko, int nq,
               int nk, int hq, int hkv, float eps, cudaStream_t st) {
  const int grid = (nq + nk + Layout<NV>::RPB - 1) / Layout<NV>::RPB;
  qk_norm_rope_rows<T, NV><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), gq, gk, cs, sn,
      static_cast<T*>(qo), static_cast<T*>(ko), nq, nk, hq, hkv, eps);
}

template <typename T>
int launch_qk_any(const void* q, const void* k, const float* gq,
                  const float* gk, const float* cs, const float* sn, void* qo,
                  void* ko, int nq, int nk, int hq, int hkv, int d, float eps,
                  cudaStream_t st) {
  switch (d * static_cast<int>(sizeof(T)) / 16) {
    case 8: launch_qk<T, 8>(q, k, gq, gk, cs, sn, qo, ko, nq, nk, hq, hkv, eps, st); break;
    case 16: launch_qk<T, 16>(q, k, gq, gk, cs, sn, qo, ko, nq, nk, hq, hkv, eps, st); break;
    case 32: launch_qk<T, 32>(q, k, gq, gk, cs, sn, qo, ko, nq, nk, hq, hkv, eps, st); break;
    case 64: launch_qk<T, 64>(q, k, gq, gk, cs, sn, qo, ko, nq, nk, hq, hkv, eps, st); break;
    case 128: launch_qk<T, 128>(q, k, gq, gk, cs, sn, qo, ko, nq, nk, hq, hkv, eps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Backward: the JAX package's custom VJP (src/repro/kernels/ops.py:161),
// which the TPU side computes in plain jnp after its Pallas forward:
//   r = 1 / sqrt(mean(x^2) + eps), xh = x * r, g = dy * gamma
//   dx = (g - xh * mean(g * xh)) * r        (add_rmsnorm: + ds, the residual's
//                                            own gradient, in the same pass)
//   dgamma = sum over rows of dy * xh
// all in f32, dx rounded once to x's type, dgamma rounded once to gamma's
// type.  mean(g * xh) is taken as m = r * sum(g * x) / d, so the row's two
// sums (of x^2 and of g * x) are reduced together, and dx as
// g * r - x * (m * r^2) (+ ds).  The rotary entry first
// un-rotates dy (rotate-half is orthogonal: its transpose turns by -angle)
// and keeps the result in f32 for the norm's backward.
//
// What bounds it on this card: bytes.  It reads x, dy (and ds; cos and sin
// once per token) once and writes dx and dgamma once; at the training
// path's 4096 x 1024 bf16 rows that is 25 MB, 7.5 us at 3.35 TB/s.
//
// Design: one kernel a call (norm_bwd_rows).
//   Work unit: a group of R tokens.  A plain entry's token is one row; the
//   rotary entry's is the token's hq q head rows and hkv k head rows (two
//   segments, each with its own gamma and dgamma) and its cos/sin row, read
//   once for all its heads.  A group is one contiguous span of every
//   tensor, so it arrives by a few 1-d TMA bulk copies.
//   Staging: the grid is min(groups, SMs), one block of 512 threads per
//   SM, persistent over groups blk, blk + grid, ... (a fixed assignment).
//   Each block keeps a ring of S stages in shared memory; thread 0 fills a
//   stage by bulk copies (cp.async.bulk, completion counted on the stage's
//   mbarrier) S groups ahead of the one the block computes, and gamma by
//   one more copy, all sent at the block's start, so each SM has 50-200
//   KB of reads in flight without spending registers on them.  R puts the
//   fewest tokens on the busiest block (the bytes' balance), then the
//   fewest passes of its row slots, in a stage of 16-64 KB; S is as many
//   stages as shared memory holds, at most 4.  A call reading at most 64 KB
//   runs in one block and needs no finish.
//   Rows in registers: a row of NV 16-byte vectors is held by TPR threads (a
//   power of two), vectors sub, sub + TPR, ... (at most VPT a thread).
//   Plain entries hold 16 elements a thread, so every width up to
//   kBwdRegMaxD = 512 threads x 16 = 8192, bf16 or f32, is read once from
//   the stage into registers; the rotary entry holds 2 vectors, so an
//   element's rotation partner d/2 away is in the same thread.  The row's
//   two sums are a butterfly within min(TPR, 32) lanes and, for rows wider
//   than a warp, a sum over the row's warps in warp order through shared
//   memory (double-buffered: one __syncthreads a pass).  dx is stored from
//   registers, 16 bytes a thread.
//   Measured alternatives (scripts/bwd_variants.py on an H100, PERF.md
//   §6): 256 threads of 32 elements, 1-5% slower at 4096 rows; at
//   most 2 stages, 4-5% slower at 2560-6144 columns and at f32 1024, 2-4%
//   faster at bf16 1024; no call in one block, 8 x 1024 bf16 21% slower;
//   one block up to 256 KB, 8 x 6144 bf16 1.9x slower.  The same
//   script's per-block timer stamps show where a call's time goes.
//   dgamma inside the block: a thread's columns are the same for all its
//   rows, so it keeps dy * xh for them in registers across every row it
//   takes; at the end a butterfly over a warp's row slots, then the block's
//   slots in slot order, column by column over all threads (no warp-serial
//   loop): one f32 partial row per block (per segment) in the scratch.
//   dgamma across blocks, in the same launch: after a block barrier, thread
//   0 takes a ticket on the scratch's arrival counter with a release add
//   (it publishes the block's partial row).  The last F blocks to arrive
//   each own a slice of C columns: they wait (acquire) until every block
//   has counted, sum their slice over the blocks (threads split over
//   columns and over blocks in a power of two of groups, each group's
//   blocks in order, the groups by a fixed tree) and write dgamma in
//   gamma's type; the last finisher resets the counter, so the scratch is
//   zeroed once, when it is made (per device and stream, kernels/rmsnorm.py).
//   At most F blocks ever wait, F <= SMs / 2, and each waits only for
//   blocks that never wait, so the grid needs no co-residency.  Why this
//   and not the alternatives: a cluster's distributed shared memory sums
//   only within the cluster and still leaves grid / cluster partial rows
//   for a second pass; a second kernel behind programmatic dependent launch
//   is a second launch on the device and does the same reads.  Here the
//   finish overlaps the slowest blocks and spreads over F = min(cols / 16,
//   SMs / 2) SMs: at 1024 columns and 132 blocks, 64 blocks each read 132 x
//   16 floats from L2.
//   Determinism: TPR, R, S, the grid, F and C depend only on the shape and
//   the card (its SM count and shared memory); every sum runs in an order
//   they fix, so two calls give the same bits.
// Rows wider than 8192, up to kBwdMaxD, take norm_bwd_rows_generic: one
// block per row at a time, each thread a strided set of the row's vectors,
// three passes over the row (the sum of squares; dgamma's terms and the
// dot; dx), dgamma's terms accumulated in the block's partial row in shared
// memory, each column by the one thread that owns it, rows in order; the
// same finish.

constexpr int kBwdMaxD = 49152;      // the generic path's partial row: 192 KB of shared memory
constexpr int kBwdThreads = 512;     // the row kernel's block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRegElems = 16;     // row elements a thread holds (plain entries)
constexpr int kBwdRegMaxD = kBwdThreads * kBwdRegElems;   // widths held in registers
constexpr int kBwdRopeVPT = 2;       // rotary entry: vectors a thread holds
constexpr int kBwdMaxStages = 4;
constexpr int kBwdStageMin = 16 << 10;
constexpr int kBwdStageMax = 64 << 10;
constexpr int kBwdSmallCall = 64 << 10;   // a call this small runs in one block
constexpr int kBwdSlice = 16;        // dgamma columns a finishing block takes, at least
constexpr int kBwdHeader = 128;      // scratch bytes before the partial rows
constexpr int kBwdStatic = 1024;     // room kept for the kernels' static shared memory

struct BwdArgs {
  const void* x[2];       // the forward's input rows (add_rmsnorm: its sum s)
  const void* dy[2];      // gradient of the normed rows (rotated rows for rope)
  const void* ds;         // add_rmsnorm: gradient of s, added to dx; else null
  void* dx[2];
  const void* gamma[2];
  void* dgamma[2];        // in gamma's type
  const float* cosp;      // rope: (tokens, d/2) f32
  const float* sinp;
  unsigned* counter;      // scratch: [0] arrivals, [1] finishers done
  float* partials;        // scratch + kBwdHeader: blocks x cols floats
  int heads[2];           // rows per token of each segment (plain: 1, 0)
  int tokens;
  int d;
  int nseg;
  int gdtype;             // gamma's type: 0 float32, 1 bfloat16
  float eps;
  // The launch plan (plan_bwd).
  int R;                  // tokens per stage
  int S;                  // stages
  int nblocks;
  int F;                  // finishing blocks
  int C;                  // dgamma columns per finishing block, a multiple of 4
  int stage_bytes;
  int ring_off;           // the ring's offset in dynamic shared memory
  int off_x[2], off_dy[2], off_ds, off_cos, off_sin;   // within a stage
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(ready) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The arrival ticket: a release add by one thread after a block barrier
// publishes every thread's earlier writes (the barrier orders them before
// it; release is cumulative).
__device__ __forceinline__ unsigned add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Measurement builds only (compiled with -DREPRO_BWD_STAMPS by
// scripts/bwd_variants.py): thread 0 of each block records the card's
// %globaltimer (ns) at kBwdStamps points of a call -- 0 start, 1 gamma in
// shared memory, 2 first stage arrived, 3 rows done, 4 partial row
// written, 5 ticket taken, 6 every block counted (finishers), 7 dgamma
// slice written (finishers) -- which repro_rmsnorm_bwd_stamps copies out.
// Other builds compile BWD_STAMP to nothing.
#ifdef REPRO_BWD_STAMPS
constexpr int kBwdStamps = 8;
constexpr int kBwdStampBlocks = 1024;
__device__ unsigned long long g_bwd_stamps[kBwdStampBlocks][kBwdStamps];
__device__ __forceinline__ void bwd_stamp(int i) {
  if (threadIdx.x == 0 && blockIdx.x < kBwdStampBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_bwd_stamps[blockIdx.x][i] = t;
  }
}
#define BWD_STAMP(i) bwd_stamp(i)
#else
#define BWD_STAMP(i) ((void)0)
#endif

__device__ __forceinline__ float gamma_at(const void* g, int gdtype, int e) {
  return gdtype == 0 ? static_cast<const float*>(g)[e]
                     : __bfloat162float(static_cast<const __nv_bfloat16*>(g)[e]);
}

__device__ __forceinline__ void store_gamma(void* g, int gdtype, int e, float v) {
  if (gdtype == 0) static_cast<float*>(g)[e] = v;
  else static_cast<__nv_bfloat16*>(g)[e] = __float2bfloat16_rn(v);
}

// N f32 values from shared memory (16-byte aligned), as float4 loads.
template <int N>
__device__ __forceinline__ void smem_f32(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    o[4 * i] = v.x; o[4 * i + 1] = v.y; o[4 * i + 2] = v.z; o[4 * i + 3] = v.w;
  }
}

// Thread 0: bulk copies of group grp's spans into stage st, counted on bar.
template <typename T>
__device__ void stage_group(const BwdArgs& a, int grp, unsigned char* st,
                            uint32_t bar) {
  const int64_t t0 = static_cast<int64_t>(grp) * a.R;
  const int nt = min(a.R, a.tokens - static_cast<int>(t0));
  const int64_t row_b = static_cast<int64_t>(a.d) * sizeof(T);
  const uint32_t b0 = static_cast<uint32_t>(nt * a.heads[0] * row_b);
  const uint32_t b1 = a.nseg > 1 ? static_cast<uint32_t>(nt * a.heads[1] * row_b) : 0u;
  const uint32_t bc = a.cosp != nullptr ? static_cast<uint32_t>(nt * (a.d / 2) * 4) : 0u;
  const uint32_t total = 2 * b0 + 2 * b1 + (a.ds != nullptr ? b0 : 0u) + 2 * bc;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(total) : "memory");
  const int64_t e0 = t0 * a.heads[0] * a.d;
  if (b0) {
    bulk_load(st + a.off_x[0], static_cast<const T*>(a.x[0]) + e0, b0, bar);
    bulk_load(st + a.off_dy[0], static_cast<const T*>(a.dy[0]) + e0, b0, bar);
    if (a.ds != nullptr)
      bulk_load(st + a.off_ds, static_cast<const T*>(a.ds) + e0, b0, bar);
  }
  if (b1) {
    const int64_t e1 = t0 * a.heads[1] * a.d;
    bulk_load(st + a.off_x[1], static_cast<const T*>(a.x[1]) + e1, b1, bar);
    bulk_load(st + a.off_dy[1], static_cast<const T*>(a.dy[1]) + e1, b1, bar);
  }
  if (bc) {
    bulk_load(st + a.off_cos, a.cosp + t0 * (a.d / 2), bc, bar);
    bulk_load(st + a.off_sin, a.sinp + t0 * (a.d / 2), bc, bar);
  }
}

// dgamma across blocks.  The block's partial row (cols floats) is already
// in the scratch; `fin` is kT float4 of free shared memory (kT: the
// block's threads).
template <int kT>
__device__ void finish_dgamma(const BwdArgs& a, int cols, int* s_ticket,
                              float4* fin) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid == 0) *s_ticket = static_cast<int>(add_release(a.counter, 1u));
  __syncthreads();
  BWD_STAMP(5);
  const int f = *s_ticket - (a.nblocks - a.F);
  if (f < 0) return;
  if (tid == 0) {
    while (ld_acquire(a.counter) < static_cast<unsigned>(a.nblocks)) __nanosleep(64);
  }
  __syncthreads();
  BWD_STAMP(6);
  const int c0 = f * a.C;
  const int nvec = (min(c0 + a.C, cols) - c0) / 4;     // float4 columns
  const int lanes = nvec < kT ? nvec : kT;
  int groups = 1;                                      // a power of two
  while (groups * 2 * lanes <= kT) groups *= 2;
  const int cv0 = tid % lanes, rg = tid / lanes;
  const float4* src = reinterpret_cast<const float4*>(a.partials + c0);
  const int64_t stride = cols / 4;
  for (int base = 0; base < nvec; base += lanes) {      // uniform
    const int cv = base + cv0;
    const bool mine = rg < groups && cv < nvec;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mine) {
#pragma unroll 8
      for (int b = rg; b < a.nblocks; b += groups) {
        const float4 u = __ldcg(src + b * stride + cv);
        t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
      }
    }
    if (rg < groups) fin[rg * lanes + cv0] = t;
    // The groups' sums by a fixed tree.
    for (int h = groups / 2; h > 0; h >>= 1) {
      __syncthreads();
      if (rg < h) {
        const float4 u = fin[(rg + h) * lanes + cv0];
        float4& v = fin[rg * lanes + cv0];
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
    }
    __syncthreads();
    if (tid < lanes && base + tid < nvec) {
      const float4 s = fin[tid];
      const int c = c0 + 4 * (base + tid);
      const int seg = c >= a.d ? 1 : 0;
      void* out = seg ? a.dgamma[1] : a.dgamma[0];
      const int col = c - seg * a.d;
      store_gamma(out, a.gdtype, col, s.x);
      store_gamma(out, a.gdtype, col + 1, s.y);
      store_gamma(out, a.gdtype, col + 2, s.z);
      store_gamma(out, a.gdtype, col + 3, s.w);
    }
    __syncthreads();
  }
  BWD_STAMP(7);
  if (tid == 0 && atomicAdd(a.counter + 1, 1u) == static_cast<unsigned>(a.F - 1)) {
    a.counter[0] = 0u;                 // every finisher has passed its wait
    a.counter[1] = 0u;
  }
}

// Rows of NV vectors held by TPR threads, VPT vectors a thread at most (the
// row's width is a.d at run time); kRope: q and k head rows of a run of
// tokens, dy un-rotated first.
template <typename T, int TPR, int VPT, bool kRope>
__global__ void __launch_bounds__(kBwdThreads, 1)
norm_bwd_rows(const BwdArgs a) {
  constexpr int N = Vec<T>::N;
  constexpr int P = kBwdThreads / TPR;               // row slots of a pass
  constexpr int RL = TPR < 32 ? TPR : 32;         // a row's lanes in one warp
  constexpr int WPR = TPR > 32 ? TPR / 32 : 1;    // a row's warps
  constexpr int SW = TPR < 32 ? kBwdWarps : P;       // the block's slots after a warp's butterfly
  constexpr int A1 = kRope ? VPT : 1;
  static_assert(TPR * VPT * N <= kBwdRegMaxD, "a row must fit the block");
  static_assert(!kRope || VPT == kBwdRopeVPT, "rotary rows: 2 vectors a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kBwdMaxStages];
  __shared__ __align__(8) unsigned long long gbar;
  __shared__ float2 red[2][kBwdWarps];
  __shared__ int s_ticket;
  float* s_gamma = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + a.ring_off;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int sub = tid % TPR, slot = tid / TPR;
  const int d = a.d, nv = d / N, cols = a.nseg * d;
  const int h0 = a.heads[0], h1 = kRope ? a.heads[1] : 0;

  BWD_STAMP(0);
  const int groups = (a.tokens + a.R - 1) / a.R;
  const int mine = (groups - 1 - static_cast<int>(blockIdx.x)) / a.nblocks + 1;
  // Gamma and the first S groups arrive by bulk copies started at the
  // block's start: gamma into s_gamma (f32) or its upper half (bf16,
  // widened in place below); a gamma not 16-byte aligned is read by the
  // threads instead.
  const int gsize = a.gdtype == 0 ? 4 : 2;
  const bool g_bulk = ((reinterpret_cast<uintptr_t>(a.gamma[0]) |
                        (a.nseg > 1 ? reinterpret_cast<uintptr_t>(a.gamma[1]) : 0)) & 15) == 0;
  unsigned char* g_raw = smem + (a.gdtype == 0 ? 0 : cols * 2);
  if (tid == 0) {
    for (int s = 0; s < a.S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&full[s])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&gbar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (g_bulk) {
      const uint32_t gb = static_cast<uint32_t>(d * gsize);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_addr(&gbar)), "r"(gb * a.nseg) : "memory");
      bulk_load(g_raw, a.gamma[0], gb, smem_addr(&gbar));
      if (a.nseg > 1) bulk_load(g_raw + gb, a.gamma[1], gb, smem_addr(&gbar));
    }
    for (int k = 0; k < a.S && k < mine; ++k)
      stage_group<T>(a, blockIdx.x + k * a.nblocks, ring + k * a.stage_bytes,
                     smem_addr(&full[k]));
  }
  __syncthreads();                       // the barriers are initialised
  if (!g_bulk) {
    for (int e = tid; e < cols; e += kBwdThreads)
      s_gamma[e] = e < d ? gamma_at(a.gamma[0], a.gdtype, e)
                         : gamma_at(a.gamma[1], a.gdtype, e - d);
  } else if (a.gdtype != 0) {
    // bf16 gamma: every thread reads its 8-element chunks, then widens them.
    constexpr int kChunks = kBwdRegMaxD / 8 / kBwdThreads;
    mbar_wait(smem_addr(&gbar), 0);
    uint4 raw[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = tid + q * kBwdThreads;
      if (c * 8 < cols) raw[q] = reinterpret_cast<const uint4*>(g_raw)[c];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = tid + q * kBwdThreads;
      if (c * 8 < cols) {
        float f[8];
        Vec<__nv_bfloat16>::load(reinterpret_cast<const __nv_bfloat16*>(&raw[q]), f);
        reinterpret_cast<float4*>(s_gamma)[2 * c] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(s_gamma)[2 * c + 1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  } else {
    mbar_wait(smem_addr(&gbar), 0);
  }
  __syncthreads();
  BWD_STAMP(1);

  float acc0[VPT][N], acc1[A1][N];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int i = 0; i < N; ++i) acc0[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < A1; ++j)
#pragma unroll
    for (int i = 0; i < N; ++i) acc1[j][i] = 0.f;

  int pass = 0;
  for (int k = 0; k < mine; ++k) {
    const int st = k % a.S;
    mbar_wait(smem_addr(&full[st]), (k / a.S) & 1);
    if (k == 0) BWD_STAMP(2);
    const unsigned char* sp = ring + st * a.stage_bytes;
    const int64_t t0 = static_cast<int64_t>(blockIdx.x + k * a.nblocks) * a.R;
    const int nt = min(a.R, a.tokens - static_cast<int>(t0));
    const int rows0 = nt * h0, rows = rows0 + nt * h1;
    for (int base = 0; base < rows; base += P, ++pass) {   // uniform
      const int hr = base + slot;
      const bool live = hr < rows;
      const bool seg1 = kRope && hr >= rows0;
      const int r = seg1 ? hr - rows0 : hr;                // row within its segment's span
      const T* xs = reinterpret_cast<const T*>(sp + (seg1 ? a.off_x[1] : a.off_x[0])) +
                    static_cast<int64_t>(r) * d;
      const T* gs = reinterpret_cast<const T*>(sp + (seg1 ? a.off_dy[1] : a.off_dy[0])) +
                    static_cast<int64_t>(r) * d;
      const float* gam = s_gamma + (seg1 ? d : 0);
      float v[VPT][N], g[VPT][N];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vi = sub + j * TPR;
        if (live && vi < nv) {
          Vec<T>::load(xs + vi * N, v[j]);
          Vec<T>::load(gs + vi * N, g[j]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) v[j][i] = g[j][i] = 0.f;
        }
      }
      if constexpr (kRope) {
        // dh1 = do1 cos + do2 sin, dh2 = do2 cos - do1 sin; vector sub is in
        // the first half, sub + TPR (= sub + NV/2) its partner.
        if (live) {
          const int tok = r / (seg1 ? h1 : h0);
          const float* cs = reinterpret_cast<const float*>(sp + a.off_cos) + tok * (d / 2);
          const float* sn = reinterpret_cast<const float*>(sp + a.off_sin) + tok * (d / 2);
          float c[N], s[N];
          smem_f32<N>(cs + sub * N, c);
          smem_f32<N>(sn + sub * N, s);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float d1 = g[0][i], d2 = g[1][i];
            g[0][i] = d1 * c[i] + d2 * s[i];
            g[1][i] = d2 * c[i] - d1 * s[i];
          }
        }
      }
      // The row's sum of x^2 and of (dy * gamma) * x, together; dy * gamma
      // is kept for dx.
      float ss = 0.f, dr = 0.f;
      float gg[VPT][N];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vi = sub + j * TPR;
        if (vi < nv) {
          float gm[N];
          smem_f32<N>(gam + vi * N, gm);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            gg[j][i] = g[j][i] * gm[i];
            ss = fmaf(v[j][i], v[j][i], ss);
            dr = fmaf(gg[j][i], v[j][i], dr);
          }
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) gg[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int off = RL / 2; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(kFull, ss, off);
        dr += __shfl_xor_sync(kFull, dr, off);
      }
      if constexpr (WPR > 1) {
        float2* rb = red[pass & 1];
        if ((tid & 31) == 0) rb[warp] = make_float2(ss, dr);
        __syncthreads();
        const int w0 = (warp / WPR) * WPR;
        ss = 0.f; dr = 0.f;
#pragma unroll
        for (int w = 0; w < WPR; ++w) { ss += rb[w0 + w].x; dr += rb[w0 + w].y; }
      }
      // dx = (g - xh * m) * r with xh = x * r, m = r * dr / d, as
      // g * r - x * (m * r^2).
      const float rinv = 1.f / rms_of(ss, d, a.eps);
      const float c2 = dr * rinv / static_cast<float>(d) * rinv * rinv;
      if (live) {
        const int64_t row = t0 * (seg1 ? h1 : h0) + r;
        T* dxp = static_cast<T*>(seg1 ? a.dx[1] : a.dx[0]) + row * d;
        const T* dsp = (!kRope && a.ds != nullptr)
            ? reinterpret_cast<const T*>(sp + a.off_ds) + static_cast<int64_t>(r) * d
            : nullptr;
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int vi = sub + j * TPR;
          if (vi < nv) {
            float w[N], o[N];
            if (dsp != nullptr) {
              Vec<T>::load(dsp + vi * N, w);
            } else {
#pragma unroll
              for (int i = 0; i < N; ++i) w[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < N; ++i) {
              const float xh = v[j][i] * rinv;
              if (kRope && seg1) acc1[kRope ? j : 0][i] = fmaf(g[j][i], xh, acc1[kRope ? j : 0][i]);
              else acc0[j][i] = fmaf(g[j][i], xh, acc0[j][i]);
              o[i] = fmaf(-v[j][i], c2, gg[j][i] * rinv) + w[i];
            }
            Vec<T>::store(dxp + vi * N, o);
          }
        }
      }
    }
    __syncthreads();                       // stage st is read
    if (tid == 0 && k + a.S < mine) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stage_group<T>(a, blockIdx.x + (k + a.S) * a.nblocks, ring + st * a.stage_bytes,
                     smem_addr(&full[st]));
    }
  }

  BWD_STAMP(3);
  // The block's partial row: a warp's row slots by butterfly, then the
  // block's slots in slot order (the ring is free: no copy in flight).
  if constexpr (TPR < 32) {
#pragma unroll
    for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          acc0[j][i] += __shfl_xor_sync(kFull, acc0[j][i], off);
          if constexpr (kRope) acc1[kRope ? j : 0][i] += __shfl_xor_sync(kFull, acc1[kRope ? j : 0][i], off);
        }
  }
  float* buf = reinterpret_cast<float*>(ring);
  const int sw = TPR < 32 ? warp : slot;
  if (TPR >= 32 || (tid & 31) < TPR) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vi = sub + j * TPR;
      if (vi < nv) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          reinterpret_cast<float4*>(buf + sw * d + vi * N)[q] =
              make_float4(acc0[j][4 * q], acc0[j][4 * q + 1], acc0[j][4 * q + 2], acc0[j][4 * q + 3]);
          if constexpr (kRope)
            reinterpret_cast<float4*>(buf + (SW + sw) * d + vi * N)[q] =
                make_float4(acc1[kRope ? j : 0][4 * q], acc1[kRope ? j : 0][4 * q + 1],
                            acc1[kRope ? j : 0][4 * q + 2], acc1[kRope ? j : 0][4 * q + 3]);
        }
      }
    }
  }
  __syncthreads();
  float* part = a.partials + static_cast<int64_t>(blockIdx.x) * cols;
  for (int c = tid; c < cols; c += kBwdThreads) {
    const int seg = c >= d ? 1 : 0;
    const float* col = buf + seg * SW * d + (c - seg * d);
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < SW; ++w) t += col[w * d];
    if (a.nblocks > 1) part[c] = t;
    else store_gamma(seg ? a.dgamma[1] : a.dgamma[0], a.gdtype, c - seg * d, t);
  }
  BWD_STAMP(4);
  if (a.nblocks > 1) finish_dgamma<kBwdThreads>(a, cols, &s_ticket, reinterpret_cast<float4*>(ring));
}

// The sum of v over the block, every thread the same bits: butterflies in
// each warp, then the warps' sums in warp order.  `red` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();                 // red is free again
  return t;
}

// Rows of any width d (a multiple of 8), one segment (no rotary entry):
// block blk takes rows blk, blk + grid, ...; thread t the vectors t,
// t + kThreads, ... of each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_bwd_rows_generic(const BwdArgs a) {
  extern __shared__ __align__(16) float s_acc[];   // d floats: this block's dgamma terms
  __shared__ float red[kWarps];
  __shared__ int s_ticket;
  constexpr int N = Vec<T>::N;
  const int d = a.d, nvec = d / N;
  const T* x = static_cast<const T*>(a.x[0]);
  const T* dy = static_cast<const T*>(a.dy[0]);
  const T* ds = static_cast<const T*>(a.ds);
  T* dx = static_cast<T*>(a.dx[0]);
  for (int e = threadIdx.x; e < d; e += kThreads) s_acc[e] = 0.f;
  for (int row = blockIdx.x; row < a.tokens; row += a.nblocks) {
    const int64_t base = static_cast<int64_t>(row) * d;
    float ss = 0.f;
    for (int vi = threadIdx.x; vi < nvec; vi += kThreads) {
      float v[N];
      Vec<T>::load(x + base + vi * N, v);
#pragma unroll
      for (int i = 0; i < N; ++i) ss = fmaf(v[i], v[i], ss);
    }
    const float r = 1.f / rms_of(block_sum(ss, red), d, a.eps);
    float dot = 0.f;
    for (int vi = threadIdx.x; vi < nvec; vi += kThreads) {
      float v[N], g[N];
      Vec<T>::load(x + base + vi * N, v);
      Vec<T>::load(dy + base + vi * N, g);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] *= r;                                 // xh
        s_acc[vi * N + i] = fmaf(g[i], v[i], s_acc[vi * N + i]);
        g[i] *= gamma_at(a.gamma[0], a.gdtype, vi * N + i);   // dy * gamma
        dot = fmaf(g[i], v[i], dot);
      }
    }
    const float m = block_sum(dot, red) / static_cast<float>(d);
    for (int vi = threadIdx.x; vi < nvec; vi += kThreads) {
      float v[N], g[N], w[N], o[N];
      Vec<T>::load(x + base + vi * N, v);
      Vec<T>::load(dy + base + vi * N, g);
      if (ds != nullptr) {
        Vec<T>::load(ds + base + vi * N, w);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) w[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] *= r;
        g[i] *= gamma_at(a.gamma[0], a.gdtype, vi * N + i);
        o[i] = (g[i] - v[i] * m) * r + w[i];
      }
      Vec<T>::store(dx + base + vi * N, o);
    }
  }
  __syncthreads();
  float* part = a.partials + static_cast<int64_t>(blockIdx.x) * d;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    if (a.nblocks > 1) part[e] = s_acc[e];
    else store_gamma(a.dgamma[0], a.gdtype, e, s_acc[e]);
  }
  if (a.nblocks > 1) finish_dgamma<kThreads>(a, d, &s_ticket, reinterpret_cast<float4*>(s_acc));
}

// The card's SM count and the shared memory a block may opt into (the
// current device's, read once).
struct Card {
  int sms;
  int smem;
};

Card card_of_current_device() {
  static Card cache[64];
  static bool ready[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && ready[dev]) return cache[dev];
  Card c{0, 0};
  cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&c.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev >= 0 && dev < 64) { cache[dev] = c; ready[dev] = true; }
  return c;
}

inline int64_t pad128(int64_t b) { return (b + 127) / 128 * 128; }

// The finish: F blocks of C columns each (F <= grid, F <= SMs / 2).
void plan_finish(BwdArgs& a, int cols, const Card& c) {
  int f = (cols + kBwdSlice - 1) / kBwdSlice;
  const int half = c.sms / 2 > 1 ? c.sms / 2 : 1;
  if (f > half) f = half;
  if (f > a.nblocks) f = a.nblocks;
  a.C = ((cols + f - 1) / f + 3) / 4 * 4;
  a.F = (cols + a.C - 1) / a.C;
}

// Fills a's plan for rows of TPR threads (sizeof(T) `item`); returns the
// dynamic shared memory a block takes.
int64_t plan_rows(BwdArgs& a, int item, int tpr, const Card& c) {
  const int P = kBwdThreads / tpr;
  const int cols = a.nseg * a.d;
  const int rpt = a.heads[0] + (a.nseg > 1 ? a.heads[1] : 0);
  const int64_t row_b = static_cast<int64_t>(a.d) * item;
  const bool rope = a.cosp != nullptr;
  const int64_t gamma_b = pad128(static_cast<int64_t>(cols) * 4);
  const int64_t ring_max = c.smem - gamma_b - kBwdStatic;
  auto stage_of = [&](int R) {
    int64_t b = 2 * pad128(R * a.heads[0] * row_b);
    if (a.nseg > 1) b += 2 * pad128(R * a.heads[1] * row_b);
    if (a.ds != nullptr) b += pad128(R * a.heads[0] * row_b);
    if (rope) b += 2 * pad128(static_cast<int64_t>(R) * (a.d / 2) * 4);
    return b;
  };
  const int64_t cap = kBwdStageMax < ring_max / 2 ? kBwdStageMax : ring_max / 2;
  // A call reading at most kBwdSmallCall bytes runs in one block: no
  // cross-block finish, whose latency outweighs spreading a few loads.
  const bool small = stage_of(a.tokens) <= kBwdSmallCall;
  int rmax = small ? a.tokens : a.tokens / c.sms;   // else every SM a group
  if (rmax < 1) rmax = 1;
  if (rmax > 1024) rmax = 1024;
  // R: the fewest tokens on the busiest block (bytes balance), then the
  // fewest passes of the block's row slots there, then a stage of at least
  // kBwdStageMin, then the smallest R.
  auto grid_of = [&](int groups) {
    return small ? 1 : (groups < c.sms ? groups : c.sms);
  };
  int best = 1;
  int64_t best_key[3] = {INT64_MAX, INT64_MAX, INT64_MAX};
  for (int R = 1; R <= rmax && (R == 1 || stage_of(R) <= cap); ++R) {
    const int groups = (a.tokens + R - 1) / R;
    const int64_t per = (groups + grid_of(groups) - 1) / grid_of(groups);
    const int64_t key[3] = {per * R, per * ((static_cast<int64_t>(R) * rpt + P - 1) / P),
                            stage_of(R) < kBwdStageMin ? 1 : 0};
    if (key[0] < best_key[0] || (key[0] == best_key[0] && (key[1] < best_key[1] ||
        (key[1] == best_key[1] && key[2] < best_key[2])))) {
      best = R;
      for (int i = 0; i < 3; ++i) best_key[i] = key[i];
    }
  }
  a.R = best;
  const int groups = (a.tokens + a.R - 1) / a.R;
  const int grid = grid_of(groups);
  a.nblocks = grid;
  const int per_block = (groups + grid - 1) / grid;
  const int64_t stage = stage_of(a.R);
  int S = static_cast<int>(ring_max / stage);
  if (S > kBwdMaxStages) S = kBwdMaxStages;
  if (S > per_block) S = per_block;
  if (S < 1) S = 1;
  a.S = S;
  a.stage_bytes = static_cast<int>(stage);
  int64_t off = 0;
  a.off_x[0] = static_cast<int>(off); off += pad128(a.R * a.heads[0] * row_b);
  a.off_dy[0] = static_cast<int>(off); off += pad128(a.R * a.heads[0] * row_b);
  a.off_x[1] = a.off_dy[1] = a.off_ds = a.off_cos = a.off_sin = static_cast<int>(off);
  if (a.nseg > 1) {
    a.off_x[1] = static_cast<int>(off); off += pad128(a.R * a.heads[1] * row_b);
    a.off_dy[1] = static_cast<int>(off); off += pad128(a.R * a.heads[1] * row_b);
  }
  if (a.ds != nullptr) { a.off_ds = static_cast<int>(off); off += pad128(a.R * a.heads[0] * row_b); }
  if (rope) {
    a.off_cos = static_cast<int>(off); off += pad128(static_cast<int64_t>(a.R) * (a.d / 2) * 4);
    a.off_sin = static_cast<int>(off); off += pad128(static_cast<int64_t>(a.R) * (a.d / 2) * 4);
  }
  a.ring_off = static_cast<int>(gamma_b);
  plan_finish(a, cols, c);
  const int sw = tpr < 32 ? kBwdWarps : P;
  int64_t ring = static_cast<int64_t>(S) * stage;
  const int64_t merge = static_cast<int64_t>(a.nseg) * sw * a.d * 4;
  if (ring < merge) ring = merge;
  if (ring < kBwdThreads * 16) ring = kBwdThreads * 16;   // the finish's float4 per thread
  return gamma_b + ring;
}

// Raises the kernel's dynamic shared memory limit to `bytes` (once per
// size it grows to; the default 48 KB counts the static part too).
template <typename K>
int allow_dynamic_smem(K kernel, int64_t bytes, int* allowed) {
  if (bytes <= *allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *allowed = static_cast<int>(bytes);
  return 0;
}

// plan[8]: threads per row (0: the generic loop), tokens per stage,
// stages, blocks, finishing blocks, columns per finisher, dynamic shared
// memory bytes, elements a thread holds.
template <typename T, int TPR, int VPT, bool kRope>
int launch_rows(BwdArgs a, int* plan, cudaStream_t st) {
  const Card c = card_of_current_device();
  const int64_t smem = plan_rows(a, sizeof(T), TPR, c);
  if (plan != nullptr) {
    const int p[8] = {TPR, a.R, a.S, a.nblocks, a.F, a.C, static_cast<int>(smem),
                      VPT * Vec<T>::N};
    for (int i = 0; i < 8; ++i) plan[i] = p[i];
    return 0;
  }
  if (smem + kBwdStatic > c.smem) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;
  const int bad = allow_dynamic_smem(norm_bwd_rows<T, TPR, VPT, kRope>, smem, &allowed);
  if (bad) return bad;
  norm_bwd_rows<T, TPR, VPT, kRope><<<a.nblocks, kBwdThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_generic(BwdArgs a, int* plan, cudaStream_t st) {
  if (a.d > kBwdMaxD || a.cosp != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Card c = card_of_current_device();
  const int grid = a.tokens < c.sms ? a.tokens : c.sms;
  a.nblocks = grid;
  a.R = 1;
  a.S = 0;
  plan_finish(a, a.d, c);
  const int64_t smem = static_cast<int64_t>(a.d) * sizeof(float);
  if (plan != nullptr) {
    const int p[8] = {0, 1, 0, a.nblocks, a.F, a.C, static_cast<int>(smem), 0};
    for (int i = 0; i < 8; ++i) plan[i] = p[i];
    return 0;
  }
  static int allowed = 0;
  const int bad = allow_dynamic_smem(norm_bwd_rows_generic<T>, smem, &allowed);
  if (bad) return bad;
  norm_bwd_rows_generic<T><<<a.nblocks, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The smallest power of two t with t * vpt >= nv.
inline int threads_per_row(int nv, int vpt) {
  int t = 1;
  while (t * vpt < nv) t <<= 1;
  return t;
}

// Rows of up to kBwdRegMaxD elements in registers, TPR threads a row (a
// power of two, 1..256); the rotary entry's head rows of 8..128 vectors
// with 2 vectors a thread; plain rows above kBwdRegMaxD, up to kBwdMaxD,
// through the generic loop.
template <typename T>
int launch_bwd_any(const BwdArgs& a, bool rope, int* plan, cudaStream_t st) {
  constexpr int N = Vec<T>::N;
  constexpr int VPT = kBwdRegElems / N;
  const int nv = a.d / N;
  if (rope) {
    switch (nv) {
      case 8: return launch_rows<T, 4, kBwdRopeVPT, true>(a, plan, st);
      case 16: return launch_rows<T, 8, kBwdRopeVPT, true>(a, plan, st);
      case 32: return launch_rows<T, 16, kBwdRopeVPT, true>(a, plan, st);
      case 64: return launch_rows<T, 32, kBwdRopeVPT, true>(a, plan, st);
      case 128: return launch_rows<T, 64, kBwdRopeVPT, true>(a, plan, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (a.d > kBwdRegMaxD) return launch_bwd_generic<T>(a, plan, st);
  switch (threads_per_row(nv, VPT)) {
    case 1: return launch_rows<T, 1, VPT, false>(a, plan, st);
    case 2: return launch_rows<T, 2, VPT, false>(a, plan, st);
    case 4: return launch_rows<T, 4, VPT, false>(a, plan, st);
    case 8: return launch_rows<T, 8, VPT, false>(a, plan, st);
    case 16: return launch_rows<T, 16, VPT, false>(a, plan, st);
    case 32: return launch_rows<T, 32, VPT, false>(a, plan, st);
    case 64: return launch_rows<T, 64, VPT, false>(a, plan, st);
    case 128: return launch_rows<T, 128, VPT, false>(a, plan, st);
    case 256: return launch_rows<T, 256, VPT, false>(a, plan, st);
    case 512: return launch_rows<T, 512, VPT, false>(a, plan, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

BwdArgs bwd_args(const void* x0, const void* dy0, const void* ds,
                 const void* g0, void* dx0, void* dg0, int tokens, int heads0,
                 int d, float eps, int gdtype, void* scratch) {
  BwdArgs a = {};
  a.x[0] = x0; a.dy[0] = dy0; a.ds = ds; a.dx[0] = dx0;
  a.gamma[0] = g0; a.dgamma[0] = dg0;
  a.heads[0] = heads0; a.heads[1] = 0;
  a.tokens = tokens; a.d = d; a.nseg = 1; a.gdtype = gdtype; a.eps = eps;
  a.counter = static_cast<unsigned*>(scratch);
  a.partials = scratch == nullptr ? nullptr
      : reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) + kBwdHeader);
  return a;
}

int run_bwd(const BwdArgs& a, int dtype, bool rope, int* plan, void* stream) {
  if (a.tokens == 0) return 0;
  if ((a.gdtype != 0 && a.gdtype != 1) || (dtype != 0 && dtype != 1) || a.d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = dtype == 0 ? launch_bwd_any<float>(a, rope, plan, st)
                             : launch_bwd_any<__nv_bfloat16>(a, rope, plan, st);
  if (bad) return bad;
  return plan != nullptr ? 0 : static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every row pointer contiguous and
// 16-byte aligned, d a multiple of 8 (the wrapper checks).  The forward
// norms take the block's warps (1, 2, 4 or 8; 8 by default): every value
// gives the same bits.  Each returns the CUDA error code of its launch (0
// on success).
static bool warps_ok(int warps) {
  return warps == 1 || warps == 2 || warps == 4 || warps == kWarps;
}

extern "C" int repro_rmsnorm(const void* x, const void* gamma, void* out,
                             int rows, int d, float eps, int warps, int dtype,
                             void* stream) {
  if (!warps_ok(warps)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  if (dtype == 0) launch_norm<float, false>(x, nullptr, g, nullptr, out, rows, d, eps, warps, s);
  else launch_norm<__nv_bfloat16, false>(x, nullptr, g, nullptr, out, rows, d, eps, warps, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_add_rmsnorm(const void* x, const void* y,
                                 const void* gamma, void* s_out, void* out,
                                 int rows, int d, float eps, int warps,
                                 int dtype, void* stream) {
  if (!warps_ok(warps)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  if (dtype == 0) launch_norm<float, true>(x, y, g, s_out, out, rows, d, eps, warps, s);
  else launch_norm<__nv_bfloat16, true>(x, y, g, s_out, out, rows, d, eps, warps, s);
  return static_cast<int>(cudaGetLastError());
}

// q (nq rows = B*L*hq), k (nk rows = B*L*hkv), rows of d; cos/sin (B*L,
// d/2) f32.  d * itemsize / 16 must be 8..128, a power of two.
extern "C" int repro_qk_norm_rope(const void* q, const void* k,
                                  const void* gamma_q, const void* gamma_k,
                                  const void* cosv, const void* sinv,
                                  void* q_out, void* k_out, int nq, int nk,
                                  int hq, int hkv, int d, float eps,
                                  int dtype, void* stream) {
  if (nq + nk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gq = static_cast<const float*>(gamma_q);
  const float* gk = static_cast<const float*>(gamma_k);
  const float* cs = static_cast<const float*>(cosv);
  const float* sn = static_cast<const float*>(sinv);
  const int bad = dtype == 0
      ? launch_qk_any<float>(q, k, gq, gk, cs, sn, q_out, k_out, nq, nk, hq, hkv, d, eps, s)
      : launch_qk_any<__nv_bfloat16>(q, k, gq, gk, cs, sn, q_out, k_out, nq, nk, hq, hkv, d, eps, s);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// Backward entries, one kernel a call.  dtype is x's type, gdtype gamma's
// (and dgamma's): 0 = float32, 1 = bfloat16.  `scratch`: the buffer of this
// device and stream (kernels/rmsnorm.py): kBwdHeader bytes, zero when it is
// made and left zero by every call, then min(tokens, SMs) x cols
// floats of partial rows (cols = d; the rotary entry 2 d).  d: a multiple
// of 8 of at most kBwdMaxD (the rotary entry: 8..128 vectors).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* dy,
                                 const void* gamma, void* dx, void* dgamma,
                                 void* scratch, int rows, int d, float eps,
                                 int dtype, int gdtype, void* stream) {
  const BwdArgs a = bwd_args(x, dy, nullptr, gamma, dx, dgamma, rows, 1, d,
                             eps, gdtype, scratch);
  return run_bwd(a, dtype, false, nullptr, stream);
}

// s: add_rmsnorm's residual (its norm's input); ds: the gradient of s, or
// null.  dx is the gradient of both x and y.
extern "C" int repro_add_rmsnorm_bwd(const void* s, const void* dy,
                                     const void* ds, const void* gamma,
                                     void* dx, void* dgamma, void* scratch,
                                     int rows, int d, float eps, int dtype,
                                     int gdtype, void* stream) {
  const BwdArgs a = bwd_args(s, dy, ds, gamma, dx, dgamma, rows, 1, d, eps,
                             gdtype, scratch);
  return run_bwd(a, dtype, false, nullptr, stream);
}

// q, k: the forward's inputs; dq_out, dk_out: gradients of q', k'; cos/sin
// (B*L, d/2) f32, 16-byte aligned.
extern "C" int repro_qk_norm_rope_bwd(const void* q, const void* k,
                                      const void* dq_out, const void* dk_out,
                                      const void* gamma_q, const void* gamma_k,
                                      const void* cosv, const void* sinv,
                                      void* dq, void* dk, void* dgamma_q,
                                      void* dgamma_k, void* scratch,
                                      int nq, int nk, int hq, int hkv, int d,
                                      float eps, int dtype, int gdtype,
                                      void* stream) {
  const int tokens = hq > 0 ? nq / hq : (hkv > 0 ? nk / hkv : 0);
  BwdArgs a = bwd_args(q, dq_out, nullptr, gamma_q, dq, dgamma_q, tokens, hq,
                       d, eps, gdtype, scratch);
  a.x[1] = k; a.dy[1] = dk_out; a.dx[1] = dk;
  a.gamma[1] = gamma_k; a.dgamma[1] = dgamma_k;
  a.heads[1] = hkv; a.nseg = 2;
  a.cosp = static_cast<const float*>(cosv);
  a.sinp = static_cast<const float*>(sinv);
  return run_bwd(a, dtype, true, nullptr, stream);
}

// The plan a backward call of this shape takes, into plan[8] (threads per
// row, 0 for the generic loop; tokens per stage; stages; blocks; finishing
// blocks; columns per finisher; dynamic shared memory bytes; elements a
// thread holds), on the current device.  Launches nothing.
extern "C" int repro_rmsnorm_bwd_plan(int tokens, int heads0, int heads1,
                                      int d, int dtype, int has_ds, int rope,
                                      int* plan) {
  static const float dummy[4] = {0.f, 0.f, 0.f, 0.f};
  BwdArgs a = bwd_args(dummy, dummy, has_ds ? dummy : nullptr, dummy, nullptr,
                       nullptr, tokens, heads0, d, 1e-6f, 0, nullptr);
  if (rope) {
    a.heads[1] = heads1; a.nseg = 2;
    a.cosp = a.sinp = dummy;
  }
  for (int i = 0; i < 8; ++i) plan[i] = 0;
  return run_bwd(a, dtype, rope != 0, plan, nullptr);
}

#ifdef REPRO_BWD_STAMPS
// Measurement builds: the stamps of the last backward call (blocks x
// kBwdStamps ns, 0 where a block did not reach a point) into out, then
// cleared for the next call.
extern "C" int repro_rmsnorm_bwd_stamps(unsigned long long* out, int blocks) {
  if (blocks < 0 || blocks > kBwdStampBlocks) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(unsigned long long) * kBwdStamps * blocks;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_bwd_stamps, bytes);
  static unsigned long long zeros[kBwdStampBlocks][kBwdStamps];
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_bwd_stamps, zeros, sizeof(zeros));
  return static_cast<int>(e);
}
#endif
