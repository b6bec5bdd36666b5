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
// all in f32, dx rounded once to x's type.  The rotary entry first
// un-rotates dy (rotate-half is orthogonal: its transpose turns by -angle)
// and keeps the result in f32 for the norm's backward.
//
// What bounds it on this card: bytes.  It reads x, dy (and ds) once and
// writes dx once, plus one f32 partial row of dgamma per block; at the
// training path's 4096 x 1024 bf16 rows that is 24 MB against ~2 MB of
// partials.
//
// Design.  The forward's row layout (Layout<NV>): a row in the registers of
// LPR lanes, two row sums by butterfly shuffles.  A block walks row groups
// grp = blk, blk + blocks, ... so every lane keeps its columns' dy * xh in
// registers across its rows.  dgamma is reduced without atomics, in a fixed
// order: the row slots of a warp by shuffles, the warps through shared
// memory in warp order, one f32 partial row per block; a second kernel in
// the same call sums the partial rows column by column (sum_partial_rows).
// The grid depends only on the shape, so two calls give the same bits.
// The rotary entry runs q rows and k rows in separate blocks (two
// segments), each with its own partial rows and dgamma.
// Rows of 8..256 vectors (a power of two: d 64..2048 in bf16, 32..1024 in
// f32) take that compile-time layout; the rotary entry's head rows 8..128,
// as its forward.  Rows of any other width that is a multiple of 8, up to
// kBwdMaxD, take norm_bwd_rows_generic: one block per row at a time, each
// thread a strided set of the row's vectors, three passes over the row
// (the sum of squares; dgamma's terms and the dot; dx), the two row sums
// reduced over the block in warp order, and dgamma's terms accumulated in
// the block's partial row in shared memory, each column by the one thread
// that owns it, rows in order -- so the order is fixed there too.

constexpr int kBwdMaxBlocks = 264;   // per segment: 2 blocks per SM on 132 SMs
constexpr int kBwdMaxD = 49152;      // the generic path's partial row: 192 KB of shared memory

struct BwdSeg {
  const void* x;     // the forward's input rows (add_rmsnorm: its sum s)
  const void* dy;    // gradient of the normed rows (rotated rows for rope)
  const void* ds;    // add_rmsnorm: gradient of s, added to dx; else null
  const float* gamma;
  void* dx;
  float* dgamma;     // (D,) f32
  int rows;
  int heads;         // rope: heads per token
  int blocks;        // blocks of this segment
};

__host__ __device__ inline int bwd_blocks(int rows, int rows_per_block) {
  const int groups = (rows + rows_per_block - 1) / rows_per_block;
  return groups < kBwdMaxBlocks ? groups : kBwdMaxBlocks;
}

// The second pass: dgamma of each segment, the sum of its blocks' partial
// rows in a fixed order.  Block (x, seg) takes 32 columns of segment seg;
// its 8 warps sum rows w, w + 8, ... in row order (loads unrolled, adds in
// order), then warp 0 adds the warps' sums in warp order.
constexpr int kSumCols = 32;
constexpr int kSumWarps = kThreads / kSumCols;

__global__ void __launch_bounds__(kThreads)
sum_partial_rows(const float* __restrict__ partials, int n0, int n1, int d,
                 float* __restrict__ out0, float* __restrict__ out1) {
  __shared__ float red[kSumWarps][kSumCols];
  const int seg = blockIdx.y;
  const int n = seg == 0 ? n0 : n1;
  float* out = seg == 0 ? out0 : out1;
  const int c = threadIdx.x % kSumCols;
  const int w = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + c;
  const float* p = partials + static_cast<int64_t>(seg == 0 ? 0 : n0) * d + col;
  float t = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int b = w; b < n; b += kSumWarps) t += __ldg(p + static_cast<int64_t>(b) * d);
  }
  red[w][c] = t;
  __syncthreads();
  if (w == 0 && col < d) {
    for (int k = 1; k < kSumWarps; ++k) t += red[k][c];
    out[col] = t;
  }
}

template <typename T, int NV, bool kRope>
__global__ void __launch_bounds__(kThreads)
norm_bwd_rows(BwdSeg s0, BwdSeg s1, const float* __restrict__ cosp,
              const float* __restrict__ sinp, float* __restrict__ partials,
              float eps) {
  using L = Layout<NV>;
  constexpr int N = Vec<T>::N;
  constexpr int D = NV * N;
  constexpr int H = D / 2;
  static_assert(NV <= 256, "backward register layouts hold at most 256 vectors");
  __shared__ float s_sum[D];
  const bool first = blockIdx.x < s0.blocks;
  const BwdSeg sg = first ? s0 : s1;
  const int blk = first ? blockIdx.x : blockIdx.x - s0.blocks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % L::LPR;
  const T* x = static_cast<const T*>(sg.x);
  const T* dy = static_cast<const T*>(sg.dy);
  const T* ds = static_cast<const T*>(sg.ds);
  T* dx = static_cast<T*>(sg.dx);

  float acc[L::VPL][N];
#pragma unroll
  for (int k = 0; k < L::VPL; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[k][i] = 0.f;

  const int groups = (sg.rows + L::RPB - 1) / L::RPB;
  for (int grp = blk; grp < groups; grp += sg.blocks) {   // uniform per block
    const int row = (grp * kWarps + warp) * L::RPW + lane / L::LPR;
    const bool live = row < sg.rows;
    const int64_t base = static_cast<int64_t>(row) * D;
    float v[L::VPL][N], g[L::VPL][N];
    if (live) {
#pragma unroll
      for (int k = 0; k < L::VPL; ++k) {
        const int e = (k * L::LPR + sub) * N;
        Vec<T>::load(x + base + e, v[k]);
        Vec<T>::load(dy + base + e, g[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < L::VPL; ++k)
#pragma unroll
        for (int i = 0; i < N; ++i) v[k][i] = g[k][i] = 0.f;
    }
    if constexpr (kRope) {
      // dh1 = do1 cos + do2 sin, dh2 = do2 cos - do1 sin.
      float c[L::VPL][N], sn[L::VPL][N], p[L::VPL][N];
      const int64_t tok = live ? row / sg.heads : 0;
#pragma unroll
      for (int k = 0; k < L::VPL; ++k) {
        const int e = (k * L::LPR + sub) * N;
        if (live) {
          load_f32<N>(cosp + tok * H + (e & (H - 1)), c[k]);
          load_f32<N>(sinp + tok * H + (e & (H - 1)), sn[k]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) c[k][i] = sn[k][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < L::VPL; ++k)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          if constexpr (NV / 2 < L::LPR) {
            p[k][i] = __shfl_xor_sync(kFull, g[k][i], NV / 2);
          } else {
            p[k][i] = g[k ^ (NV / 2 / L::LPR)][i];
          }
        }
#pragma unroll
      for (int k = 0; k < L::VPL; ++k) {
        const bool first_half = (k * L::LPR + sub) * N < H;
#pragma unroll
        for (int i = 0; i < N; ++i)
          g[k][i] = first_half ? g[k][i] * c[k][i] + p[k][i] * sn[k][i]
                               : g[k][i] * c[k][i] - p[k][i] * sn[k][i];
      }
    }
    const float r = 1.f / rms_of(row_sumsq<L::LPR>(v), D, eps);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < L::VPL; ++k) {
      float gam[N];
      load_f32<N>(sg.gamma + (k * L::LPR + sub) * N, gam);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[k][i] *= r;                              // xh
        acc[k][i] = fmaf(g[k][i], v[k][i], acc[k][i]);
        g[k][i] *= gam[i];                         // dy * gamma
        dot = fmaf(g[k][i], v[k][i], dot);
      }
    }
#pragma unroll
    for (int off = L::LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
    const float m = dot / static_cast<float>(D);
    if (live) {
#pragma unroll
      for (int k = 0; k < L::VPL; ++k) {
        const int e = (k * L::LPR + sub) * N;
        float o[N], w[N];
        if (ds != nullptr) {
          Vec<T>::load(ds + base + e, w);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) w[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = (g[k][i] - v[k][i] * m) * r + w[i];
        Vec<T>::store(dx + base + e, o);
      }
    }
  }

  // The warp's row slots, then the block's warps in order.
#pragma unroll
  for (int off = 16; off >= L::LPR; off >>= 1)
#pragma unroll
    for (int k = 0; k < L::VPL; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[k][i] += __shfl_xor_sync(kFull, acc[k][i], off);
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && lane < L::LPR) {
#pragma unroll
      for (int k = 0; k < L::VPL; ++k)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int e = (k * L::LPR + lane) * N + i;
          s_sum[e] = w == 0 ? acc[k][i] : s_sum[e] + acc[k][i];
        }
    }
    __syncthreads();
  }
  float* part = partials + static_cast<int64_t>(blockIdx.x) * D;
  for (int e = threadIdx.x; e < D; e += kThreads) part[e] = s_sum[e];
}

template <typename T, int NV, bool kRope>
void launch_bwd(BwdSeg s0, BwdSeg s1, const float* cs, const float* sn,
                float* partials, float eps, cudaStream_t st) {
  constexpr int D = NV * Vec<T>::N;
  s0.blocks = bwd_blocks(s0.rows, Layout<NV>::RPB);
  s1.blocks = bwd_blocks(s1.rows, Layout<NV>::RPB);
  norm_bwd_rows<T, NV, kRope><<<s0.blocks + s1.blocks, kThreads, 0, st>>>(
      s0, s1, cs, sn, partials, eps);
  const dim3 grid((D + kSumCols - 1) / kSumCols, s1.blocks > 0 ? 2 : 1);
  sum_partial_rows<<<grid, kThreads, 0, st>>>(partials, s0.blocks, s1.blocks,
                                               D, s0.dgamma, s1.dgamma);
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

// Rows of any width d (a multiple of 8), segment s0 only (no rotary entry):
// block blk takes rows blk, blk + blocks, ...; thread t the vectors t,
// t + kThreads, ... of each.  The same arithmetic, in the same order per
// element, as norm_bwd_rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_bwd_rows_generic(BwdSeg sg, float* __restrict__ partials, int d,
                      float eps) {
  extern __shared__ float s_acc[];   // d floats: this block's dgamma terms
  __shared__ float red[kWarps];
  constexpr int N = Vec<T>::N;
  const int nvec = d / N;
  const T* x = static_cast<const T*>(sg.x);
  const T* dy = static_cast<const T*>(sg.dy);
  const T* ds = static_cast<const T*>(sg.ds);
  T* dx = static_cast<T*>(sg.dx);
  for (int vi = threadIdx.x; vi < nvec; vi += kThreads)
#pragma unroll
    for (int i = 0; i < N; ++i) s_acc[vi * N + i] = 0.f;
  for (int row = blockIdx.x; row < sg.rows; row += sg.blocks) {
    const int64_t base = static_cast<int64_t>(row) * d;
    float ss = 0.f;
    for (int vi = threadIdx.x; vi < nvec; vi += kThreads) {
      float v[N];
      Vec<T>::load(x + base + vi * N, v);
#pragma unroll
      for (int i = 0; i < N; ++i) ss = fmaf(v[i], v[i], ss);
    }
    const float r = 1.f / rms_of(block_sum(ss, red), d, eps);
    float dot = 0.f;
    for (int vi = threadIdx.x; vi < nvec; vi += kThreads) {
      float v[N], g[N], gam[N];
      Vec<T>::load(x + base + vi * N, v);
      Vec<T>::load(dy + base + vi * N, g);
      load_f32<N>(sg.gamma + vi * N, gam);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] *= r;                                 // xh
        s_acc[vi * N + i] = fmaf(g[i], v[i], s_acc[vi * N + i]);
        g[i] *= gam[i];                            // dy * gamma
        dot = fmaf(g[i], v[i], dot);
      }
    }
    const float m = block_sum(dot, red) / static_cast<float>(d);
    for (int vi = threadIdx.x; vi < nvec; vi += kThreads) {
      float v[N], g[N], gam[N], w[N], o[N];
      Vec<T>::load(x + base + vi * N, v);
      Vec<T>::load(dy + base + vi * N, g);
      load_f32<N>(sg.gamma + vi * N, gam);
      if (ds != nullptr) {
        Vec<T>::load(ds + base + vi * N, w);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) w[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] *= r;
        g[i] *= gam[i];
        o[i] = (g[i] - v[i] * m) * r + w[i];
      }
      Vec<T>::store(dx + base + vi * N, o);
    }
  }
  float* part = partials + static_cast<int64_t>(blockIdx.x) * d;
  for (int vi = threadIdx.x; vi < nvec; vi += kThreads)
#pragma unroll
    for (int i = 0; i < N; ++i) part[vi * N + i] = s_acc[vi * N + i];
}

template <typename T>
int launch_bwd_generic(BwdSeg s0, int d, float* partials, float eps,
                       cudaStream_t st) {
  if (d > kBwdMaxD) return static_cast<int>(cudaErrorInvalidValue);
  s0.blocks = s0.rows < kBwdMaxBlocks ? s0.rows : kBwdMaxBlocks;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_bwd_rows_generic<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  norm_bwd_rows_generic<T><<<s0.blocks, kThreads, smem, st>>>(s0, partials, d,
                                                              eps);
  const dim3 grid((d + kSumCols - 1) / kSumCols, 1);
  sum_partial_rows<<<grid, kThreads, 0, st>>>(partials, s0.blocks, 0, d,
                                               s0.dgamma, nullptr);
  return 0;
}

// Row widths of 8..256 16-byte vectors (a power of two; the rotary entry
// 8..128) in a register layout; other widths, not for the rotary entry,
// through the generic loop.
template <typename T, bool kRope>
int launch_bwd_any(const BwdSeg& s0, const BwdSeg& s1, int d, const float* cs,
                   const float* sn, float* partials, float eps,
                   cudaStream_t st) {
  switch (d * static_cast<int>(sizeof(T)) / 16) {
    case 8: launch_bwd<T, 8, kRope>(s0, s1, cs, sn, partials, eps, st); break;
    case 16: launch_bwd<T, 16, kRope>(s0, s1, cs, sn, partials, eps, st); break;
    case 32: launch_bwd<T, 32, kRope>(s0, s1, cs, sn, partials, eps, st); break;
    case 64: launch_bwd<T, 64, kRope>(s0, s1, cs, sn, partials, eps, st); break;
    case 128: launch_bwd<T, 128, kRope>(s0, s1, cs, sn, partials, eps, st); break;
    case 256:
      if constexpr (!kRope) {
        launch_bwd<T, 256, kRope>(s0, s1, cs, sn, partials, eps, st);
        break;
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    default:
      if constexpr (!kRope) {
        return launch_bwd_generic<T>(s0, d, partials, eps, st);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
  }
  return 0;
}

BwdSeg seg(const void* x, const void* dy, const void* ds, const void* gamma,
           void* dx, void* dgamma, int rows, int heads) {
  BwdSeg s;
  s.x = x; s.dy = dy; s.ds = ds;
  s.gamma = static_cast<const float*>(gamma);
  s.dx = dx; s.dgamma = static_cast<float*>(dgamma);
  s.rows = rows; s.heads = heads; s.blocks = 0;
  return s;
}

int run_bwd(const BwdSeg& s0, const BwdSeg& s1, int d, const void* cs,
            const void* sn, void* partials, float eps, int dtype, bool rope,
            void* stream) {
  if (s0.rows + s1.rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cs);
  const float* s = static_cast<const float*>(sn);
  float* part = static_cast<float*>(partials);
  int bad;
  if (dtype == 0) {
    bad = rope ? launch_bwd_any<float, true>(s0, s1, d, c, s, part, eps, st)
               : launch_bwd_any<float, false>(s0, s1, d, c, s, part, eps, st);
  } else {
    bad = rope ? launch_bwd_any<__nv_bfloat16, true>(s0, s1, d, c, s, part, eps, st)
               : launch_bwd_any<__nv_bfloat16, false>(s0, s1, d, c, s, part, eps, st);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
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

// Backward entries, two launches each (the rows, then the sum of dgamma's
// partial rows).  `partials` holds (blocks of all segments) x d floats, at
// most kBwdMaxBlocks per segment.  dgamma is f32.  d: a multiple of 8 of
// at most kBwdMaxD (the rotary entry: 8..128 vectors).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* dy,
                                 const void* gamma, void* dx, void* dgamma,
                                 void* partials, int rows, int d, float eps,
                                 int dtype, void* stream) {
  const BwdSeg s0 = seg(x, dy, nullptr, gamma, dx, dgamma, rows, 1);
  const BwdSeg s1 = seg(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1);
  return run_bwd(s0, s1, d, nullptr, nullptr, partials, eps, dtype,
                 false, stream);
}

// s: add_rmsnorm's residual (its norm's input); ds: the gradient of s, or
// null.  dx is the gradient of both x and y.
extern "C" int repro_add_rmsnorm_bwd(const void* s, const void* dy,
                                     const void* ds, const void* gamma,
                                     void* dx, void* dgamma, void* partials,
                                     int rows, int d, float eps, int dtype,
                                     void* stream) {
  const BwdSeg s0 = seg(s, dy, ds, gamma, dx, dgamma, rows, 1);
  const BwdSeg s1 = seg(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1);
  return run_bwd(s0, s1, d, nullptr, nullptr, partials, eps, dtype,
                 false, stream);
}

// q, k: the forward's inputs; dq_out, dk_out: gradients of q', k'.
extern "C" int repro_qk_norm_rope_bwd(const void* q, const void* k,
                                      const void* dq_out, const void* dk_out,
                                      const void* gamma_q, const void* gamma_k,
                                      const void* cosv, const void* sinv,
                                      void* dq, void* dk, void* dgamma_q,
                                      void* dgamma_k, void* partials,
                                      int nq, int nk, int hq, int hkv, int d,
                                      float eps, int dtype, void* stream) {
  const BwdSeg s0 = seg(q, dq_out, nullptr, gamma_q, dq, dgamma_q, nq, hq);
  const BwdSeg s1 = seg(k, dk_out, nullptr, gamma_k, dk, dgamma_k, nk, hkv);
  return run_bwd(s0, s1, d, cosv, sinv, partials, eps, dtype, true,
                 stream);
}
