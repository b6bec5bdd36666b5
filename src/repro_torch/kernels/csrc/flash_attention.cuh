// Flash attention forward for Hopper (sm_90a): the loop shared by the
// contiguous kernel (flash_attention.cu) and the paged one
// (paged_attention.cu).
//
// Function: online-softmax attention, causal and sliding-window masks, kv
// padding, queries end-aligned to the kv length (row r of lane b sits at
// position kv_lens[b] - Sq + r), GQA by reading kv head h / (Hq / Hkv)
// with no repeat, fully masked tiles skipped, and a query row with no
// visible key written as 0.  The two kernels differ only in where key kj
// of lane b lives, which the KV policy (ContiguousKV, PagedKV) answers;
// the tile schedule, the warp split and the order of every sum are this
// one template's, so over the same K/V values the paged kernel returns
// the contiguous kernel's output bit for bit.
//
// What bounds it on this card: at decode, bytes.  Each lane and layer must
// read 2 * Hkv * kv_len * D elements of K/V for Hq * D * 4 * kv_len flops,
// about one flop per byte in bf16, far below the card's ~295 flops per byte
// balance.  At prefill with long chunks the flops grow with Sq and the
// tensor cores would become the limit; this first kernel does its
// products on the CUDA cores in f32 (wgmma and TMA are later work).
//
// Design: the TPU kernels walk kv blocks in a sequential grid dimension and
// carry the softmax state in VMEM scratch.  Here one block of 8 warps
// owns (lane b, q head h, a tile of bq query rows) and walks the kv tiles
// in a loop, carrying max, denominator and accumulator in f32 registers.
// Tiles of 64 keys are staged through shared memory as f32 (K rows padded
// by one word so that lanes reading different keys hit different banks),
// loaded by all 256 threads with 16-byte vector loads (a key row of D
// elements is contiguous in both layouts, so a page edge never splits a
// vector).  Only tiles that hold a visible key are loaded at all: tiles
// past kv_lens[b], above the causal diagonal or before the window never
// leave device memory — the structural analogue of the TPU kernels'
// skipped grid steps.
//   * bq = 8 (prefill): warp w scores row w against all 64 keys of a tile,
//     one key per lane, then accumulates P.V with each lane owning D/32
//     output columns.
//   * bq < 8 (decode, Sq = 1; verify, Sq = 2..7): the 8/bq warps of a row
//     split each tile's keys between them, keep separate softmax states,
//     and merge them through shared memory at the end (split-K inside the
//     block), so the whole block works on the query rows it owns.
// No allocation, no synchronisation with the host; launched on the
// caller's stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_fa {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;          // keys per shared-memory tile
constexpr int kMaxD = 128;
constexpr int kPerLane = kMaxD / 32;

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static float scalar(float x) { return x; }
  __device__ static float from(float x) { return x; }
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
  __device__ static float scalar(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from(float x) { return __float2bfloat16_rn(x); }
};

// K/V of shape (B, Hkv, Skv, D): key kj of lane b, head hk is row
// (b, hk, kj).  Rows past Skv read as zeros.
template <typename T> struct ContiguousKV {
  const T* k;
  const T* v;
  int Hkv, Skv, D;

  struct Lane {
    const T* kb;
    const T* vb;
    int Skv, D;
    __device__ bool row(int kj, int64_t& off) const {
      if (kj >= Skv) return false;
      off = static_cast<int64_t>(kj) * D;
      return true;
    }
  };

  __device__ Lane lane(int b, int hk, int /*kv_len*/) const {
    const int64_t base = (static_cast<int64_t>(b) * Hkv + hk) * Skv * D;
    return Lane{k + base, v + base, Skv, D};
  }
};

// The paged pool's flat token-major stores (n_pages * ps, Hkv, D): key kj
// of lane b sits at store row table[b, kj / ps] * ps + kj % ps.  Keys at
// or past the lane's length are never read (their pages may be unmapped
// scratch or garbage).  The page pool checks every entry against the
// store on its host copy before the upload; an entry outside
// [0, n_pages) that still arrives here traps as the last guard instead
// of reading outside the store (the error is sticky to the context).
template <typename T> struct PagedKV {
  const T* k;
  const T* v;
  const int* table;              // (B, n_blocks) int32
  int n_blocks, ps, n_pages, Hkv, D;

  struct Lane {
    const T* kb;
    const T* vb;
    const int* tab;
    int ps, n_pages, limit;
    int64_t stride;              // elements per store row: Hkv * D
    __device__ bool row(int kj, int64_t& off) const {
      if (kj >= limit) return false;
      const int pid = tab[kj / ps];
      if (pid < 0 || pid >= n_pages) __trap();
      off = (static_cast<int64_t>(pid) * ps + kj % ps) * stride;
      return true;
    }
  };

  __device__ Lane lane(int b, int hk, int kv_len) const {
    const int64_t head = static_cast<int64_t>(hk) * D;
    return Lane{k + head, v + head,
                table + static_cast<int64_t>(b) * n_blocks, ps, n_pages,
                min(kv_len, n_blocks * ps), static_cast<int64_t>(Hkv) * D};
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

inline size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(kBK) * (d + 1) + static_cast<size_t>(kBK) * d +
          static_cast<size_t>(kWarps) * d + kWarps * kBK + 2 * kWarps +
          static_cast<size_t>(kWarps) * d);
}

// Skv is the logical kv extent: the contiguous K/V's length, or
// n_blocks * ps for the paged stores.
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, KV kv,
                 const int* __restrict__ kv_lens, T* __restrict__ out,
                 int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                 int causal, int window, int bq) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];
  float* Ks = smem;                      // kBK x (D + 1)
  float* Vs = Ks + kBK * (D + 1);        // kBK x D
  float* Qs = Vs + kBK * D;              // kWarps x D
  float* Ps = Qs + kWarps * D;           // kWarps x kBK
  float* Ms = Ps + kWarps * kBK;         // kWarps
  float* Ls = Ms + kWarps;               // kWarps
  float* As = Ls + kWarps;               // kWarps x D

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * bq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = kWarps / bq;         // warps per query row
  const int kpw = kBK / split;           // keys of a tile per warp
  const int rib = warp / split, part = warp % split;
  const int r = r0 + rib;
  const bool row_ok = r < Sq;
  const int kv_len = kv_lens[b];
  const int qpos = kv_len - Sq + r;

  const int64_t qbase = (static_cast<int64_t>(b) * Hq + h) * Sq * D;
  const typename KV::Lane src = kv.lane(b, hk, kv_len);

  for (int i = threadIdx.x; i < bq * D; i += kThreads) {
    const int rr = i / D, dd = i % D, gr = r0 + rr;
    Qs[rr * D + dd] = gr < Sq ? Vec<T>::scalar(q[qbase + static_cast<int64_t>(gr) * D + dd]) : 0.f;
  }

  // kv range holding a visible key for some row of this block.
  const int r_last = min(r0 + bq, Sq) - 1;
  int hi = min(kv_len, Skv);
  if (causal) hi = min(hi, kv_len - Sq + r_last + 1);
  int lo = 0;
  if (window > 0) lo = max(0, kv_len - Sq + r0 - window + 1);
  const int t_start = (lo / kBK) * kBK;

  float m = -INFINITY, l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  const int nvec_row = D / N;
  for (int k0 = t_start; k0 < hi; k0 += kBK) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * nvec_row; i += kThreads) {
      const int row = i / nvec_row, c = (i % nvec_row) * N, kj = k0 + row;
      float fk[N], fv[N];
      int64_t off;
      if (src.row(kj, off)) {
        Vec<T>::load(src.kb + off + c, fk);
        Vec<T>::load(src.vb + off + c, fv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) { fk[e] = 0.f; fv[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        Ks[row * (D + 1) + c + e] = fk[e];
        Vs[row * D + c + e] = fv[e];
      }
    }
    __syncthreads();

    float s_loc[2];
    float tile_max = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int jj = lane + 32 * t;
      s_loc[t] = -INFINITY;
      if (row_ok && jj < kpw) {
        const int kidx = part * kpw + jj, kj = k0 + kidx;
        bool vis = kj < kv_len && kj < Skv;
        if (causal) vis = vis && kj <= qpos;
        if (window > 0) vis = vis && (qpos - kj) < window;
        if (vis) {
          const float* qr = Qs + rib * D;
          const float* kr = Ks + kidx * (D + 1);
          float dot = 0.f;
          for (int dd = 0; dd < D; ++dd) dot += qr[dd] * kr[dd];
          s_loc[t] = dot * scale;
          tile_max = fmaxf(tile_max, s_loc[t]);
        }
      }
    }
    tile_max = warp_max(tile_max);
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;    // nothing visible to this warp yet
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int jj = lane + 32 * t;
      if (jj < kpw) {
        const float p = (s_loc[t] == -INFINITY) ? 0.f : expf(s_loc[t] - m_new);
        Ps[warp * kBK + jj] = p;
        psum += p;
      }
    }
    psum = warp_sum(psum);
    l = alpha * l + psum;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= alpha;
    for (int jj = 0; jj < kpw; ++jj) {
      const float p = Ps[warp * kBK + jj];
      if (p != 0.f) {
        const float* vr = Vs + (part * kpw + jj) * D;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int dd = lane + 32 * i;
          if (dd < D) acc[i] += p * vr[dd];
        }
      }
    }
    __syncwarp();
    m = m_new;
  }

  T* orow = out + qbase + static_cast<int64_t>(r) * D;
  if (split == 1) {
    if (row_ok) {
      const float inv = (l == 0.f) ? 0.f : 1.f / l;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) orow[dd] = Vec<T>::from(l == 0.f ? 0.f : acc[i] * inv);
      }
    }
    return;
  }
  // Split-K merge of the row's warps through shared memory.
  if (lane == 0) { Ms[warp] = m; Ls[warp] = l; }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int dd = lane + 32 * i;
    if (dd < D) As[warp * D + dd] = acc[i];
  }
  __syncthreads();
  if (part != 0 || !row_ok) return;
  const int w0 = rib * split;
  float mm = -INFINITY;
  for (int p = 0; p < split; ++p) mm = fmaxf(mm, Ms[w0 + p]);
  float ll = 0.f, o[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) o[i] = 0.f;
  if (mm != -INFINITY) {
    for (int p = 0; p < split; ++p) {
      const float mp = Ms[w0 + p];
      if (mp == -INFINITY) continue;
      const float c = expf(mp - mm);
      ll += Ls[w0 + p] * c;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) o[i] += As[(w0 + p) * D + dd] * c;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int dd = lane + 32 * i;
    if (dd < D) orow[dd] = Vec<T>::from(ll == 0.f ? 0.f : o[i] / ll);
  }
}

// One launch of the template: sets the dynamic shared-memory limit the
// first time a head dim needs more than the default, picks bq from Sq and
// returns the launch's CUDA error code (0 on success).
template <typename T, typename KV>
int launch(const void* q, KV kv, const int* kv_lens, void* out, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, float scale, int causal,
           int window, cudaStream_t s) {
  static size_t configured = 0;
  const size_t smem = smem_bytes(D);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const int bq = Sq >= 8 ? 8 : Sq >= 4 ? 4 : Sq >= 2 ? 2 : 1;
  dim3 grid((Sq + bq - 1) / bq, Hq, B);
  flash_fwd_kernel<T, KV><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), kv, kv_lens, static_cast<T*>(out), Hq, Hkv,
      Sq, Skv, D, scale, causal, window, bq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_fa
