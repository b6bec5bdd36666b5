// reduce_sum and inclusive_scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/reduce_scan.py
//   `reduce_sum_pallas` (:24, its `_reduce_kernel`): the f32 partial sum of
//     each block; the partials are summed outside the kernel.
//   `inclusive_scan_pallas` (:57, `_scan_local_kernel`,
//     `_scan_offset_kernel`): (1) the local cumsum of each block and its
//     total, f32 inside; (2) an exclusive scan of the block totals, outside
//     the kernel; (3) each block's offset added.
// f32 and bf16 inputs; the sums run in f32.  One launch each.
//
// What bounds them on this card: bytes.  The reduction reads x once,
// n * itemsize (67 MB and 20 us at n = 2^24 f32, 3.35 TB/s).  The scan reads
// x once and writes the result once, 2 * n * itemsize (134 MB, 40 us).  The
// TPU kernel's three phases move twice that: phase 1 writes the local scan,
// phase 3 reads it back.
//
// reduce_sum.  Each thread reads its chunk's body as 16-byte vectors
// (ld.global.nc.v4), kReduceUnroll of them in flight, one f32 accumulator
// each, summed in a fixed order; a scalar head up to the first 16-byte
// boundary and a scalar tail (the chunk of a `par` call is a view that
// starts at any element).  The block's partial is a warp butterfly and a
// sum over the warps.  The blocks are combined in the same launch: each
// writes its partial, fences and counts itself on a per-call counter; the
// last block to count sums the partials in index order with the same
// trees and writes the result in x's type.  No float atomics.
//
// inclusive_scan: one pass over segments.  A segment is
// min(block, kScanSegMax<T>) elements (the wrapper raises a block below four
// tiles to four tiles); segment k covers [k * seg, (k + 1) * seg).  A block
//   1. takes its segment index k from a ticket (an atomic counter), so every
//      segment it will wait for has already started: no deadlock, whatever
//      order the hardware starts blocks in;
//   2. stages the segment in shared memory: a 1-d TMA bulk copy
//      (cp.async.bulk, completion on an mbarrier) for the 16-byte-aligned
//      body, scalar loads for the head and tail.  Stage position v holds
//      x[start - pad + v], pad = the start's offset from a 16-byte boundary
//      in elements, so the staged body is 16-byte aligned too; positions
//      outside the segment hold 0;
//   3. sums each thread's 16 bytes of every tile, scans them over the lanes
//      and the tiles, and publishes the segment's aggregate at once: value
//      and flag in one 64-bit word (st.release.gpu);
//   4. looks back (warp 0, below) for its exclusive prefix P;
//   5. rescans each tile from shared memory, writes round(P + local) in
//      place in x's type -- one rounding, also in bf16 -- and stores the
//      segment: one TMA bulk store (cp.async.bulk.global.shared) where x and
//      out share their 16-byte alignment, else 16-byte stores.
// A segment is at most 32 KiB and a stage (kScanSegTiles + 1) tiles of 4 KiB
// (+1: the pad), so six blocks are resident per SM.  Measured on the H100
// (PERF.md): the wait for the predecessors' aggregates is what holds
// a block; six blocks of 32 KiB hide it better than three of 64 KiB (the
// TPU kernel's whole-block VMEM tile), and better than persistent blocks
// that stage the next segment ahead (a segment ticketed ahead publishes its
// aggregate late, and every later segment waits for it).
//
// Why the look-back is deterministic.  CUB's decoupled look-back (behind
// torch.cumsum) stops at whichever predecessor has already published its
// inclusive prefix, so the order of its sums, and its rounding, changes from
// run to run.  Here every value a block reads has the same bits whoever
// wrote it, and it adds them in an order fixed by k alone:
//   - aggregate a_k: the f32 sum of segment k, in an order fixed by the
//     segment's length and alignment;
//   - group g = segments [32 g, 32 g + 32): its total T_g is the butterfly
//     warp_sum of its 32 aggregates, published by the block of its last
//     segment right after that block's in-group step (it waits for nothing
//     outside the group, so no chain forms across groups);
//   - P_k = warp_sum(lane l: T_l + T_{l+32} + ..., over groups < g)
//         + warp_sum(lane l: a_{32 g + l} for l < k mod 32, else 0).
// A word read before its flag is set is read again; the value and the flag
// travel in one single-copy-atomic 64-bit word and nothing else is published
// under the flag, so relaxed loads suffice for the spins.  The status words
// and the ticket are per call (zeroed by the wrapper), so two calls on two
// streams never meet.  At 2^26 f32 (8192 segments, 256 groups) warp 0 reads
// at most 8 totals and 1 aggregate per lane.

#include "elem1d.cuh"

namespace {

using namespace repro1d;

constexpr int kReduceUnroll = 4;      // 16-byte loads in flight per thread
constexpr int kTileBytes = kThreads * 16;
constexpr int kScanSegTiles = 8;      // a segment: at most 32 KiB of x
constexpr int kStageTiles = kScanSegTiles + 1;   // + the head's pad
constexpr int kScanSmem = kStageTiles * kTileBytes;
constexpr int kScanBlocksPerSM = 6;
constexpr int kGroup = 32;            // segments per group
constexpr int kLookBatch = 4;         // group totals a lane loads at once

template <typename T>
constexpr int kScanSegMax = kScanSegTiles * kTileBytes / static_cast<int>(sizeof(T));

// Block-wide sum: warp butterflies, then the warp sums in warp order.  The
// result is valid in every thread.  Reuses `warp_sums` after a barrier.
__device__ __forceinline__ float block_sum(float s, float* warp_sums) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = warp_sums[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t += warp_sums[w];
  __syncthreads();
  return t;
}

template <typename T>
__device__ __forceinline__ float vec_sum(uint4 v) {
  float f[kItems<T>];
  unpack(v, f);
  float s = f[0];
#pragma unroll
  for (int i = 1; i < kItems<T>; ++i) s += f[i];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_sum_kernel(const T* __restrict__ x, T* __restrict__ out,
                  float* __restrict__ partials, unsigned* __restrict__ done,
                  size_t n, size_t block) {
  constexpr int N = kItems<T>;
  __shared__ float warp_sums[kWarps];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  const size_t begin = chunk_begin(block);
  const size_t len = chunk_end(block, n) - begin;
  const T* p = x + begin;
  const size_t head = head_elems(p, len);
  const size_t nvec = (len - head) / N;
  const size_t tail_at = head + nvec * N;
  const T* body = p + head;

  float acc[kReduceUnroll];
#pragma unroll
  for (int u = 0; u < kReduceUnroll; ++u) acc[u] = 0.f;
  size_t v = tid;
  for (; v + (kReduceUnroll - 1) * kThreads < nvec; v += kReduceUnroll * kThreads) {
    uint4 q[kReduceUnroll];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) q[u] = ldg16(body + (v + u * kThreads) * N);
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) acc[u] += vec_sum<T>(q[u]);
  }
#pragma unroll
  for (int u = 0; u < kReduceUnroll; ++u) {   // the last < kReduceUnroll vectors
    const size_t i = v + u * kThreads;
    if (i < nvec) acc[u] += vec_sum<T>(ldg16(body + i * N));
  }
  float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  if (static_cast<size_t>(tid) < head) s += to_f32(p[tid]);
  if (static_cast<size_t>(tid) < len - tail_at) s += to_f32(p[tail_at + tid]);
  s = block_sum(s, warp_sums);

  if (tid == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    is_last = atomicAdd(done, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  float t = 0.f;
#pragma unroll 4
  for (unsigned i = tid; i < gridDim.x; i += kThreads) t += __ldcg(partials + i);
  t = block_sum(t, warp_sums);
  if (tid == 0) out[0] = from_f32<T>(t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void publish(unsigned long long* w, float v) {
  const unsigned long long word = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(w), "l"(word) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* w) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(w) : "memory");
  return v;
}

// The value of status word w, given a first reading `seen`; spins until the
// flag (the high half) is set.
__device__ __forceinline__ float wait_word(const unsigned long long* w,
                                       unsigned long long seen) {
  while (!(seen >> 32)) seen = peek(w);
  return __uint_as_float(static_cast<unsigned>(seen));
}

// The exclusive prefix of segment k (warp 0; every lane returns it).  `agg`
// is segment k's own aggregate, already published.
__device__ __forceinline__ float look_back(const unsigned long long* aggs,
                                           unsigned long long* totals,
                                           unsigned k, float agg, int lane) {
  const unsigned g = k / kGroup, r = k % kGroup;
  const unsigned long long* mine = aggs + static_cast<size_t>(g) * kGroup;
  // First readings of the group's aggregates and of a batch of earlier
  // totals, all in flight at once.
  const unsigned long long seen = static_cast<unsigned>(lane) < r ? peek(mine + lane) : 0;
  unsigned long long w[kLookBatch];
#pragma unroll
  for (int u = 0; u < kLookBatch; ++u) {
    const unsigned h = lane + u * kGroup;
    w[u] = h < g ? peek(totals + h) : 0;
  }
  float a = 0.f;
  if (static_cast<unsigned>(lane) < r) a = wait_word(mine + lane, seen);
  else if (static_cast<unsigned>(lane) == r) a = agg;
  const float in_group = warp_sum(static_cast<unsigned>(lane) < r ? a : 0.f);
  if (r == kGroup - 1) {                  // the group is complete: publish
    const float total = warp_sum(a);      // its total before waiting again
    if (lane == 0) publish(totals + g, total);
  }
  float gs = 0.f;                         // lane l: T_l + T_{l+32} + ...
  for (unsigned h0 = lane; h0 < g; h0 += kLookBatch * kGroup) {
    if (h0 != static_cast<unsigned>(lane)) {
#pragma unroll
      for (int u = 0; u < kLookBatch; ++u) {
        const unsigned h = h0 + u * kGroup;
        w[u] = h < g ? peek(totals + h) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kLookBatch; ++u) {
      const unsigned h = h0 + u * kGroup;
      if (h < g) gs += wait_word(totals + h, w[u]);
    }
  }
  return warp_sum(gs) + in_group;
}

// 16 bytes of shared memory at p as raw bits, element by element (for a p
// that need not be 16-byte aligned).
template <typename T>
__device__ __forceinline__ uint4 gather16(const T* p) {
  uint4 q;
  T* e = reinterpret_cast<T*>(&q);
#pragma unroll
  for (int i = 0; i < kItems<T>; ++i) e[i] = p[i];
  return q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSM)
scan_kernel(const T* __restrict__ x, T* __restrict__ out,
            unsigned long long* status, size_t n, int seg, unsigned n_segs) {
  constexpr int N = kItems<T>;
  constexpr int kTile = kThreads * N;     // elements of one tile
  extern __shared__ __align__(128) unsigned char stage_bytes[];
  T* stage = reinterpret_cast<T*>(stage_bytes);
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float warp_tot[kStageTiles][kWarps];
  __shared__ float tile_carry[kStageTiles];
  __shared__ float s_prefix;
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* aggs = status;
  unsigned long long* totals = status + n_segs;
  unsigned* ticket = reinterpret_cast<unsigned*>(totals + (n_segs + kGroup - 1) / kGroup);
  const uint32_t bar_s = smem_u32(&bar);

  if (tid == 0) {
    s_ticket = atomicAdd(ticket, 1u);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Segment k: `len` elements from `start`; stage position pad + i holds
  // element i, pad being the start's offset from a 16-byte boundary, so the
  // staged body is aligned as x's is.
  const unsigned k = s_ticket;
  const size_t start = static_cast<size_t>(k) * seg;
  const int len = static_cast<int>(n - start < static_cast<size_t>(seg) ? n - start : seg);
  const T* src = x + start;
  const int pad = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = static_cast<int>(head_elems(src, len));
  const int body = (len - head) / N * N;
  const int tail_at = head + body;
  const int ntiles = (pad + len + kTile - 1) / kTile;

  // Stage: the body by TMA, the rest by the threads (disjoint positions).
  if (tid == 0) {
    if (body > 0) {
      const uint32_t bytes = static_cast<uint32_t>(body * sizeof(T));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar_s), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(smem_u32(stage + pad + head)), "l"(src + head),
             "r"(bytes), "r"(bar_s) : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar_s) : "memory");
    }
  }
  const T zero = from_f32<T>(0.f);
  if (tid < pad) stage[tid] = zero;
  if (tid < head) stage[pad + tid] = src[tid];
  if (tid < len - tail_at) stage[pad + tail_at + tid] = src[tail_at + tid];
  for (int v = pad + len + tid; v < ntiles * kTile; v += kThreads) stage[v] = zero;
  {
    uint32_t ready = 0;
    while (!ready) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
          " selp.u32 %0, 1, 0, p; }"
          : "=r"(ready) : "r"(bar_s), "r"(0u) : "memory");
    }
  }
  __syncthreads();

  // Pass 1: each thread's 16 bytes of every tile, scanned over the lanes.
  float s[kStageTiles];
#pragma unroll
  for (int j = 0; j < kStageTiles; ++j) {
    s[j] = 0.f;
    if (j < ntiles) s[j] = vec_sum<T>(*reinterpret_cast<const uint4*>(stage + j * kTile + tid * N));
  }
#pragma unroll
  for (int j = 0; j < kStageTiles; ++j) {
    if (j < ntiles) {                     // the same for the whole block
      s[j] = warp_inclusive_scan(s[j], lane);
      if (lane == 31) warp_tot[j][warp] = s[j];
    }
  }
  __syncthreads();

  // Warp 0: tile totals, their carries, the aggregate; publish; look back.
  if (warp == 0) {
    float t = 0.f;
    if (lane < ntiles) {
      t = warp_tot[lane][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += warp_tot[lane][w];
    }
    const float incl = warp_inclusive_scan(t, lane);
    const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane < ntiles) tile_carry[lane] = lane == 0 ? 0.f : excl;
    const float agg = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0) publish(aggs + k, agg);
    const float prefix = look_back(aggs, totals, k, agg, lane);
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  // Pass 2: rescan each tile and write round(P + local) in place.
  const float P = s_prefix;
#pragma unroll
  for (int j = 0; j < kStageTiles; ++j) {
    if (j < ntiles) {
      float excl = __shfl_up_sync(0xffffffffu, s[j], 1);
      if (lane == 0) excl = 0.f;
      float wp = 0.f;
      for (int w = 0; w < warp; ++w) wp += warp_tot[j][w];
      float run = (tile_carry[j] + wp) + excl;
      uint4* q = reinterpret_cast<uint4*>(stage + j * kTile + tid * N);
      float f[N];
      unpack(*q, f);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        run += f[i];
        f[i] = P + run;
      }
      *q = pack<T>(f);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for the bulk store
  __syncthreads();

  // Store: element i of the segment is stage[pad + i].  Out's aligned body
  // by one TMA bulk store where x and out share their alignment, else by
  // 16-byte stores; its head and tail by scalar stores.
  T* dst = out + start;
  const int ohead = static_cast<int>(head_elems<T>(dst, len));
  const int onvec = (len - ohead) / N;
  const int otail_at = ohead + onvec * N;
  if (tid < ohead) dst[tid] = stage[pad + tid];
  if (tid < len - otail_at) dst[otail_at + tid] = stage[pad + otail_at + tid];
  const T* sv = stage + pad + ohead;
  if ((pad + ohead) % N == 0) {         // x and out share their alignment
    if (tid == 0 && onvec > 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(dst + ohead), "r"(smem_u32(sv)),
                      "r"(static_cast<uint32_t>(onvec * 16)) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // Shared memory must outlive the copy's reads of it.
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  } else {
    uint4* dv = reinterpret_cast<uint4*>(dst + ohead);
    for (int v = tid; v < onvec; v += kThreads) dv[v] = gather16(sv + v * N);
  }
}

template <typename T>
int launch_scan(const void* x, void* out, void* status, size_t n, size_t seg,
                cudaStream_t s) {
  if (seg < 1 || seg > static_cast<size_t>(kScanSegMax<T>))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n_segs = (n + seg - 1) / seg;
  if (n_segs > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<T><<<static_cast<unsigned>(n_segs), kThreads, kScanSmem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<unsigned long long*>(status), n, static_cast<int>(seg),
      static_cast<unsigned>(n_segs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16 (of x and out).  Each
// launches one kernel on `stream` and returns the CUDA error code of the
// launch (0 on success).

// out[0] = x's f32 sum in x's type.  `block` (> 0) is the elements of one
// thread block, so the grid is ceil(n / block).  `scratch`: grid + 1
// zeroed 32-bit words (the partials, then the counter).
extern "C" int repro_reduce_sum(const void* x, void* out, void* scratch,
                                size_t n, size_t block, int dtype,
                                void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(n, block);
  float* partials = static_cast<float*>(scratch);
  unsigned* done = reinterpret_cast<unsigned*>(partials + grid);
  if (dtype == 0) {
    reduce_sum_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), partials,
        done, n, block);
  } else {
    reduce_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        partials, done, n, block);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = inclusive prefix sum of x, in x's type.  `seg` is the elements of
// one segment, 1..kScanSegMax (8192 f32, 16384 bf16).  `status`: S + G + 1
// zeroed 64-bit words, S = ceil(n / seg) segments and G = ceil(S / 32)
// groups (the aggregates, the group totals, then the ticket).
extern "C" int repro_inclusive_scan(const void* x, void* out, void* status,
                                    size_t n, size_t seg, int dtype,
                                    void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_scan<float>(x, out, status, n, seg, s)
                    : launch_scan<__nv_bfloat16>(x, out, status, n, seg, s);
}
