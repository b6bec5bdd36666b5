// reduce_sum and inclusive_scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/reduce_scan.py
//   `reduce_sum_pallas` (its `_reduce_kernel`): the f32 partial sum of each
//     block; the partials are summed outside the kernel.
//   `inclusive_scan_pallas` (`_scan_local_kernel`, `_scan_offset_kernel`):
//     (1) the local cumsum of each block and its total, f32 inside;
//     (2) an exclusive scan of the block totals, outside the kernel;
//     (3) each block's offset added.
// f32 and bf16 inputs; the sums run in f32.
//
// What bounds them on this card: bytes.  The reduction reads x once
// (n * itemsize; 67 MB and 20 us at n = 2^24 f32, 3.35 TB/s).  A scan
// needs at least one read and one write (134 MB, 40 us); this three-phase
// scan, like the TPU kernel, moves twice that: phase 1 reads x and writes
// the local scan, phase 3 reads it back and writes the result (in place).
//
// Design.  On the TPU the grid runs in order on one core; here the thread
// blocks run in no order on the SMs, so each one sums or scans its own
// chunk and nothing carries between blocks except through a second pass:
//   reduce: each thread keeps kItems<T> independent f32 accumulators (one
//     per load in flight) over its chunk, the warp reduces with
//     __shfl_down_sync, the warps' sums meet in shared memory and thread 0
//     writes the block's partial.  The wrapper combines the (grid,)
//     partials by a second launch of the same kernel as one block.  No
//     float atomics: the order of every sum is fixed by the plan, so a
//     result is the same from run to run.
//   scan phase 1: the block walks its chunk tile by tile.  A tile is loaded
//     striped (coalesced) into shared memory, each thread scans its
//     kItems<T> consecutive elements in registers, the warp scans the
//     thread totals with __shfl_up_sync, the warp totals meet in shared
//     memory, and the tile is written back striped.  The running total of
//     the tiles so far is carried in a register, so shared memory holds
//     one tile, not the chunk.  Shared memory indices are skewed by one
//     word per 32 so that both the striped and the consecutive accesses
//     are free of bank conflicts.
//   scan phase 3: each block adds its offset to its chunk of the local scan.

#include "elem1d.cuh"

namespace {

using namespace repro1d;

__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_sum_kernel(const T* __restrict__ x, float* __restrict__ partials,
                  size_t n, size_t block) {
  constexpr int N = kItems<T>;
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t begin = chunk_begin(block);
  const size_t end = chunk_end(block, n);
  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
  for (size_t base = begin; base < end; base += static_cast<size_t>(kThreads) * N) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t i = base + static_cast<size_t>(k) * kThreads + threadIdx.x;
      if (i < end) acc[k] += to_f32(x[i]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) s += acc[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) partials[blockIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_local_kernel(const T* __restrict__ x, T* __restrict__ local,
                  float* __restrict__ totals, size_t n, size_t block) {
  constexpr int N = kItems<T>;
  constexpr int kTile = kThreads * N;
  __shared__ float tile[kTile + kTile / 32];
  __shared__ float warp_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t begin = chunk_begin(block);
  const size_t end = chunk_end(block, n);
  float carry = 0.f;   // sum of this chunk's earlier tiles
  for (size_t base = begin; base < end; base += kTile) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * kThreads + tid;
      const size_t i = base + j;
      tile[skew(j)] = i < end ? to_f32(x[i]) : 0.f;
    }
    __syncthreads();
    float v[N];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s += tile[skew(tid * N + k)];
      v[k] = s;
    }
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    float warp_prefix = 0.f, tile_total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float ws = warp_sums[w];
      if (w < warp) warp_prefix += ws;
      tile_total += ws;
    }
    const float prefix = carry + warp_prefix + excl;
#pragma unroll
    for (int k = 0; k < N; ++k) tile[skew(tid * N + k)] = prefix + v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * kThreads + tid;
      const size_t i = base + j;
      if (i < end) local[i] = from_f32<T>(tile[skew(j)]);
    }
    carry += tile_total;
    __syncthreads();   // the next tile overwrites `tile` and `warp_sums`
  }
  if (tid == 0) totals[blockIdx.x] = carry;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_offset_kernel(T* __restrict__ data, const float* __restrict__ offsets,
                   size_t n, size_t block) {
  constexpr int N = kItems<T>;
  const size_t begin = chunk_begin(block);
  const size_t end = chunk_end(block, n);
  const float off = offsets[blockIdx.x];
  for (size_t base = begin; base < end; base += static_cast<size_t>(kThreads) * N) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t i = base + static_cast<size_t>(k) * kThreads + threadIdx.x;
      if (i < end) data[i] = from_f32<T>(to_f32(data[i]) + off);
    }
  }
}

}  // namespace

// All entry points: dtype 0 = float32, 1 = bfloat16 (of x / local);
// partials, totals and offsets are float32.  `block` is the elements of one
// thread block (> 0), so the grid is ceil(n / block).  Each returns the
// CUDA error code of its launch (0 on success).

// partials[b] = f32 sum of x[b * block, (b + 1) * block).
extern "C" int repro_reduce_sum_partials(const void* x, void* partials,
                                         size_t n, size_t block, int dtype,
                                         void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(n, block);
  if (dtype == 0) {
    reduce_sum_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(partials), n, block);
  } else {
    reduce_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(partials), n,
        block);
  }
  return static_cast<int>(cudaGetLastError());
}

// Phase 1: local[i] = inclusive scan of x within its block; totals[b] = the
// block's total.
extern "C" int repro_scan_local(const void* x, void* local, void* totals,
                                size_t n, size_t block, int dtype,
                                void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(n, block);
  if (dtype == 0) {
    scan_local_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(local),
        static_cast<float*>(totals), n, block);
  } else {
    scan_local_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(local), static_cast<float*>(totals), n,
        block);
  }
  return static_cast<int>(cudaGetLastError());
}

// Phase 3, in place: data[i] += offsets[block of i].
extern "C" int repro_scan_add_offsets(void* data, const void* offsets,
                                      size_t n, size_t block, int dtype,
                                      void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(n, block);
  if (dtype == 0) {
    scan_offset_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(data), static_cast<const float*>(offsets), n,
        block);
  } else {
    scan_offset_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(data), static_cast<const float*>(offsets),
        n, block);
  }
  return static_cast<int>(cudaGetLastError());
}
