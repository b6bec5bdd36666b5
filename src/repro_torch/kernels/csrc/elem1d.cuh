// Shared pieces of the 1-d kernels (adjacent_difference, artificial_work,
// reduce_sum, inclusive_scan) for Hopper (sm_90a).
//
// Every 1-d kernel has the same shape.  Thread block b owns the elements
// [b * block, min((b + 1) * block, n)) -- the paper's chunk, sized by
// kernels/tuning.py -- and walks them in tiles of kThreads * kItems<T>
// elements: 16 bytes a thread, thread t holding elements t, t + kThreads,
// ... of the tile, so that each load instruction of a warp reads
// neighbouring addresses.  Positions past the end are masked in the
// kernel: there is no padded copy of the input.  Sizes are 64-bit.
// Loads are scalar, because a chunk of a parallel algorithm is a view
// that starts at any element and need not be 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace repro1d {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
constexpr int kItems = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// First element of this thread block's chunk, and one past its last.
__device__ __forceinline__ size_t chunk_begin(size_t block) {
  return static_cast<size_t>(blockIdx.x) * block;
}
__device__ __forceinline__ size_t chunk_end(size_t block, size_t n) {
  const size_t e = chunk_begin(block) + block;
  return e < n ? e : n;
}

inline unsigned grid_of(size_t n, size_t block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

}  // namespace repro1d
