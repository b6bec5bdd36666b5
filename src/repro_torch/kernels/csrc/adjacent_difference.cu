// adjacent_difference for Hopper (sm_90a): the paper's memory-bound body.
//
// Replaces: src/repro/kernels/adjacent_difference.py
// `adjacent_difference_pallas` (its `_kernel`):
//   out[0] = x[0];  out[i] = x[i] - x[i-1].
// f32 and bf16; bf16 is computed in f32 and rounded once, as PyTorch's own
// bf16 subtraction does.
//
// What bounds it on this card: bytes.  It reads x once and writes out once,
// 2 * n * itemsize bytes, one subtraction per element: at n = 2^24 in f32,
// 134 MB and 40 us at 3.35 TB/s.
//
// Design: the TPU kernel gets its one-element halo by receiving the whole
// previous block as a second input.  Here the halo is just an overlapping
// read: each thread reads its element and its left neighbour, which the
// neighbouring thread has just brought into L1, so device memory is read
// once.  The element left of a chunk lies in the previous thread block's
// range and is read from global memory like any other.  Each thread keeps
// kItems<T> loads in flight per tile (16 bytes) to cover the memory
// latency; no shared memory, no synchronisation.

#include "elem1d.cuh"

namespace {

using namespace repro1d;

template <typename T>
__global__ void __launch_bounds__(kThreads)
adjacent_difference_kernel(const T* __restrict__ x, T* __restrict__ out,
                           size_t n, size_t block) {
  constexpr int N = kItems<T>;
  const size_t begin = chunk_begin(block);
  const size_t end = chunk_end(block, n);
  for (size_t base = begin; base < end; base += static_cast<size_t>(kThreads) * N) {
    float cur[N], prev[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t i = base + static_cast<size_t>(k) * kThreads + threadIdx.x;
      cur[k] = 0.f;
      prev[k] = 0.f;
      if (i < end) {
        cur[k] = to_f32(x[i]);
        if (i > 0) prev[k] = to_f32(x[i - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t i = base + static_cast<size_t>(k) * kThreads + threadIdx.x;
      if (i < end) out[i] = from_f32<T>(i == 0 ? cur[k] : cur[k] - prev[k]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `block` is the elements of one thread
// block (> 0).  Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_adjacent_difference(const void* x, void* out, size_t n,
                                         size_t block, int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(n, block);
  if (dtype == 0) {
    adjacent_difference_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, block);
  } else {
    adjacent_difference_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        n, block);
  }
  return static_cast<int>(cudaGetLastError());
}
