// artificial_work for Hopper (sm_90a): the paper's compute-bound body.
//
// Replaces: src/repro/kernels/artificial_work.py `artificial_work_pallas`
// (its `_kernel`): `iters` dependent steps c <- c * 1.000000119 + 0.1 per
// element, f32.
//
// What bounds it on this card: operations.  2 * iters * n FLOP against
// 8 * n bytes: at n = 2^24 and iters = 256, 8.6 GFLOP, 128 us at the
// 67 TFLOP/s f32 rate of the CUDA cores, where its bytes alone would take
// 40 us.
//
// Design: each step is one fused multiply-add, __fmaf_rn, rounded once --
// as XLA contracts the reference's c * a + b on the CPU; the plain PyTorch
// version computes each step in f64 and rounds once to f32 to match.
// `iters` is a run-time argument, so the compiler cannot fold the chain.
// Each step depends on the one before, and an FMA's result is ready only
// some cycles after issue, so each thread carries kItems<float> = 4
// independent elements through the loop, and the SM interleaves the
// chains of its many resident warps.

#include "elem1d.cuh"

namespace {

using namespace repro1d;

__global__ void __launch_bounds__(kThreads)
artificial_work_kernel(const float* __restrict__ x, float* __restrict__ out,
                       size_t n, size_t block, int iters) {
  constexpr int N = kItems<float>;
  const size_t begin = chunk_begin(block);
  const size_t end = chunk_end(block, n);
  for (size_t base = begin; base < end; base += static_cast<size_t>(kThreads) * N) {
    float c[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t i = base + static_cast<size_t>(k) * kThreads + threadIdx.x;
      c[k] = i < end ? x[i] : 0.f;
    }
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int k = 0; k < N; ++k) c[k] = __fmaf_rn(c[k], 1.000000119f, 0.1f);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t i = base + static_cast<size_t>(k) * kThreads + threadIdx.x;
      if (i < end) out[i] = c[k];
    }
  }
}

}  // namespace

// float32 only.  Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_artificial_work(const void* x, void* out, size_t n,
                                     size_t block, int iters, void* stream) {
  if (n == 0) return 0;
  artificial_work_kernel<<<grid_of(n, block), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, block, iters);
  return static_cast<int>(cudaGetLastError());
}
