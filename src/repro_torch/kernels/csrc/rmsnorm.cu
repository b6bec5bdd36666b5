// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py `rmsnorm_pallas` (its `_kernel`):
//   out = (x / sqrt(mean(x^2) + eps)) * gamma, in f32, cast back to x's type.
// The division by sqrt (not x * rsqrt) is kept on purpose: it is the TPU
// kernel's formula, and nvcc's default IEEE division and square root give
// the same rounding as the plain PyTorch version.
//
// What bounds it on this card: bytes.  It reads x and gamma once and writes
// out once: 2 * rows * d * itemsize + 4 * d bytes, one multiply-add per
// element, far below the card's ops-per-byte balance.  On the decode path
// rows are 8..128 (a few tens of KB), so the launch, not the memory, sets
// its time; fusing it into the neighbouring matmul is later work.
//
// Design: one warp per row, 8 rows per 256-thread block.  Each lane reads
// 16-byte vectors (8 bf16 or 4 f32) at neighbouring addresses, sums the
// squares in f32, and the warp reduces with shuffles (no shared memory, no
// __syncthreads).  The second pass reads the row again (it is in L1 by
// then) and writes the normalised values with 16-byte stores.  No
// allocation, no synchronisation; launched on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ gamma,
                               T* __restrict__ out, int rows, int d,
                               float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<int64_t>(row) * d;
  T* orow = out + static_cast<int64_t>(row) * d;
  const int nvec = d / N;

  float ss = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float f[N];
    Vec<T>::load(xr + v * N, f);
#pragma unroll
    for (int i = 0; i < N; ++i) ss += f[i] * f[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rms = sqrtf(ss / static_cast<float>(d) + eps);

  for (int v = lane; v < nvec; v += 32) {
    float f[N];
    Vec<T>::load(xr + v * N, f);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = (f[i] / rms) * gamma[v * N + i];
    Vec<T>::store(orow + v * N, f);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Requires d % 8 == 0 and 16-byte
// aligned, contiguous x/out (the wrapper checks).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* gamma, void* out,
                             int rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows == 0) return 0;
  dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(out), rows, d, eps);
  } else {
    rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<__nv_bfloat16*>(out), rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
