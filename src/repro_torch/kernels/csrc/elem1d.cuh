// Shared pieces of the 1-d kernels (adjacent_difference, artificial_work,
// reduce_sum, inclusive_scan) for Hopper (sm_90a).
//
// Every 1-d kernel has the same shape.  Thread block b owns the elements
// [b * block, min((b + 1) * block, n)) -- the paper's chunk, sized by
// kernels/tuning.py -- and walks them in tiles of kThreads * kItems<T>
// elements: 16 bytes a thread.  Positions past the end are masked in the
// kernel: there is no padded copy of the input.  Sizes are 64-bit.
//
// A chunk of a parallel algorithm is a view that starts at any element, so
// its first element need not lie on a 16-byte boundary.  adjacent_difference
// and artificial_work load element by element (thread t holding elements
// t, t + kThreads, ... of a tile, so each warp load reads neighbouring
// addresses).  reduce_sum and inclusive_scan split a range into a scalar
// head up to the first 16-byte boundary (`head_elems`), a body of 16-byte
// vectors (`ldg16`, `unpack`, `pack`) and a scalar tail, so a misaligned
// view still takes the vector path after at most kItems<T> - 1 elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// Elements of T from p to the first 16-byte boundary at or after it (0 if
// p lies on one), at most len.  p is aligned to sizeof(T), as every tensor's
// element is.
template <typename T>
__device__ __forceinline__ size_t head_elems(const T* p, size_t len) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
  const size_t h = mis ? static_cast<size_t>(kItems<T> - mis) : 0;
  return h < len ? h : len;
}

// 16 bytes from global memory that the kernel does not write (p 16-byte
// aligned): ld.global.nc.v4.
template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The kItems<T> elements of a 16-byte vector as f32, in address order
// (exact: bf16 -> f32 only widens).
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);              // low half first
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// kItems<T> f32 values rounded once to T and packed in address order.
template <typename T> __device__ __forceinline__ uint4 pack(const float (&f)[kItems<T>]);
template <> __device__ __forceinline__ uint4 pack<float>(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float (&f)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Sum over the 32 lanes by butterfly: every lane ends with the same bits
// (each step adds the same two values on both lanes, and IEEE addition is
// commutative), in an order fixed by the lanes alone.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Inclusive prefix over the lanes (Hillis-Steele, a fixed order).
__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

}  // namespace repro1d
