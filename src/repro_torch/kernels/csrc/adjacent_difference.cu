// adjacent_difference for Hopper (sm_90a): the paper's memory-bound body.
//
// Replaces: src/repro/kernels/adjacent_difference.py
// `adjacent_difference_pallas` (its `_kernel`):
//   out[0] = x[0];  out[i] = x[i] - x[i-1].
// f32 and bf16; bf16 is computed in f32 and rounded once, as PyTorch's own
// bf16 subtraction does, so the kernel equals the plain version bit for bit.
//
// What bounds it on this card: bytes.  It reads x once and writes out once,
// 2 * n * itemsize bytes, one subtraction per element: at n = 2^24, 134 MB
// and 40 us in f32, 67 MB and 20 us in bf16, at 3.35 TB/s.
//
// Design: the TPU kernel gets its one-element halo by receiving the whole
// previous block as a second input.  Here thread block b walks its chunk
// [b * block, min((b + 1) * block, n)) as elem1d.cuh splits a range: a
// scalar head up to x's first 16-byte boundary, a body of 16-byte vectors
// (ld.global.nc.v4 loads and 16-byte stores, kUnroll vectors in flight per
// thread, neighbouring lanes on neighbouring vectors) and a scalar tail.
// The halo of a body vector -- the element just left of it -- is the last
// element of the vector the previous lane holds, passed by __shfl_up_sync;
// only lane 0 of each warp reads it from memory, one scalar that a
// neighbouring warp or block has just brought into L1 or L2.  So device
// memory is read once, in 16-byte requests (a warp request moves 512
// bytes, where an element-by-element bf16 load moves 64).  The output
// shares x's offset from a 16-byte boundary (the wrapper allocates it so:
// a chunk of a `par` call is a view one element left of a boundary), so
// the body's stores are whole vectors too.  No shared memory, no
// synchronisation.

#include "elem1d.cuh"

namespace {

using namespace repro1d;

constexpr int kUnroll = 4;      // 16-byte vectors in flight per thread

// out[i] = x[i] - x[i-1], out[0] = x[0] (x[0] - 0 is x[0], -0 included).
template <typename T>
__device__ __forceinline__ void one(const T* __restrict__ x,
                                    T* __restrict__ out, size_t i) {
  const float prev = i ? to_f32(x[i - 1]) : 0.f;
  out[i] = from_f32<T>(to_f32(x[i]) - prev);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adjacent_difference_kernel(const T* __restrict__ x, T* __restrict__ out,
                           size_t n, size_t block) {
  constexpr int N = kItems<T>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t begin = chunk_begin(block);
  const size_t end = chunk_end(block, n);
  const size_t head = head_elems(x + begin, end - begin);
  const size_t body = begin + head;             // 16-byte aligned in x and out
  const size_t nvec = (end - body) / N;
  const size_t tail = body + nvec * N;
  if (static_cast<size_t>(tid) < head) one(x, out, begin + tid);
  if (static_cast<size_t>(tid) < end - tail) one(x, out, tail + tid);

  for (size_t v0 = 0; v0 < nvec; v0 += static_cast<size_t>(kUnroll) * kThreads) {
    uint4 q[kUnroll];
    float left[kUnroll];        // lane 0: the element left of its vector
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t vi = v0 + static_cast<size_t>(u) * kThreads + tid;
      q[u] = vi < nvec ? ldg16(x + body + vi * N) : make_uint4(0u, 0u, 0u, 0u);
      const size_t e = body + vi * N;
      left[u] = (lane == 0 && vi < nvec && e > 0) ? to_f32(x[e - 1]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t vi = v0 + static_cast<size_t>(u) * kThreads + tid;
      float f[N], o[N];
      unpack(q[u], f);
      const float up = __shfl_up_sync(0xffffffffu, f[N - 1], 1);
      o[0] = f[0] - (lane == 0 ? left[u] : up);
#pragma unroll
      for (int i = 1; i < N; ++i) o[i] = f[i] - f[i - 1];
      if (vi < nvec) *reinterpret_cast<uint4*>(out + body + vi * N) = pack<T>(o);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `block` is the elements of one thread
// block (> 0).  x and out must lie at the same offset from a 16-byte
// boundary (cudaErrorMisalignedAddress otherwise).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int repro_adjacent_difference(const void* x, void* out, size_t n,
                                         size_t block, int dtype, void* stream) {
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
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
