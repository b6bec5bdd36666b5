// Flash attention forward for Hopper (sm_90a), with a per-lane kv length,
// over contiguous K/V (kernel 2).
//
// Replaces: src/repro/kernels/flash_attention.py:93
// `flash_attention_pallas` (its `_kernel`).  Same function; the TPU
// kernel takes one kv_len for the whole call, here it is a per-lane int32
// device vector, so one kernel serves both calls of the contiguous serve
// path: chunked prefill into one slot (B = 1, Sq <= 256, Skv = max_len)
// and fused decode over the whole slot pool (B = n_slots, Sq = 1, every
// lane at its own position).
//
// What bounds it, and the design (flash_attention.cuh, the loop it shares
// with kernel 3): decode and verify are bound by bytes and run the
// split-KV schedule (kv chunks of 256 keys, 128 in f32, by default,
// across blocks, a cp.async ring, a deterministic merge); prefill chunks are bound by
// products and run
// the tile schedule, on the tensor cores (wgmma) in bf16 and on the CUDA
// cores in f32, which keeps IEEE f32 products.  Here each 16-byte copy
// reads row (b, hk, kj) of the contiguous K/V.

#include "flash_attention.cuh"

using repro_fa::ContiguousKV;
using repro_fa::kMaxD;
using repro_fa::launch;

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), out like q, all contiguous and
// 16-byte aligned; kv_lens (B,) int32 on the device; lse: null, or (B, Hq,
// Sq) f32 on the device for each query row's log-sum-exp of its scaled
// scores (natural units, -inf for a row with no visible key: the partial
// softmax statistics a sequence-split decode merges across ranks; `out` is
// the same with or without it); scratch: the split
// path's partials, B * Hkv * ceil(Skv / chunk) * 2080 floats for D <=
// 128, 4128 for 136 <= D <= 256 (may be null on the tile path); D a
// multiple of 8 up to 256.  chunk: the split path's keys per split, a
// multiple of 64 in bf16 and of 32 in f32 (256 and 128 by default);
// block_rows: the tile path's schedule, 64 (wgmma, bf16) or 16 (the split
// kernel's loop).  dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns the CUDA error code of the first launch that failed (0 on
// success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, const void* kv_lens,
                                     void* out, void* lse, void* scratch,
                                     int B, int Hq,
                                     int Hkv, int Sq, int Skv, int D,
                                     float scale, int causal, int window,
                                     int dtype, int chunk, int block_rows,
                                     void* stream) {
  if (D <= 0 || D > kMaxD || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  if (dtype == 0) {
    ContiguousKV<float> kv{static_cast<const float*>(k),
                           static_cast<const float*>(v), Hkv, Skv, D};
    return launch<float>(q, kv, lens, out, scratch, B, Hq, Hkv, Sq, Skv, D,
                         scale, causal, window, chunk, block_rows, s,
                         static_cast<float*>(lse));
  }
  ContiguousKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                                 static_cast<const __nv_bfloat16*>(v), Hkv,
                                 Skv, D};
  return launch<__nv_bfloat16>(q, kv, lens, out, scratch, B, Hq, Hkv, Sq,
                               Skv, D, scale, causal, window, chunk,
                               block_rows, s, static_cast<float*>(lse));
}
