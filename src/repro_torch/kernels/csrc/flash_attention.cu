// Flash attention forward for Hopper (sm_90a), with a per-lane kv length,
// over contiguous K/V.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention_pallas`
// (its `_kernel`).  Same function (see flash_attention.cuh, which holds the
// loop this kernel shares with the paged one).  The TPU kernel takes one
// kv_len for the whole call; here it is a per-lane int32 device vector, so
// one kernel serves both calls of the contiguous serve path: chunked
// prefill into one slot (B = 1, Sq <= 256, Skv = max_len) and fused decode
// over the whole slot pool (B = n_slots, Sq = 1, every lane at its own
// position).  What bounds it, and the design: flash_attention.cuh.

#include "flash_attention.cuh"

using repro_fa::ContiguousKV;
using repro_fa::kMaxD;
using repro_fa::launch;

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), out like q, all contiguous and
// 16-byte aligned; kv_lens (B,) int32 on the device.  dtype: 0 = float32,
// 1 = bfloat16.  window <= 0 means no window.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, const void* kv_lens,
                                     void* out, int B, int Hq, int Hkv,
                                     int Sq, int Skv, int D, float scale,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (D > kMaxD || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  if (dtype == 0) {
    ContiguousKV<float> kv{static_cast<const float*>(k),
                           static_cast<const float*>(v), Hkv, Skv, D};
    return launch<float>(q, kv, lens, out, B, Hq, Hkv, Sq, Skv, D, scale,
                         causal, window, s);
  }
  ContiguousKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                                 static_cast<const __nv_bfloat16*>(v), Hkv,
                                 Skv, D};
  return launch<__nv_bfloat16>(q, kv, lens, out, B, Hq, Hkv, Sq, Skv, D,
                               scale, causal, window, s);
}
