// Paged flash attention forward for Hopper (sm_90a) (kernel 3).
//
// Replaces: src/repro/kernels/flash_attention.py:204
// `paged_flash_attention_pallas` (its `_paged_kernel`).  Same function:
// kernel 2's causal online softmax with K/V read through a page table
// (B, n_blocks) from the paged pool's flat token-major stores
// (n_pages * ps, Hkv, D), per-lane int32 kv lengths, queries end-aligned
// per lane, no window, and pages at or past a lane's length never read.
// On the paged serve path it is every attention: the prefill chunk into
// one slot (B = 1), the fused decode over the pool (Sq = 1) and the
// speculative verify (Sq = d).
//
// What bounds it: as kernel 2 (bytes at decode and verify, products at
// prefill).  Design: the TPU kernel aims each kv tile's DMA at its page
// through scalar-prefetched indices, one tile per page.  Here the loop is
// kernel 2's (flash_attention.cuh): the same two schedules, tiles, splits,
// shared-memory contents and summation order, with one change in how
// bytes arrive: before a tile's cp.async copies are issued, the store
// row of each of its keys is staged in shared memory from the table (the
// entries loaded a tile ahead), and each 16-byte copy is aimed through
// them (a store row is contiguous along D, so a copy never straddles a
// page).  So over a permuted table
// it returns what kernel 2 returns over the same K/V laid out
// contiguously, bit for bit, for any page size, and paged serving emits
// the contiguous pool's tokens.

#include "flash_attention.cuh"

using repro_fa::kMaxD;
using repro_fa::launch;
using repro_fa::PagedKV;

// q (B, Hq, Sq, D), k_store/v_store (n_pages * page_size, Hkv, D), out like
// q, all contiguous and 16-byte aligned; page_table (B, n_blocks) and
// kv_lens (B,) int32 on the device; scratch, chunk and block_rows as for
// kernel 2 with Skv = n_blocks * page_size; D a multiple of 8 up to
// 256.  dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error code of
// the first launch that failed (0 on success).
extern "C" int repro_paged_flash_attention(
    const void* q, const void* k_store, const void* v_store,
    const void* page_table, const void* kv_lens, void* out, void* scratch,
    int B, int Hq, int Hkv, int Sq, int n_blocks, int page_size, int n_pages,
    int D, float scale, int causal, int dtype, int chunk, int block_rows,
    void* stream) {
  if (D <= 0 || D > kMaxD || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      page_size <= 0 || n_pages <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_lens);
  const int skv = n_blocks * page_size;
  if (dtype == 0) {
    PagedKV<float> kv{static_cast<const float*>(k_store),
                      static_cast<const float*>(v_store), table, n_blocks,
                      page_size, n_pages, Hkv, D};
    return launch<float>(q, kv, lens, out, scratch, B, Hq, Hkv, Sq, skv, D,
                         scale, causal, 0, chunk, block_rows, s);
  }
  PagedKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k_store),
                            static_cast<const __nv_bfloat16*>(v_store), table,
                            n_blocks, page_size, n_pages, Hkv, D};
  return launch<__nv_bfloat16>(q, kv, lens, out, scratch, B, Hq, Hkv, Sq,
                               skv, D, scale, causal, 0, chunk, block_rows,
                               s);
}
