// Flash attention forward for Hopper (sm_90a): the loop shared by the
// contiguous kernel (flash_attention.cu, kernel 2) and the paged one
// (paged_attention.cu, kernel 3).
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention_pallas`
// (:93) and `paged_flash_attention_pallas` (:204).
//
// Function: online-softmax attention, causal and sliding-window masks, a
// per-lane kv length, queries end-aligned to it (row s of lane b sits at
// position kv_lens[b] - Sq + s), GQA by reading kv head h / (Hq / Hkv)
// with no repeat, fully masked tiles never loaded, keys at or past a
// lane's length never read, and a query row with no visible key written
// as 0.  The two kernels differ only in where key kj of lane b lives,
// which the KV policy (ContiguousKV, PagedKV) answers when a tile's
// copies are issued; what lands in shared memory (keys at or past the
// lane's length land as zeros in both) and every arithmetic step are this
// template's, so over the same K/V values the paged kernel returns the
// contiguous kernel's output bit for bit, at any page size.
//
// Rows are packed per kv head: a block owns one (lane b, kv head hk) and
// the packed rows r = s * group + g (query position s, q head
// hk * group + g), so every K/V byte a block loads serves the whole GQA
// group.  The host picks one of two schedules from (Hq, Hkv, Sq) alone,
// never from the kv extent, the page size or the layout (the wrapper's
// `attention_plan` mirrors `use_split` and the constants below):
//
// * Split-KV decode (flash-decoding), Sq * group <= kSplitRows: the main
//   path's decode (Sq 1) and speculative verify (Sq 2, 4, 8).  Bound by
//   bytes: a key costs 4 * D flops per query row against 4 * D bytes of
//   bf16 K/V, 2 flops a byte at decode (2 rows) and 16 at most, far below
//   the card's ~295.  So the design spends the card's width on bytes: the
//   grid is (kv chunks, Hkv, B) with chunks of `chunk` keys at absolute
//   multiples of it: a run-time argument, a multiple of the split tile,
//   by default Vec<T>::kChunk (256 bf16, 128 f32; the wrapper's measured
//   plan may pick another); a chunk at or past the lane's length exits at
//   once; tiles come in through cp.async, 16 bytes a
//   thread, into a two-stage ring; bf16 multiplies with mma.sync
//   m16n8k16 (the block's rows as M), f32 in IEEE f32 on the CUDA cores
//   with every lane scoring a key; each block writes its (m, l, acc) to
//   scratch, and a second kernel of the same C call, launched as a
//   programmatic dependent launch, merges the splits in split order.  No
//   float atomics: every sum has one order, so two calls give the same
//   bits.
// * Tile path, Sq * group > kSplitRows: prefill chunks.  At Sq 256 the
//   products dominate (512 rows at group 2, about half of them seeing a
//   key under the causal mask: ~250 flops a byte of K/V, near the card's
//   balance), so bf16 runs on the tensor cores: one
//   warpgroup owns 64 packed rows; QK^T is wgmma m64n64k16 from shared
//   memory (Q and K K-major), the online softmax runs on the accumulator
//   fragments, P is rounded to bf16 into wgmma's register A operand, and
//   P.V is wgmma m64n128k16 with V read MN-major through the descriptor's
//   transpose bit; f32 accumulators stay in registers.  K/V tiles of 64
//   keys arrive by cp.async into a kTileStages-deep ring while an earlier
//   tile computes.  f32 stays off the tensor cores: Hopper takes f32
//   operands only as TF32 (~3 digits), which would break the f32 logits
//   gate (card vs CPU within 2e-3) and the f32 token-identity runs that
//   rest on it; the f32 tile path is the split kernel's CUDA-core loop
//   over blocks of kSplitRows packed rows and the whole kv range, written
//   directly.  bf16 can run that loop too (its mma.sync body, block_rows
//   = kSplitRows): the second tile schedule a measured plan may pick.
//
// Fully masked tiles are skipped in both: past the lane's length, above
// the causal diagonal of the block's last row, before the window of its
// first.  No allocation, no synchronisation with the host; launched on
// the caller's stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_fa {

constexpr int kThreads = 128;    // one warpgroup per block, both paths
// Head dims below kMaxD (64, 80: a multiple of 8, the wrapper checks)
// run zero-padded to it: Q, K and V arrive as 16-byte chunks c with
// 8c < D (4c in f32) and zeros past D, so the padded columns add 0 to
// every score and give 0 in P.V, whose columns at or past D are never
// stored.  A row is D * sizeof(T) bytes (a paged store row Hkv * D *
// sizeof(T)), a multiple of 16, so every chunk stays 16-byte aligned.
constexpr int kMaxD = 128;
constexpr int kSplitRows = 16;   // packed rows of a split-path block
constexpr int kTileRows = 64;    // packed rows of a tensor-core block
constexpr int kTileKeys = 64;    // keys per tensor-core tile
constexpr int kTileStages = 3;   // tensor-core ring depth (two blocks an SM)
constexpr int kTabSlot = 64;     // store rows staged per tile (one a key)
// Scratch of one split: (m, l) and acc[kMaxD] for each of its rows.
constexpr int kPartFloats = kSplitRows * (kMaxD + 2);

// The schedule, from (Hq, Hkv, Sq) only; kernels/flash_attention.py's
// attention_plan gives the same answer.
inline bool use_split(int Hq, int Hkv, int Sq) {
  return Sq * (Hq / Hkv) <= kSplitRows;
}

template <typename T> struct Vec;

// Per dtype: N elements per 16-byte copy, kKeys keys per split-path
// tile, kChunk the default keys per split (the launch's `chunk`): bf16
// reads half the bytes a key and takes longer splits.
template <> struct Vec<float> {
  static constexpr int N = 4;
  static constexpr int kKeys = 32;
  static constexpr int kChunk = 128;
  __device__ static void load(const float* p, float* o) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static float scalar(float x) { return x; }
  __device__ static float from(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr int kKeys = 64;
  static constexpr int kChunk = 256;
  __device__ static __nv_bfloat16 from(float x) { return __float2bfloat16_rn(x); }
};

// K/V of shape (B, Hkv, Skv, D): key kj of lane b, head hk is row
// (b, hk, kj).  Nothing to stage.
template <typename T> struct ContiguousKV {
  const T* k;
  const T* v;
  int Hkv, Skv, D;

  struct Lane {
    const T* kb;
    const T* vb;
    int D;
    __device__ int fetch(int /*k0*/, int /*end*/) const { return 0; }
    __device__ void put(int* /*ts*/, int /*k0*/, int /*end*/, int /*e*/) const {}
    __device__ int64_t offset(const int* /*ts*/, int /*row*/, int kj) const {
      return static_cast<int64_t>(kj) * D;
    }
  };

  __device__ Lane lane(int b, int hk) const {
    const int64_t base = (static_cast<int64_t>(b) * Hkv + hk) * Skv * D;
    return Lane{k + base, v + base, D};
  }
};

// The paged pool's flat token-major stores (n_pages * ps, Hkv, D): key kj
// of lane b sits at store row table[b, kj / ps] * ps + kj % ps.  Before a
// tile's copies are issued, the store rows of its keys below the lane's
// length are staged in shared memory, once, from the table slice of the
// tile; pages at or past the length are never read (they may be unmapped
// scratch or garbage).
// The page pool checks every entry on its host copy before the upload; an
// entry outside [0, n_pages) that still arrives here traps as the last
// guard instead of reading outside the store (the error is sticky).
template <typename T> struct PagedKV {
  const T* k;
  const T* v;
  const int* table;              // (B, n_blocks) int32
  int n_blocks, ps, n_pages, Hkv, D;

  struct Lane {
    const T* kb;
    const T* vb;
    const int* tab;
    int ps, n_pages;
    int64_t stride;              // elements per store row: Hkv * D
    // Keys [k0, end) of a tile, end <= the length: thread j < end - k0
    // loads the entry of key k0 + j's page into a register (fetch), and a
    // tile later stores the key's store row into the tile's table slot
    // (put), so the load hides behind a compute and each copy reads its
    // row from shared memory.
    __device__ int fetch(int k0, int end) const {
      const int kj = k0 + static_cast<int>(threadIdx.x);
      return kj < end ? tab[kj / ps] : 0;
    }
    __device__ void put(int* ts, int k0, int end, int pid) const {
      const int kj = k0 + static_cast<int>(threadIdx.x);
      if (kj >= end) return;
      if (pid < 0 || pid >= n_pages) __trap();
      ts[threadIdx.x] = pid * ps + kj % ps;
    }
    __device__ int64_t offset(const int* ts, int row, int /*kj*/) const {
      return static_cast<int64_t>(ts[row]) * stride;
    }
  };

  __device__ Lane lane(int b, int hk) const {
    const int64_t head = static_cast<int64_t>(hk) * D;
    return Lane{k + head, v + head,
                table + static_cast<int64_t>(b) * n_blocks, ps, n_pages,
                static_cast<int64_t>(Hkv) * D};
  }
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Key kj is visible to query position qpos.
__device__ __forceinline__ bool visible(int kj, int qpos, int lim, int causal,
                                        int window) {
  bool vis = kj < lim;
  if (causal) vis = vis && kj <= qpos;
  if (window > 0) vis = vis && (qpos - kj) < window;
  return vis;
}

// The kv range a block's rows [s_first, s_last] (query positions) can see:
// [lo, hi).
struct KvRange {
  int lo, hi;
  __device__ KvRange(int kv_len, int lim, int Sq, int s_first, int s_last,
                     int causal, int window) {
    hi = lim;
    if (causal) hi = min(hi, kv_len - Sq + s_last + 1);
    lo = window > 0 ? max(0, kv_len - Sq + s_first - window + 1) : 0;
  }
};

// The async ring shared by both paths, kStages deep: tiles it + 1 ..
// it + kStages - 1 are in flight while tile it computes.  Before a tile's
// copies are issued, its table slice is in shared memory: each thread's
// entry for the next tile to issue is loaded into a register a tile ahead
// and stored after a compute.  `issue(stage, k0)` issues one tile's
// cp.async copies; `compute(stage, k0)` consumes a landed tile and leaves
// no wgmma in flight.  Q's copies (issued by the caller before this) join
// the first group.
template <int kStages, typename Lane, typename Issue, typename Compute>
__device__ __forceinline__ void kv_ring(const Lane& src, int* tab, int t0,
                                        int t1, int kt, int lim, Issue issue,
                                        Compute compute) {
  const int nt = t1 > t0 ? (t1 - t0 + kt - 1) / kt : 0;
  auto end_of = [&](int k0) { return min(k0 + kt, lim); };
  int ahead[kStages - 1];
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p)
    ahead[p] = src.fetch(t0 + p * kt, end_of(t0 + p * kt));
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p)
    src.put(tab + p * kTabSlot, t0 + p * kt, end_of(t0 + p * kt), ahead[p]);
  const int k_next = t0 + (kStages - 1) * kt;
  int next = src.fetch(k_next, end_of(k_next));
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nt) issue(p, t0 + p * kt);
    cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    const int j = it + kStages - 1, kj0 = t0 + j * kt;   // tile to issue
    if (j < nt) {
      src.put(tab + (j % kStages) * kTabSlot, kj0, end_of(kj0), next);
      next = src.fetch(kj0 + kt, end_of(kj0 + kt));
    }
    __syncthreads();   // the slice is staged; stage j % kStages is consumed
    if (j < nt) issue(j % kStages, kj0);
    cp_async_commit();
    // Tile it has landed (this thread's copies), then every thread's.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    compute(it % kStages, t0 + it * kt);
  }
}

// wgmma with f32 accumulators: D (+)= A.B over k16, bf16 operands.  _ss:
// A and B from shared memory, both K-major; _rs: A from registers (the
// m16k16 fragment of each warp's 16 rows), B MN-major (transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// wgmma shared-memory descriptor, no swizzle: 8 x 16-byte core matrices;
// lbo = bytes between core matrices along K, sbo = along M/N.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ------------------------------------------------------------ split path
//
// Shared memory: Q, two stages of K and V (the 8 rows of an 8 x 16-byte
// phase, ldmatrix's or a lane's, land on 8 different bank groups), per-row
// scratch, the final (m, l), and two table slots.  bf16 keeps Q as bf16 rows; f32 as f32 rows and also the tile's
// scores.
template <typename T> struct SplitSmem {
  static constexpr int KT = Vec<T>::kKeys;
  // bf16 rows are padded by 16 bytes for ldmatrix; f32 K rows are not,
  // their 16-byte chunks are swizzled instead (chunk c of key j at c ^ (j %
  // 8)), and f32 reads V by column: three f32 blocks fit an SM.
  static constexpr int kRow =
      kMaxD * static_cast<int>(sizeof(T)) + (sizeof(T) == 2 ? 16 : 0);
  static constexpr int kVRow = kRow;
  __device__ static int kchunk(int j, int c) {
    return sizeof(T) == 2 ? c : c ^ (j & 7);
  }
  // bf16: Q as bf16 rows, and per-warp row maxima and sums in place of
  // the scores; three bf16 blocks fit an SM as well.
  static constexpr int kQBytes =
      sizeof(T) == 2 ? kSplitRows * kRow : kSplitRows * kMaxD * 4;
  static constexpr int kSBytes =
      sizeof(T) == 2 ? 2 * 4 * kSplitRows * 4 : kSplitRows * KT * 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + 2 * KT * kRow;
  static constexpr int kS = kV + 2 * KT * kVRow;
  static constexpr int kA = kS + kSBytes;
  static constexpr int kML = kA + kSplitRows * 4;
  static constexpr int kTab = kML + kSplitRows * 8;
  static constexpr int kBytes = kTab + 2 * kTabSlot * 4;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// D (16 x 8, f32) += A (16 x 16, bf16, row-major) . B (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A row's log-sum-exp of its scaled scores in natural units, from its
// running max m and sum l in the units the dtype's softmax exponentiates
// (log2 units in bf16, natural in f32; kLn2 turns log2 into natural);
// -inf for a row with no visible key (l == 0).
constexpr float kLn2 = 0.6931471805599453f;
template <typename T> __device__ __forceinline__ float row_lse(float m,
                                                               float l) {
  if (l == 0.f) return -INFINITY;
  if constexpr (sizeof(T) == 2) return (m + log2f(l)) * kLn2;
  else return m + logf(l);
}

// chunk > 0: split path, blockIdx.x is the split, the block holds all
// R = Sq * group rows (<= kSplitRows) and writes partials to `part`.
// chunk == 0: the tile path's 16-row schedule (f32's only one, bf16's
// second), blockIdx.x is a block of kSplitRows rows over the whole kv
// range, written to `out` directly.
//
// bf16 multiplies on the tensor cores with mma.sync m16n8k16, the block's
// <= 16 packed rows as M: warp w scores keys [16 w, 16 w + 16) of a tile
// against all rows, the four warps exchange row maxima through shared
// memory so that all share one running max, and each warp accumulates P.V
// over its own keys; the four partial sums are added in warp order at the
// end.  f32 multiplies in IEEE f32 on the CUDA cores: thread (key j, row
// group) scores its rows, a warp runs the softmax of its rows, and thread
// d accumulates column d of every row.
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const T* __restrict__ q, KV kv,
                   const int* __restrict__ kv_lens, T* __restrict__ out,
                   float* __restrict__ part, float* __restrict__ lse, int Hq,
                   int Hkv, int Sq, int Skv, int D, float scale, int causal,
                   int window, int chunk) {
  using S = SplitSmem<T>;
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int KT = S::KT;
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem + S::kS);
  float* As = reinterpret_cast<float*>(smem + S::kA);
  float* MLs = reinterpret_cast<float*>(smem + S::kML);
  int* tab = reinterpret_cast<int*>(smem + S::kTab);

  const int b = blockIdx.z, hk = blockIdx.y;
  const int group = Hq / Hkv, R = Sq * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = kv_lens[b];
  const int lim = min(kv_len, Skv);
  const int r0 = chunk > 0 ? 0 : blockIdx.x * kSplitRows;
  const int rows = min(kSplitRows, R - r0);
  const KvRange rng(kv_len, lim, Sq, r0 / group, (r0 + rows - 1) / group,
                    causal, window);
  int t0 = (rng.lo / KT) * KT, t1 = rng.hi;
  if (chunk > 0) {
    const int c0 = blockIdx.x * chunk;
    // The merge reads splits [lo / chunk, ceil(hi / chunk)) and nothing
    // else; a split outside them (at or past the length) exits at once.
    if (c0 >= rng.hi || c0 + chunk <= (rng.lo / chunk) * chunk) return;
    t0 = max(t0, c0);
    t1 = min(t1, c0 + chunk);
  }
  // The merge may start launching now; it waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const typename KV::Lane src = kv.lane(b, hk);
  auto q_row = [&](int r) {   // packed row r of the block: r = s * group + g
    const int gr = r0 + r;
    return q + ((static_cast<int64_t>(b) * Hq + hk * group + gr % group) * Sq +
                gr / group) * D;
  };

  // Q rows: bf16 by cp.async into the first group (zeros past the rows and
  // past D), f32 as f32 (unrolled, every load in flight before a store).
  if constexpr (kMma) {
    for (int i = tid; i < kSplitRows * (kMaxD / 8); i += kThreads) {
      const int r = i >> 4, c = i & 15;
      const bool ok = r < rows && c * 8 < D;
      cp_async16(smem + S::kQ + r * S::kRow + c * 16,
                 ok ? q_row(r) + c * 8 : q, ok);
    }
  } else {
    float* Qs = reinterpret_cast<float*>(smem + S::kQ);
#pragma unroll
    for (int i = tid; i < kSplitRows * kMaxD; i += kThreads) {
      const int r = i / kMaxD, dd = i % kMaxD;
      Qs[i] = r < rows && dd < D ? Vec<T>::scalar(q_row(r)[dd]) : 0.f;
    }
  }

  auto issue = [&](int stage, int k0) {
    unsigned char* Kst = smem + S::kK + stage * KT * S::kRow;
    unsigned char* Vst = smem + S::kV + stage * KT * S::kVRow;
    const int* ts = tab + stage * kTabSlot;
    constexpr int nvec = kMaxD / N;              // zeros past D
    for (int i = tid; i < KT * nvec; i += kThreads) {
      const int row = i / nvec, c = i % nvec, kj = k0 + row;
      const bool ok = kj < lim && c * N < D;
      const int64_t off = ok ? src.offset(ts, row, kj) + c * N : 0;
      cp_async16(Kst + row * S::kRow + S::kchunk(row, c) * 16, src.kb + off,
                 ok);
      cp_async16(Vst + row * S::kVRow + c * 16, src.vb + off, ok);
    }
  };

  float acc[kSplitRows];             // column tid of every row, at the end
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r) acc[r] = 0.f;

  if constexpr (kMma) {
    // Fragments (g = lane / 4, t = lane % 4): S and O of a 16 x 8 tile hold
    // (row g, cols 2t, 2t + 1) and (row g + 8, same cols); h picks the row.
    const int g = lane >> 2, t4 = lane & 3;
    const float scale_log2 = scale * 1.4426950408889634f;
    float* Red = Ss;                 // row maxima: [warp][row]
    float o[kMaxD / 8][4];
#pragma unroll
    for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, lw[2] = {0.f, 0.f};
    int qpos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qpos[h] = kv_len - Sq + (r0 + g + 8 * h) / group;

    auto compute = [&](int stage, int k0) {
      const unsigned char* Qb = smem + S::kQ;
      const unsigned char* Kst = smem + S::kK + stage * KT * S::kRow;
      const unsigned char* Vst = smem + S::kV + stage * KT * S::kVRow;
      const int kw = 16 * warp;      // this warp's keys in the tile
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kMaxD / 16; ++ks) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, Qb + (lane & 15) * S::kRow + (ks * 16 + (lane >> 4) * 8) * 2);
        ldsm_x4(bk, Kst + (kw + (lane & 7) + (lane >> 4) * 8) * S::kRow +
                        (ks * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(sc[0], a, bk[0], bk[1]);
        mma_bf16(sc[1], a, bk[2], bk[3]);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int kj = k0 + kw + 8 * n + 2 * t4 + (i & 1);
          const bool vis = g + 8 * h < rows &&
                           visible(kj, qpos[h], lim, causal, window);
          sc[n][i] = vis ? sc[n][i] * scale_log2 : -INFINITY;
          mx[h] = fmaxf(mx[h], sc[n][i]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (t4 == 0) Red[warp * kSplitRows + g + 8 * h] = mx[h];
      }
      __syncthreads();
      float base[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        const float tm = fmaxf(fmaxf(Red[r], Red[kSplitRows + r]),
                               fmaxf(Red[2 * kSplitRows + r],
                                     Red[3 * kSplitRows + r]));
        const float m_new = fmaxf(m[h], tm);
        base[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - base[h]);       // 0 while m is -inf
        m[h] = m_new;
        lw[h] *= alpha[h];
      }
      uint32_t pa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p0 = exp2f(sc[n][2 * hh] - base[hh]);
          const float p1 = exp2f(sc[n][2 * hh + 1] - base[hh]);
          lw[hh] += p0;
          lw[hh] += p1;
          pa[2 * n + hh] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
#pragma unroll
      for (int dp = 0; dp < kMaxD / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vst + (kw + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kVRow +
                          (dp * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    };

    kv_ring<2>(src, tab, t0, t1, KT, lim, issue, compute);

    // Add the four warps' partial sums in warp order through shared memory
    // (the K stages are free now).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lw[h] += __shfl_xor_sync(0xffffffffu, lw[h], 1);
      lw[h] += __shfl_xor_sync(0xffffffffu, lw[h], 2);
    }
    __syncthreads();
    float* Ow = reinterpret_cast<float*>(smem + S::kK);  // [warp][row][d]
    float* Lw = Ss + 4 * kSplitRows;                     // [warp][row]
#pragma unroll
    for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ow[(warp * kSplitRows + g + 8 * (i >> 1)) * kMaxD + 8 * n + 2 * t4 +
           (i & 1)] = o[n][i];
    if (t4 == 0) {
      Lw[warp * kSplitRows + g] = lw[0];
      Lw[warp * kSplitRows + g + 8] = lw[1];
      if (warp == 0) { MLs[2 * g] = m[0]; MLs[2 * (g + 8)] = m[1]; }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const float* c = Ow + r * kMaxD + tid;
      acc[r] = ((c[0] + c[kSplitRows * kMaxD]) + c[2 * kSplitRows * kMaxD]) +
               c[3 * kSplitRows * kMaxD];
    }
    if (tid < kSplitRows)
      MLs[2 * tid + 1] = ((Lw[tid] + Lw[kSplitRows + tid]) +
                          Lw[2 * kSplitRows + tid]) + Lw[3 * kSplitRows + tid];
    __syncthreads();
  } else {
    static_assert(N == 4, "the f32 loop keeps one partial sum per lane of a float4");
    constexpr int RG = kThreads / KT;        // row groups in the score loop
    constexpr int RPT = kSplitRows / RG;     // rows a thread scores
    const float* Qs = reinterpret_cast<const float*>(smem + S::kQ);
    float m[4], l[4];                        // softmax state of rows warp + 4 i
#pragma unroll
    for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }

    auto compute = [&](int stage, int k0) {
      const unsigned char* Kst = smem + S::kK + stage * KT * S::kRow;
      const T* Vst = reinterpret_cast<const T*>(smem + S::kV + stage * KT * S::kVRow);
      constexpr int kVStride = S::kVRow / static_cast<int>(sizeof(T));
      // Scores: thread (key j, row group rg) scores rows rg + RG * i over
      // all kMaxD columns (Q and K are zero past D), with N partial sums
      // per row so that no chain of FMAs is longer than kMaxD / N.
      {
        const int j = tid % KT, rg = tid / KT, kj = k0 + j;
        const T* kr = reinterpret_cast<const T*>(Kst + j * S::kRow);
        float sc[RPT][N];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < N; ++e) sc[i][e] = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxD; c += N) {
          float kf[N];
          Vec<T>::load(kr + S::kchunk(j, c / N) * N, kf);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = rg + RG * i;
            if (r < rows) {
              const float* qr = Qs + r * kMaxD + c;
#pragma unroll
              for (int e = 0; e < N; ++e) sc[i][e] += qr[e] * kf[e];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + RG * i;
          if (r < rows) {
            const int qp = kv_len - Sq + (r0 + r) / group;
            const float dot = (sc[i][0] + sc[i][1]) + (sc[i][2] + sc[i][3]);
            Ss[r * KT + j] = visible(kj, qp, lim, causal, window)
                                 ? dot * scale : -INFINITY;
          }
        }
      }
      __syncthreads();
      // Online softmax: warp w owns rows w + 4 i, a lane keys lane + 32 e.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp + 4 * i;
        if (r < rows) {
          float sv[KT / 32], mx = -INFINITY;
#pragma unroll
          for (int e = 0; e < KT / 32; ++e) {
            sv[e] = Ss[r * KT + lane + 32 * e];
            mx = fmaxf(mx, sv[e]);
          }
          mx = warp_max(mx);
          const float m_new = fmaxf(m[i], mx);
          float alpha = 1.f, ps = 0.f;
          if (m_new != -INFINITY) {
            alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
#pragma unroll
            for (int e = 0; e < KT / 32; ++e) {
              const float p = sv[e] == -INFINITY ? 0.f : expf(sv[e] - m_new);
              Ss[r * KT + lane + 32 * e] = p;
              ps += p;
            }
          } else {
#pragma unroll
            for (int e = 0; e < KT / 32; ++e) Ss[r * KT + lane + 32 * e] = 0.f;
          }
          ps = warp_sum(ps);
          l[i] = alpha * l[i] + ps;
          m[i] = m_new;
          if (lane == 0) As[r] = alpha;
        }
      }
      __syncthreads();
      // P.V: thread tid owns column tid of every row.
      if (tid < D) {
#pragma unroll
        for (int r = 0; r < kSplitRows; ++r)
          if (r < rows) acc[r] *= As[r];
#pragma unroll 2
        for (int j = 0; j < KT; j += 4) {
          const float v0 = Vec<T>::scalar(Vst[(j + 0) * kVStride + tid]);
          const float v1 = Vec<T>::scalar(Vst[(j + 1) * kVStride + tid]);
          const float v2 = Vec<T>::scalar(Vst[(j + 2) * kVStride + tid]);
          const float v3 = Vec<T>::scalar(Vst[(j + 3) * kVStride + tid]);
#pragma unroll
          for (int r = 0; r < kSplitRows; ++r) {
            if (r < rows) {
              const float4 p = *reinterpret_cast<const float4*>(Ss + r * KT + j);
              float x = acc[r];
              x += p.x * v0; x += p.y * v1; x += p.z * v2; x += p.w * v3;
              acc[r] = x;
            }
          }
        }
      }
    };

    kv_ring<2>(src, tab, t0, t1, KT, lim, issue, compute);

    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp + 4 * i;
        if (r < rows) { MLs[2 * r] = m[i]; MLs[2 * r + 1] = l[i]; }
      }
    }
    __syncthreads();
  }

  if (chunk > 0) {
    float* pb = part + ((static_cast<int64_t>(b) * Hkv + hk) * gridDim.x +
                        blockIdx.x) * kPartFloats;
    if (tid < 2 * rows) pb[tid] = MLs[tid];
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < kSplitRows; ++r)
        if (r < rows) pb[2 * kSplitRows + r * kMaxD + tid] = acc[r];
    }
    return;
  }
  if (lse != nullptr && tid < rows) {
    const int gr = r0 + tid;
    lse[(static_cast<int64_t>(b) * Hq + hk * group + gr % group) * Sq +
        gr / group] = row_lse<T>(MLs[2 * tid], MLs[2 * tid + 1]);
  }
  if (tid >= D) return;
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r) {
    if (r < rows) {
      const float lr = MLs[2 * r + 1];
      const int gr = r0 + r;
      out[((static_cast<int64_t>(b) * Hq + hk * group + gr % group) * Sq +
           gr / group) * D + tid] = Vec<T>::from(lr == 0.f ? 0.f : acc[r] / lr);
    }
  }
}

// The split path's partial maxima are in the units its softmax
// exponentiates: log2 units in bf16 (exp2f), natural units in f32 (expf).
template <typename T> __device__ __forceinline__ float exp_of(float x) {
  if constexpr (sizeof(T) == 2) return exp2f(x);
  else return expf(x);
}

// Merge of the split path: block (row r, hk, b), thread = column; splits
// [lo / chunk, ceil(hi / chunk)) in split order, as flash_split_kernel
// wrote them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float* __restrict__ part,
                     const int* __restrict__ kv_lens, T* __restrict__ out,
                     float* __restrict__ lse, int Hq, int Hkv, int Sq,
                     int Skv, int D, int causal, int window, int chunk,
                     int n_x) {
  // The split kernel has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid >= D) return;
  const int group = Hq / Hkv;
  const int kv_len = kv_lens[b];
  const KvRange rng(kv_len, min(kv_len, Skv), Sq, 0, Sq - 1, causal, window);
  const int s0 = rng.lo / chunk;
  const int s1 = rng.hi > 0 ? (rng.hi + chunk - 1) / chunk : 0;
  const float* pb =
      part + (static_cast<int64_t>(b) * Hkv + hk) * n_x * kPartFloats;
  float mm = -INFINITY;
#pragma unroll 4
  for (int s = s0; s < s1; ++s) mm = fmaxf(mm, pb[s * kPartFloats + 2 * r]);
  float ll = 0.f, o = 0.f;
  if (mm != -INFINITY) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const float* ps = pb + s * kPartFloats;
      const float ms = ps[2 * r];
      const float c = ms == -INFINITY ? 0.f : exp_of<T>(ms - mm);
      ll += ps[2 * r + 1] * c;
      o += ps[2 * kSplitRows + r * kMaxD + tid] * c;
    }
  }
  const int s = r / group, h = hk * group + r % group;
  out[((static_cast<int64_t>(b) * Hq + h) * Sq + s) * D + tid] =
      Vec<T>::from(ll == 0.f ? 0.f : o / ll);
  // The row's statistics over every split: one more store.
  if (lse != nullptr && tid == 0)
    lse[(static_cast<int64_t>(b) * Hq + h) * Sq + s] = row_lse<T>(mm, ll);
}

// ------------------------------------------- tile path, bf16 tensor cores
//
// Shared memory in wgmma's no-swizzle core-matrix layouts, D padded to
// kMaxD with zeros: Q and K K-major, byte (row, d) at (row / 8) * 2048 +
// (d / 8) * 128 + (row % 8) * 16 + (d % 8) * 2 (lbo 128, sbo 2048); V
// MN-major, byte (key, d) at (d / 8) * 1024 + (key / 8) * 128 + (key % 8)
// * 16 + (d % 8) * 2 (lbo 128 along keys, sbo 1024 along d).  Every copy
// is one 16-byte core-matrix row.
struct TileSmem {
  static constexpr int kQ = 0;
  static constexpr int kMat = kTileRows * kMaxD * 2;   // 16 KB
  static constexpr int kK = kQ + kMat;
  static constexpr int kV = kK + kTileStages * kMat;
  static constexpr int kTab = kV + kTileStages * kMat;
  static constexpr int kBytes = kTab + kTileStages * kTabSlot * 4;
};

__device__ __forceinline__ int kmajor(int row, int c) {   // c: d / 8
  return (row >> 3) * 2048 + c * 128 + (row & 7) * 16;
}
__device__ __forceinline__ int vmajor(int key, int c) {
  return c * 1024 + (key >> 3) * 128 + (key & 7) * 16;
}

template <typename KV>
__global__ void __launch_bounds__(kThreads)
flash_tile_kernel(const __nv_bfloat16* __restrict__ q, KV kv,
                  const int* __restrict__ kv_lens,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int Hq, int Hkv, int Sq, int Skv, int D, float scale_log2,
                  int causal, int window) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem + TileSmem::kQ;
  int* tab = reinterpret_cast<int*>(smem + TileSmem::kTab);

  const int b = blockIdx.z, hk = blockIdx.y;
  const int group = Hq / Hkv, R = Sq * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = kv_lens[b];
  const int lim = min(kv_len, Skv);
  const int r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, R - r0);
  const KvRange rng(kv_len, lim, Sq, r0 / group, (r0 + rows - 1) / group,
                    causal, window);
  const int t0 = (rng.lo / kTileKeys) * kTileKeys;
  const typename KV::Lane src = kv.lane(b, hk);

  // Q: 64 packed rows x 16 chunks of 8, zeros past the rows and past D.
  for (int i = tid; i < kTileRows * (kMaxD / 8); i += kThreads) {
    const int r = i >> 4, c = i & 15, gr = r0 + r;
    const bool ok = r < rows && c * 8 < D;
    const bf16* p = q;
    if (ok) {
      const int s = gr / group, h = hk * group + gr % group;
      p = q + ((static_cast<int64_t>(b) * Hq + h) * Sq + s) * D + c * 8;
    }
    cp_async16(Qs + kmajor(r, c), p, ok);
  }

  auto issue = [&](int stage, int k0) {
    unsigned char* Kst = smem + TileSmem::kK + stage * TileSmem::kMat;
    unsigned char* Vst = smem + TileSmem::kV + stage * TileSmem::kMat;
    const int* ts = tab + stage * kTabSlot;
    for (int i = tid; i < kTileKeys * (kMaxD / 8); i += kThreads) {
      const int row = i >> 4, c = i & 15, kj = k0 + row;
      const bool ok = kj < lim && c * 8 < D;
      const int64_t off = ok ? src.offset(ts, row, kj) + c * 8 : 0;
      cp_async16(Kst + kmajor(row, c), src.kb + off, ok);
      cp_async16(Vst + vmajor(row, c), src.vb + off, ok);
    }
  };

  // Accumulator fragment of m64nN: element i of thread (warp, lane) is
  // row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
  // 2 * (lane % 4) + (i & 1).  A thread holds two rows, h = 0 and 1.
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    row_ok[h] = r < rows;
    qpos[h] = kv_len - Sq + (r0 + r) / group;
  }

  auto compute = [&](int stage, int k0) {
    const unsigned char* Kst = smem + TileSmem::kK + stage * TileSmem::kMat;
    const unsigned char* Vst = smem + TileSmem::kV + stage * TileSmem::kMat;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kMaxD / 16; ++ks)
      wgmma_m64n64k16_ss(s, gmma_desc(Qs + ks * 256, 128, 2048),
                         gmma_desc(Kst + ks * 256, 128, 2048), ks > 0);
    wgmma_commit_wait();
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kj = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool vis = row_ok[h] && visible(kj, qpos[h], lim, causal, window);
      s[i] = vis ? s[i] * scale_log2 : -INFINITY;
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float base[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      base[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - base[h]);        // 0 while m is -inf
      m[h] = m_new;
      l[h] *= alpha[h];
    }
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2f(s[i] - base[h]), p1 = exp2f(s[i + 1] - base[h]);
      l[h] += p0;
      l[h] += p1;
      __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
      a[i >> 3][(i >> 1) & 3] = *reinterpret_cast<uint32_t*>(&pk);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk)
      wgmma_m64n128k16_rs(o, a[kk], gmma_desc(Vst + kk * 256, 128, 1024), 1);
    wgmma_commit_wait();
  };

  kv_ring<kTileStages>(src, tab, t0, rng.hi, kTileKeys, lim, issue,
                        compute);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int gr = r0 + 16 * warp + (lane >> 2) + 8 * h;
    const int s = gr / group, hq = hk * group + gr % group;
    bf16* orow = out + ((static_cast<int64_t>(b) * Hq + hq) * Sq + s) * D;
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<int64_t>(b) * Hq + hq) * Sq + s] =
          row_lse<bf16>(m[h], l[h]);
    const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// One C call of either kernel: the schedule from (Hq, Hkv, Sq), the
// launches (the split path's merge after its splits, on the same stream),
// and the CUDA error code of the first launch that failed (0 on success).
// `chunk` is the split path's keys per split: a positive multiple of the
// split tile Vec<T>::kKeys (64 keys bf16, 32 f32), Vec<T>::kChunk by
// default; splits sit at absolute multiples of it.  `block_rows` is the
// tile path's schedule: kTileRows, the wgmma warpgroup (bf16 only, its
// default), or kSplitRows, the split kernel's loop over the whole kv range
// (f32's only schedule).  `part` is the wrapper's scratch: B * Hkv *
// ceil(Skv / chunk) splits of kPartFloats floats, needed by the split
// path only.  `lse`, where not null, receives each query row's
// log-sum-exp of its scaled scores, f32 (B, Hq, Sq) in natural units
// (-inf for a row with no visible key): one store a row, in whichever
// kernel writes the row's output; the output's bits do not depend on it.
template <typename T, typename KV>
int launch(const void* q, KV kv, const int* kv_lens, void* out, void* part,
           int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
           int causal, int window, int chunk, int block_rows,
           cudaStream_t s, float* lse = nullptr) {
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
  const int R = Sq * (Hq / Hkv);
  static int split_ready =
      allow_smem(flash_split_kernel<T, KV>, SplitSmem<T>::kBytes);
  if (split_ready != 0) return split_ready;
  if (use_split(Hq, Hkv, Sq)) {
    if (part == nullptr || chunk <= 0 || chunk % Vec<T>::kKeys != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int n_x = (Skv + chunk - 1) / chunk;
    float* pf = static_cast<float*>(part);
    if (n_x > 0) {
      flash_split_kernel<T, KV>
          <<<dim3(n_x, Hkv, B), kThreads, SplitSmem<T>::kBytes, s>>>(
              qt, kv, kv_lens, ot, pf, lse, Hq, Hkv, Sq, Skv, D, scale,
              causal, window, chunk);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    // The merge launches while the splits run (programmatic dependent
    // launch) and waits for them inside (griddepcontrol.wait), which hides
    // its launch latency.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R, Hkv, B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, flash_combine_kernel<T>, static_cast<const float*>(pf), kv_lens,
        ot, lse, Hq, Hkv, Sq, Skv, D, causal, window, chunk, n_x));
  }
  if (block_rows != kSplitRows && (sizeof(T) != 2 || block_rows != kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2) {
    if (block_rows == kTileRows) {
      static int tile_ready =
          allow_smem(flash_tile_kernel<KV>, TileSmem::kBytes);
      if (tile_ready != 0) return tile_ready;
      const dim3 grid((R + kTileRows - 1) / kTileRows, Hkv, B);
      flash_tile_kernel<KV><<<grid, kThreads, TileSmem::kBytes, s>>>(
          qt, kv, kv_lens, ot, lse, Hq, Hkv, Sq, Skv, D,
          scale * 1.4426950408889634f, causal, window);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const dim3 grid((R + kSplitRows - 1) / kSplitRows, Hkv, B);
  flash_split_kernel<T, KV><<<grid, kThreads, SplitSmem<T>::kBytes, s>>>(
      qt, kv, kv_lens, ot, nullptr, lse, Hq, Hkv, Sq, Skv, D, scale, causal,
      window, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_fa
