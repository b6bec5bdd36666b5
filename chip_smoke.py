"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device   — the card's name and power limit, the torch and CUDA
              versions; requires compute capability >= (9, 0).
2. build    — compiles the port's CUDA kernels from src/repro_torch.
3. kernels  — each kernel against its plain PyTorch version on the card
              at the serve path's shapes, in bf16 and f32, with times of
              the kernel, the plain version, one PyTorch library call
              (a yardstick only) and the least time the card could take.
              Kernel 1's three entries (``[kernel rmsnorm]``, ``entry``:
              rmsnorm; add_rmsnorm at 8 and 4096 rows of 1024;
              qk_norm_rope at decode B 8 and prefill L 256), each fused
              launch bit for bit against its unfused card composition,
              the fused ones timed beside the chain of library calls they
              replace; every kernel 1 time also after a clean L2 flush.
              Each attention record names the schedule
              (``attention_plan``: ``split`` or ``tile``).  Then the edge
              sweep of kernel 2 (``edge_sweep``): Sq around the split
              path's 16 packed rows and the tile path's 64, kv lengths
              around the 64-key tiles and the 128/256-key splits, head
              groups 2, 1 and 4, windows on the tile path; each case within
              tolerance of the plain version and bit-identical over two
              calls (``[sweep flash_attention]`` lines).
4. model    — qwen3-0.6b at full width, f32, one 64-token prompt through
              forward_cached on the card and on the CPU, same weights.
5. serve    — the ServeScheduler at full width, bf16, random weights:
              16 requests, 8 slots, dispatch depth "auto", every decode
              step a replay of a captured CUDA graph
              (``serve/graphs.py``); the kernels' launch counters are
              reset before and read after this run, and every forward
              must launch kernel 1 exactly 85 times (``ForwardSpy``,
              which hears of replays).  A profiled window, and a profiled
              fused dispatch of 16 decode steps (``decode_census``: CUDA
              kernels, kernel 1 launches and host launch calls per
              decode-loop iteration, then the synced wall of the same
              dispatch).  ``[graph]`` lines: captures per kind, replays,
              the reserved attention scratch and the graph pool's bytes,
              and the census (at most 5 host launch calls per iteration);
              then the graphs against their eager body over the same
              kernels (``graph_identity``: one fused dispatch contiguous
              and paged, one speculative dispatch at d = 2, 4, 8, and at
              4 paged, twice each: tokens, history, stats and K/V rows
              bit-identical).
6. algorithms — the paper's parallel algorithms and their four 1-d
              kernels (reduce_sum, inclusive_scan, adjacent_difference,
              artificial_work).  Each kernel against its plain version at
              n = 2^20, 2^24, 2^26 (f32, and bf16 where the reference
              takes it), timed like phase 3; reduce_sum and
              inclusive_scan also against the float64 exact sum
              (``sum_limit``; the bf16 scan rounds once), on signed
              integers bit for bit, and five calls bit-identical, with
              two yardsticks: their times after an L2 flush that leaves
              no dirty lines, and a copy of the scan's bytes.  Then
              their edge sweep (``sum_sweep``): misaligned views, n
              around a tile and the scan's largest segment, groups of
              31-33 segments, blocks below and above a segment, each
              case in f32 and bf16 within ``sum_limit`` and
              deterministic, and both kernels on two streams at once
              (``[sweep reduce_sum]`` / ``[sweep inclusive_scan]``
              lines), and kernel 6's (``adjdiff_sweep``: misaligned views,
              n around a vector and a tile, blocks below a tile and of no
              whole number of vectors, a `par` call's interior chunks),
              each bit-equal to its plain version.  The measured block
              plan (``KernelTuner``) for two
              of them.  Then adjacent_difference,
              reduce, inclusive_scan, exclusive_scan, artificial_work and
              transform at n = 2^24 and 2^26 under seq, static par and
              acc par (8 workers), each held against the plain function,
              with the acc decisions printed; the 1-d kernels' launch
              counters are reset before and read after this run.
7. paged    — qwen3-0.6b at full width, bf16, served from the paged
              pool with page size, depth and speculation "auto" (16
              shared-prefix requests from the port's load generator,
              decoding through the graphs, a ``[graph] phase 7`` line;
              the launch counters are reset before and read after this
              run, every forward must launch kernel 1 85 times, and
              every shape kernel 3 ran at is noted from its counter's
              keys).  Then kernel 3
              (paged flash attention) against its plain version and, bit
              for bit, against kernel 2 over the same K/V laid out
              contiguously: decode (B 8, kv 1-1024), verify at every
              speculation width (Sq 2, 4, 8) and a prefill chunk (Sq 256
              into kv 700), at page sizes 16, 64 and the one the main run
              picked, bf16 and f32, permuted tables with garbage in
              unmapped rows, plus every other shape the main run gave it;
              timed like phase 3, each bit-identical over two calls.
              Then the edge sweep of kernel 3 at the picked page size
              and 16: within tolerance, bit-equal to kernel 2 and
              deterministic (``[sweep paged_flash_attention]`` lines).
              Then the same 8 requests in f32
              contiguous, paged, and paged with speculation at each width
              (tokens identical, or a first divergence only at a
              near-tie); the asyncio front end over the paged
              speculative scheduler with adaptive admission replaying a
              Poisson trace, its streamed tokens held against the batch
              path's; and the same replay with every decision "auto"
              (budgets, vocabulary and launch counters checked).
8. train    — the training path.  Kernel 1's backward (three entries, at
              4096 and 8192 rows of 1024 and q/k at B·S 4096, bf16 and
              f32; rmsnorm and add_rmsnorm also at 8 and 4096 rows of
              1536, 2048, 2560, 4096, 5120 and 6144, the generic loop
              but for bf16 2048, their f32 gradients within 1e-3 of each
              leaf's norm of the CPU's) against its plain version, two
              calls bit-identical, timed like phase 3 beside
              ``torch.autograd.grad`` through ``F.rms_norm`` (or the
              chain of library calls a fused entry replaces).  One
              AdamW step each of h2o-danube-1.8b (2 layers),
              zamba2-1.2b (6) and llama-3.2-vision-11b (5) at full
              width, f32 masters drawn on the card (``[train wide]``).  qwen3-0.6b full-width f32 gradients, card
              against CPU.  Eight bf16 training steps of 8 x 512 (acc
              plan, remat, AdamW, strict mode), the launch counters reset
              before and read after them: kernel 1 must run 6·28 + 1
              forward (remat's recompute included) and 85 backward
              launches a step, and the loss of the repeated batch must
              fall; one profiled step.  A fault-tolerant run with a
              failure at step 3 against an uninterrupted one (2 layers).
              Kernel 2's forward-only prefill (f32 and bf16, batch 2 x
              512): each layer's output against the plain version on that
              layer's q/k/v, and the logits against the chunked forward.
9. dense    — the dense family (``_dense_phase``).  Kernel 1 at rows of
              1536, 2560, 5120 and 6144 (rmsnorm, add_rmsnorm; 8 and
              2048 rows, bf16 and f32), timed like phase 3; the sweep of
              kernels 2 and 3 at head groups (48, 1), (40, 40), (32, 8)
              and head dims 64, 80, 128 (kernel 3 bit-equal to kernel 2,
              each case deterministic; windows at danube's heads).  Then
              per arch, random weights (seed 0) drawn once in f32 (on
              the host for danube, whose ring is held against the CPU;
              on the card for the others, since PR 22):
              h2o-danube-1.8b at full width and depth (f32: logits card
              vs CPU; a 4600-token prompt prefilled in chunks of 256
              through the ring of 4096 rows, its last row and the decode
              step after the wrap against ``lm.forward``, within 2e-3;
              bf16: 16 requests, 4 of them past the ring, 8 slots,
              ``max_len`` 8192, contiguous), musicgen-medium at full depth,
              granite-34b and qwen1.5-32b at 2 layers (``DENSE_DEPTH``),
              each served in bf16 contiguous and paged (16 requests,
              prompts 64-512) and held to f32 tokens contiguous ==
              paged.  Every serve run resets the launch counters before
              and reads them after, and every forward must launch kernel
              1 (3 if qk-norm else 2) * layers + 1 times.  Kernels 2 and
              3 at each arch's decode and main-run prefill shapes, timed
              like phase 3.  One ``[arch]`` JSON line per arch.
10. moe     — mixture-of-experts (``_moe_phase``): mixtral-8x22b and
              grok-1-314b at full width, 2 layers (``MOE_DEPTH``), random
              weights (seed 0) drawn once in f32 on the card (since PR
              22; before, on the host and moved over).  The sweep
              of kernels 2 and 3 at group 6 (48, 8), D 128, with windows on
              kernel 2.  Per arch in f32: one MoE layer card vs CPU at 8
              and 256 rows (the same experts and kept choices, outputs
              within 1e-4 relative, the dropped choices counted);
              mixtral's ring (the 4600-token chunked prefill and the decode
              after the wrap against ``lm.forward``, within 1e-4, at a
              drop-free capacity factor); grok's tokens contiguous ==
              paged.  Then the weights cast on the card to bf16 (norm
              gains and routers kept f32): one MoE layer's device time at
              8 and 256 rows beside its bound, serving as in phase 9
              (mixtral contiguous with 4 prompts past its ring, grok
              contiguous and paged), grok's graphs against their eager
              body (``graph_identity``), a decode census per arch (at most
              5 host launch calls a step, 5 kernel-1 launches), kernels 2
              and 3 at each arch's decode and prefill shapes.  One
              ``[arch]`` JSON line per arch.
11. hybrid  — the hybrid Mamba2 family (``_hybrid_phase``): zamba2-1.2b
              at full width and depth (38 layers: 32 Mamba2 blocks and 6
              uses of one shared attention block), random weights (seed
              0) drawn once in f32.  Kernel 1 at rows of 2048 (rmsnorm,
              add_rmsnorm; 8 and 2048 rows, bf16 and f32) timed like phase
              3, each bit-identical over two calls.  f32: logits of a
              64-token prompt card vs CPU (2e-3); a 300-token prompt served
              by the scheduler, its chunks replayed through
              ``forward_cached`` (one recurrent step a token), the last
              row and the next decode step against ``lm.forward`` (the
              chunk-parallel GLA; 2e-3) (``[hybrid chunked]``); tokens
              contiguous == paged.  bf16 serving as in phase 9 (16
              requests, prompts 32-128, both pools, speculation off; each
              forward 45 kernel-1 launches; K/V and state MiB of each
              pool), ``graph_identity`` (tokens, K/V and every state row),
              a profiled serve window (idle share, kernels by group), a
              decode census beside the step's bound (at most 5 host
              launch calls), kernels 2 and 3 at the arch's decode and
              prefill shapes.  One ``[arch]`` JSON line.
12. xlstm   — the xLSTM family (``_xlstm_phase``): xlstm-350m at full
              width and depth (21 mLSTM and 3 sLSTM blocks; no layer
              attends, kernel 1 is its path's one kernel), as phase 11:
              f32 logits card vs CPU, the per-token prefill against the
              chunk-parallel forward (``[xlstm chunked]``), contiguous ==
              paged; bf16 serving of 16 requests (prompts 32-128, 64 new
              tokens, 8 slots, ``max_len`` 1024, both pools, speculation
              off; 25 kernel-1 launches a forward), ``graph_identity``
              (every state row), a profiled window and a decode census;
              then 3 training steps at full depth, 8 x 512.
13. vision  — the vision family (``_vision_phase``):
              llama-3.2-vision-11b at full width and depth, bf16
              weights drawn on the card.  Kernel 1 at 8 and 2048 rows of
              4096 and ``kv_norm`` over 8 x 1601 rows; kernel 2 at its
              self-attention decode and prefill and its non-causal
              cross-attention decode (Sq 1) and prefill (Sq 256) over the
              1601 frontend tokens, each against its plain version and
              timed beside SDPA.  f32 logits card vs CPU at one pattern
              group; then 8 requests (prompt 256, 64 new tokens, features
              from ``make_batch``) through ``serve_cross_attention``
              (the engine's lock-step path; 89 kernel-1 launches a
              forward), TTFT and each decode step beside its bound; the
              same requests on a one-rank NCCL mesh (what ``launch/
              serve.py --mesh 1,1`` runs for the arch, with this phase's
              weights), 16 new tokens each, bit-equal to the no-mesh
              run's first 16 (``[serve13 mesh]``).
14. tune    — measured kernel plans (``_tune_phase``, alone:
              ``tune_main()``), every tuner over a fresh temporary
              store.  Kernel 1's forward at every candidate warp count
              (8 and 4096 rows of 1024, 8 rows of 6144; bf16, f32): bit
              for bit the default launch's, within tolerance of the
              plain version, timed.  Kernels 2 and 3 at every candidate
              chunk or schedule (decode B 8, verify Sq 2/4/8, prefill Sq
              256 over kv 700; bf16, f32): within phase 3's tolerances,
              kernel 3 bit-equal to kernel 2 and two calls bit-identical,
              timed beside the bound and SDPA.  qwen3-0.6b at full width
              served with a ``KernelTuner`` (phase 5's 16 requests,
              contiguous, then paged with speculation; analytic and tuned
              in turns A B B A: tok/s, TTFT), the launch counters reset
              around the first tuned run; its searches (the decode plans
              measured on the first dispatch over a full pool, on its
              own lanes) and each winner against its prior; the
              contiguous runs again with every online decision pinned,
              analytic and tuned in turns A B B A after eight warm
              requests each, and one forward's host time each way; ``decode_cost_analysis`` of
              the live step mid-run beside the measured step; the launch
              audit of the live steps (clean) and of the injected host
              copy (a violation); f32: tuned decode logits within 2e-3
              of the analytic ones, tuned paged tokens == tuned
              contiguous tokens; the reduced config's count equal on the
              card and the CPU, f32 and bf16 (tensor-core flops > 0);
              three training steps (8 x 512) through ``launch/train.py
              --kernel-autotune``; then the serve CLI
              (``launch/serve.py --kernel-autotune``) twice over each of
              two fresh stores, contiguous and paged with speculation at
              width 4 (the second process: 0 searches), the first round
              beside the launch-audit CLI (rc 0, and rc 1 with
              ``--inject-host-copy``).
15. mesh    — multi-GPU on ``torch.distributed`` at world size 1 over
              NCCL (``_mesh_phase``, alone: ``mesh_main()``; NCCL takes
              one rank per card, so one card proves the code path only):
              its rendezvous a file in a temporary directory,
              ``make_serve_mesh(1, 1)``.  qwen3-0.6b at full width, bf16,
              phase 5's 16 requests with ``serve_pinned_main``'s
              decisions, contiguous and paged (with speculation at 2):
              the mesh scheduler's tokens bit-equal to the no-mesh
              scheduler's, tok/s, TTFT p50 and the fused step's replay
              time beside the no-mesh run's (``[mesh serve]``); the
              launch audit of one replay of each mesh step (one graph
              launch, its NCCL kernels counted, no host copy above 64 B;
              ``[mesh audit]``); the mesh branches of reduce,
              inclusive_scan, adjacent_difference and artificial_work
              (``*_on_mesh``, with the entries' own bodies; the entries
              take them only with two cores or more) at 2^24 f32 on a
              one-rank sub-group through kernels 4-7, bit-equal to the
              no-mesh kernel calls (``[mesh algorithms]``); one
              int8-compressed data-parallel step at full width and 2
              layers, each quantisation group's synced gradient within
              one int8 quantum of the plain f32 mean (``[mesh dp]``);
              8 of the requests (32 new tokens) through the asyncio
              front end, all submitted before the first tick, on the
              mesh and off it: tokens bit-equal, each stream its
              record's (``[mesh frontend]``); the scheduler's
              ``decode_cost_analysis`` on the mesh equal to the no-mesh
              count, its collectives counted as calls with 0 bytes
              (``[mesh cost]``).
16. fsdp    — the FSDP × TP training step (``train/sharded.py``) at
              world size 1 over NCCL (``_fsdp_phase``, alone:
              ``fsdp_main()``): qwen3-0.6b at full width and depth, f32,
              two ``make_sharded_train_step`` steps of 4 x 512 at accum 2
              against two ``make_train_step`` steps from the same weights
              and batch (each after one untimed warm-up step on another
              copy): losses, norms and every parameter bit for bit,
              median step ms, kernel 1's forward and backward launches
              and the collective calls per step (``[fsdp train]``);
              mixtral-8x22b at full width, one pattern group, bf16
              parameters and moments, one step under global dispatch and
              one under ``moe_dispatch_groups(2)``, the same comparison,
              the bytes reckoned beforehand and
              ``torch.cuda.max_memory_allocated`` (``[fsdp moe]``);
              ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b
              --shape train_4k --mesh single`` as a subprocess beside them,
              which must exit 0 (``[dryrun]``, its report row).
17. tp      — tensor parallelism of the recurrent and cross-attention
              blocks and the sequence-split decode at world size 1 over
              NCCL (``_tp_phase``, alone: ``tp_main()``): kernel 2 with
              its rows' log-sum-exp out at the main decode shape (B 8,
              Hq 16, Hkv 8, D 128, kv 1-1024), danube's ring (B 2, Hq
              32, Hkv 8, D 80, kv 4096 and a partial lane) and the
              sequence-split decode's (B 1, a 64-row ring), bf16 and
              f32: the output bit-equal to the call without statistics,
              the statistics within 1e-5 of the plain version's, both
              timed with L2 flushed beside ``torch.compile``'d
              ``flex_attention`` (``[kernel flash_attention_lse]``); the
              cache cut into 2 and 4 blocks, merged by
              ``attention.merge_blocks`` against the whole cache
              (``[merge]``); zamba2-1.2b and xlstm-350m at full width
              and depth on ``make_serve_mesh(1, 1)``, 4 x 32-token
              prompts + 16 new tokens with every decision pinned,
              contiguous and paged: tokens bit-equal to the no-mesh
              scheduler's (``[tp serve]``); one sharded train step of
              zamba2 (6 layers), xlstm (8) and llama-vision (5), every
              block family on its tensor-parallel path at size 1
              (``split_at_one``),
              against the unsharded one, bit for bit (``[tp train]``);
              danube at full width and depth, batch 1, a 64-row window,
              96 steps one token a step through ``ServeEngine`` with
              ``cache_seq_model`` (the ring's rows on a one-rank 'model'
              axis, written past its end, kernel 2 with statistics, the
              gather and the merge) against no mesh at per-lane
              positions (the ring read in its row order), every step's
              logits bit-equal (``[seq decode]``; its launches are the
              ``flash_attention_lse`` entry's).
18. levers  — the attention rules over 'model', sequence parallelism and
              the weight-stationary experts at world size 1 over NCCL
              (``_levers_phase``, alone: ``levers_main()``; at a 'model'
              extent of 1 every head count divides, so "kv_shared", whose
              ranks share a kv head, needs m / Hkv > 1 and cannot run on
              one card: gloo CPU ranks prove it): qwen3-0.6b at full width
              and depth, f32, three sharded steps of 2 x 128 with
              ``seq_shard`` on the size-1 split path (``split_at_one``)
              against three unsharded ones (each after one untimed
              warm-up step), bit for bit, the collective calls per step
              and the median ms (``[sp train]``);
              phase 16's one-layer mixtral and its unsharded reference,
              one step with ``moe_ff2d`` on the size-1 split path, bit for
              bit (``[ff2d train]``, run inside phase 16 on its state);
              musicgen-medium at full width and depth served on
              ``make_serve_mesh(1, 1)`` through the contiguous pool with
              the "head_dim" rule forced (``force_attn``: the logits
              summed over the one-rank 'model' axis, plain attention),
              4 x 64-token prompts + 16 new tokens: in f32 the
              scheduler's tokens those of kernel 2's path (no mesh) and
              every lock-step decode step's logits within 2e-3 of it, and
              through the paged pool (pages of 9 rows: the contiguous
              run's 81 rows in 9 pages) the contiguous "head_dim" pool's
              tokens with neither kernel 2 nor kernel 3 launched, both
              pools' f32 step replay ms; in bf16 both lock-step paths'
              ms a step (``[head_dim serve]``).

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_BF16 = 989e12             # dense tensor-core bf16, data sheet
PEAK_F32 = 67e12               # f32 outside the tensor cores, data sheet
KERNEL_SIZES_1D = (2 ** 20, 2 ** 24, 2 ** 26)   # the paper's sizes and 4x
ALGORITHM_SIZES = (2 ** 24, 2 ** 26)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device time of one call of ``fn`` in ms.  CUDA events bracket
    each call; before the first event the stream is held busy by a spin
    (``torch.cuda._sleep``), so the events and the call's launches are all
    queued before the card reaches them and the span holds device time,
    not the host's launch overhead.  ``flush`` evicts L2 before each
    call, outside the span, as the serve path finds it between layers."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)       # ~1 ms of spin at ~2 GHz
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def work_bound(work) -> tuple[float, str]:
    """A kernel call's bound in ms, and what sets it ("bytes" or
    "operations"), from its wrapper's own count of its work
    (``build.Work``: ``rmsnorm.*_work``, ``flash_attention.*_work``)
    through ``analysis/roofline.bound_of`` (the data sheet's rates)."""
    from repro_torch.analysis import roofline

    seconds, by = roofline.bound_of(work)
    return seconds * 1e3, by


def within(torch, out, ref, atol, rtol) -> tuple[bool, float]:
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, float(diff.max())


class KernelBench:
    """Kernel cases on the card, each held against its plain version and
    timed (``time_ms``, L2 flushed before each call) beside the plain
    version, one PyTorch library call where one computes the function (a
    yardstick only) and ``bound_ms``, the least time the card could take
    (inputs read once, outputs written once, over the data sheet's
    rates).  Inputs come from one seeded device generator (``seed``), so
    the same calls in the same order draw the same data.  Each case
    appends its record to ``records[kernel]`` and logs it; ``check``
    fails the run on any case out of tolerance or not bit-equal where it
    must be."""

    # f32: the row's sum in another order; bf16: one rounding step.
    RMS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}

    def __init__(self, torch, dev, seed: int, kernels: tuple,
                 perm_seed: int | None = None):
        self.torch, self.dev = torch, dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.perm = None if perm_seed is None \
            else torch.Generator().manual_seed(perm_seed)
        self.scratch = torch.empty(96 * 2 ** 20, dtype=torch.uint8,
                                   device=dev)
        self.records = {name: [] for name in kernels}
        self.bit_bad: list = []

    def flush(self):
        self.scratch.zero_()

    def flush_clean(self):
        # Reads 96 MB: evicts L2 like `flush`, but leaves no dirty lines
        # for the timed call to write back.
        self.scratch.view(self.torch.float32).sum()

    def randn(self, *shape, dtype):
        return self.torch.randn(*shape, generator=self.gen,
                                device=self.dev).to(dtype)

    @staticmethod
    def bound_of(byts, ops, peak=PEAK_F32):
        t_b, t_o = byts / HBM_BYTES_PER_S, ops / peak
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    def check(self, what: str) -> None:
        bad = [r["shape"] for rs in self.records.values() for r in rs
               if not r["ok"]]
        if bad or self.bit_bad:
            fail(f"{what} disagree with their plain versions: {bad}; not "
                 f"bit-equal where they must be: {self.bit_bad}")

    def close(self) -> None:
        del self.scratch
        self.torch.cuda.empty_cache()

    def _log(self, kernel, rec):
        self.records[kernel].append(rec)
        log(f"[kernel {kernel}] {rec}")
        return rec

    # ------------------------------------------------------------ kernel 1
    def kernel1_times(self, rec, kernel, plain, library=None, chain=None):
        """Kernel 1's times, each after a dirty and after a clean L2
        flush: the kernel, its plain version, and the yardstick -- one
        library call, or for a fused entry (no one call computes it) the
        chain of library calls it replaces."""
        torch, flush, clean = self.torch, self.flush, self.flush_clean
        rec["ms"] = time_ms(torch, kernel, flush=flush)
        rec["ms_clean_l2"] = time_ms(torch, kernel, flush=clean)
        rec["plain_ms"] = time_ms(torch, plain, flush=flush)
        rec["library_ms"] = library and time_ms(torch, library, flush=flush)
        rec["library_ms_clean_l2"] = library and time_ms(
            torch, library, flush=clean)
        if chain is not None:
            rec["chain_ms"] = time_ms(torch, chain, flush=flush)
            rec["chain_ms_clean_l2"] = time_ms(torch, chain, flush=clean)

    def rms_case(self, rows, d, dtype, name=""):
        from repro_torch.kernels import rmsnorm as krms

        torch = self.torch
        x = self.randn(rows, d, dtype=dtype)
        g = 1.0 + 0.1 * self.randn(d, dtype=torch.float32)
        g_lib = g.to(dtype)
        out = krms.rmsnorm(x, g, eps=1e-6)
        ref = krms.rmsnorm_ref(x, g, eps=1e-6)
        torch.cuda.synchronize()
        atol, rtol = self.RMS_TOL[str(dtype)[6:]]
        ok, err = within(torch, out, ref, atol, rtol)
        bound, by = work_bound(krms.rmsnorm_work(x, g))
        rec = dict(entry="rmsnorm", shape=f"{name}rows={rows} d={d} "
                   f"{str(dtype)[6:]}", err=err, ok=ok,
                   tol=f"atol={atol} rtol={rtol}", bound_ms=bound,
                   bound_by=by)
        self.kernel1_times(
            rec, lambda: krms.rmsnorm(x, g, eps=1e-6),
            lambda: krms.rmsnorm_ref(x, g, 1e-6),
            library=lambda: torch.nn.functional.rms_norm(x, (d,), g_lib,
                                                         1e-6))
        return self._log("rmsnorm", rec)

    def add_case(self, rows, d, dtype, name=""):
        """add_rmsnorm against its plain version, and bit for bit against
        its unfused card composition: PyTorch's x + y, then kernel 1."""
        from repro_torch.kernels import rmsnorm as krms

        torch = self.torch
        x = self.randn(rows, d, dtype=dtype)
        y = self.randn(rows, d, dtype=dtype)
        g = 1.0 + 0.1 * self.randn(d, dtype=torch.float32)
        g_lib = g.to(dtype)
        s, h = krms.add_rmsnorm(x, y, g, eps=1e-6)
        s_ref, h_ref = krms.add_rmsnorm_ref(x, y, g, eps=1e-6)
        s_two = x + y
        h_two = krms.rmsnorm(s_two, g, eps=1e-6)
        torch.cuda.synchronize()
        atol, rtol = self.RMS_TOL[str(dtype)[6:]]
        ok, err = within(torch, h, h_ref, atol, rtol)
        bit_equal = torch.equal(s, s_two) and torch.equal(h, h_two)
        if not bit_equal:
            self.bit_bad.append(f"add_rmsnorm rows={rows} d={d} {dtype}")
        bound, by = work_bound(krms.add_rmsnorm_work(x, y, g))

        def chain():
            torch.nn.functional.rms_norm(x + y, (d,), g_lib, 1e-6)

        def unfused():
            krms.rmsnorm(x + y, g, eps=1e-6)

        rec = dict(entry="add_rmsnorm", shape=f"{name}rows={rows} d={d} "
                   f"{str(dtype)[6:]}", err=err,
                   ok=ok and torch.equal(s, s_ref),
                   bit_equal_unfused=bit_equal,
                   tol=f"h: atol={atol} rtol={rtol}; s: exact",
                   bound_ms=bound, bound_by=by,
                   library_note="no one PyTorch call; chain_ms: x + y, "
                                "F.rms_norm")
        self.kernel1_times(rec, lambda: krms.add_rmsnorm(x, y, g, eps=1e-6),
                           lambda: krms.add_rmsnorm_ref(x, y, g, 1e-6),
                           chain=chain)
        rec["unfused_ms"] = time_ms(torch, unfused, flush=self.flush)
        return self._log("rmsnorm", rec)

    def qk_case(self, name, b, length, hq, hkv, d, dtype):
        """qk_norm_rope against its plain version, and bit for bit against
        its unfused card composition: kernel 1 on q and on k, then the
        model's rotary embedding on each."""
        from repro_torch.kernels import rmsnorm as krms
        from repro_torch.models import common as cm

        torch, dev = self.torch, self.dev
        q = self.randn(b, length, hq, d, dtype=dtype)
        k = self.randn(b, length, hkv, d, dtype=dtype)
        gq = 1.0 + 0.1 * self.randn(d, dtype=torch.float32)
        gk = 1.0 + 0.1 * self.randn(d, dtype=torch.float32)
        gq_lib, gk_lib = gq.to(dtype), gk.to(dtype)
        pos = torch.randint(0, 1024, (b, length), generator=self.gen,
                            device=dev)
        cos, sin = cm.rope_angles(pos, d, 1e6)
        qo, ko = krms.qk_norm_rope(q, k, gq, gk, cos, sin, eps=1e-6)
        q_ref, k_ref = krms.qk_norm_rope_ref(q, k, gq, gk, cos, sin, 1e-6)
        q_two = cm.apply_rope(krms.rmsnorm(q, gq, eps=1e-6), cos, sin)
        k_two = cm.apply_rope(krms.rmsnorm(k, gk, eps=1e-6), cos, sin)
        torch.cuda.synchronize()
        # f32: the row's sum in another order.  bf16: a normed element
        # may differ by one step (2^-8 relative, |h| up to ~4) and carry
        # through the rotation, plus the output's own rounding.
        atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (3e-2, 1e-2)
        ok_q, err_q = within(torch, qo, q_ref, atol, rtol)
        ok_k, err_k = within(torch, ko, k_ref, atol, rtol)
        bit_equal = torch.equal(qo, q_two) and torch.equal(ko, k_two)
        if not bit_equal:
            self.bit_bad.append(f"qk_norm_rope {name} {dtype}")
        bound, by = work_bound(krms.qk_norm_rope_work(q, k, gq, gk, cos,
                                                      sin))

        def chain():
            qn = torch.nn.functional.rms_norm(q, (d,), gq_lib, 1e-6)
            kn = torch.nn.functional.rms_norm(k, (d,), gk_lib, 1e-6)
            cm.apply_rope(qn, cos, sin)
            cm.apply_rope(kn, cos, sin)

        def unfused():
            cm.apply_rope(krms.rmsnorm(q, gq, eps=1e-6), cos, sin)
            cm.apply_rope(krms.rmsnorm(k, gk, eps=1e-6), cos, sin)

        rec = dict(entry="qk_norm_rope",
                   shape=f"{name} B={b} L={length} Hq={hq} Hkv={hkv} D={d} "
                         f"{str(dtype)[6:]}", err=max(err_q, err_k),
                   ok=ok_q and ok_k, bit_equal_unfused=bit_equal,
                   tol=f"atol={atol} rtol={rtol}", bound_ms=bound,
                   bound_by=by,
                   library_note="no one PyTorch call; chain_ms: F.rms_norm "
                                "x2, apply_rope x2")
        self.kernel1_times(
            rec, lambda: krms.qk_norm_rope(q, k, gq, gk, cos, sin, eps=1e-6),
            lambda: krms.qk_norm_rope_ref(q, k, gq, gk, cos, sin, 1e-6),
            chain=chain)
        rec["unfused_ms"] = time_ms(torch, unfused, flush=self.flush)
        return self._log("rmsnorm", rec)

    # ------------------------------------------------------- kernels 2, 3
    def _attn_mask(self, b, sq, skv, lens, window, causal=True):
        """The visible-key mask of this data (B, Sq, Skv), for the SDPA
        yardstick; the bound comes from the kernel module's own count
        (``flash_attention.*_work``)."""
        torch, dev = self.torch, self.dev
        kj = torch.arange(skv, device=dev)
        lens_l = lens.long()
        qi = lens_l[:, None] - sq + torch.arange(sq, device=dev)[None]
        mask = (kj[None, None] < lens_l[:, None, None]).expand(b, sq, skv)
        if causal:
            mask = mask & (qi[:, :, None] >= kj[None, None])
        if window is not None:
            mask &= (qi[:, :, None] - kj[None, None]) < window
        return mask

    def attn_case(self, name, b, hq, hkv, sq, skv, d, kv_lens, window,
                  dtype, causal=True):
        from repro_torch.kernels import flash_attention as kfa

        torch = self.torch
        q = self.randn(b, hq, sq, d, dtype=dtype)
        k = self.randn(b, hkv, skv, d, dtype=dtype)
        v = self.randn(b, hkv, skv, d, dtype=dtype)
        lens = torch.tensor(kv_lens, dtype=torch.int32, device=self.dev)
        out = kfa.flash_attention(q, k, v, lens, causal=causal, window=window)
        ref = kfa.attention_ref(q, k, v, lens, causal=causal, window=window)
        torch.cuda.synchronize()
        # f32: exp and sums in another order; bf16: one output rounding.
        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
        ok, err = within(torch, out, ref, atol, rtol)
        mask = self._attn_mask(b, sq, skv, lens, window, causal)
        bound, by = work_bound(kfa.flash_attention_work(
            q, k, v, lens, causal=causal, window=window))
        attn_mask = mask[:, None]
        flush = self.flush
        rec = dict(
            shape=f"{name} B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} "
                  f"D={d} window={window} {str(dtype)[6:]}"
                  + ("" if causal else " non-causal"),
            path=kfa.attention_plan(b, hq, hkv, sq, dtype).path,
            err=err, ok=ok, tol=f"atol={atol} rtol={rtol}",
            ms=time_ms(torch, lambda: kfa.flash_attention(
                q, k, v, lens, causal=causal, window=window), flush=flush),
            plain_ms=time_ms(torch, lambda: kfa.attention_ref(
                q, k, v, lens, causal=causal, window=window), flush=flush),
            library_ms=time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, enable_gqa=True),
                flush=flush),
            bound_ms=bound, bound_by=by)
        return self._log("flash_attention", rec)

    def paged_case(self, name, b, hq, hkv, sq, kv_lens, d, ps, dtype,
                   max_len=1024):
        """Kernel 3 against its plain version, bit for bit against kernel 2
        over the same K/V laid out contiguously, and over two calls."""
        from repro_torch.kernels import flash_attention as kfa

        torch = self.torch
        skv = -(-max_len // ps) * ps
        q = self.randn(b, hq, sq, d, dtype=dtype)
        kc = self.randn(b, hkv, skv, d, dtype=dtype)
        vc = self.randn(b, hkv, skv, d, dtype=dtype)
        lens = torch.tensor(kv_lens, dtype=torch.int32, device=self.dev)
        ks, vs, pt = paged_stores(torch, kc, vc, lens, ps, self.perm)
        call = lambda: kfa.paged_flash_attention(      # noqa: E731
            q, ks, vs, pt, lens, page_size=ps)
        out = call()
        again = call()
        ref = kfa.paged_attention_ref(q, ks, vs, pt, lens, page_size=ps)
        contiguous = kfa.flash_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        # Kernel 2's tolerances: f32 exp and sums in another order than
        # the plain version; bf16 one output rounding.
        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
        ok, err = within(torch, out, ref, atol, rtol)
        same = torch.equal(out, contiguous)
        deterministic = torch.equal(out, again)
        if not (same and deterministic):
            self.bit_bad.append(f"{name} ps={ps} {dtype}")
        mask = self._attn_mask(b, sq, skv, lens, None)
        bound, by = work_bound(kfa.paged_flash_attention_work(
            q, ks, vs, pt, lens, page_size=ps))
        kg = kfa.gather_pages(ks, pt, ps).contiguous()
        vg = kfa.gather_pages(vs, pt, ps).contiguous()
        attn_mask = mask[:, None]
        flush = self.flush
        rec = dict(
            shape=f"{name} B={b} Hq={hq} Hkv={hkv} Sq={sq} kv<={max(kv_lens)} "
                  f"D={d} ps={ps} {str(dtype)[6:]}",
            path=kfa.attention_plan(b, hq, hkv, sq, dtype).path,
            err=err, ok=ok, bit_equal_kernel2=same,
            deterministic=deterministic, tol=f"atol={atol} rtol={rtol}",
            ms=time_ms(torch, call, flush=flush),
            plain_ms=time_ms(torch, lambda: kfa.paged_attention_ref(
                q, ks, vs, pt, lens, page_size=ps), flush=flush),
            library_ms=None,
            library_note="no one PyTorch call computes attention through "
                         "a page table",
            kernel2_ms=time_ms(torch, lambda: kfa.flash_attention(
                q, kc, vc, lens), flush=flush),
            sdpa_gathered_ms=time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kg, vg, attn_mask=attn_mask, enable_gqa=True),
                flush=flush),
            bound_ms=bound, bound_by=by)
        return self._log("paged_flash_attention", rec)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.core import strict
        from repro_torch.core.acc import AdaptiveCoreChunk
        from repro_torch.core.adaptive import adaptive
        from repro_torch.core.calibration import CalibrationCache
        from repro_torch.core.executor import SequentialExecutor
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import rmsnorm as krms
        from repro_torch.models import lm
        from repro_torch.serve import ServeScheduler, percentile
    except ImportError as e:
        fail(f"cannot import the port from {ROOT}/src: {e}")
    if "jax" in sys.modules:
        fail("the port imported jax")

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: unavailable"
    log(card_line)
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} cc={cap} torch={torch.__version__} "
        f"cuda={torch.version.cuda} python={sys.version.split()[0]}")
    if cap < (9, 0):
        fail(f"compute capability {cap} < (9, 0): the kernels target sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ----------------------------------------------------------- 2. build
    # Each phase's start on the host clock ([timing], the wall each took).
    stamps = {"2 build": time.perf_counter()}
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
        f"(nvcc wall {build.build_seconds})")

    # --------------------------------------------------------- 3. kernels
    stamps["3 kernels"] = time.perf_counter()
    bench = KernelBench(torch, dev, seed=0,
                        kernels=("rmsnorm", "flash_attention"))
    records = bench.records
    for dtype in (torch.bfloat16, torch.float32):
        bench.rms_case(8, 1024, dtype)          # decode pre-norms, 8 lanes
        bench.rms_case(8 * 16, 128, dtype)      # decode q-norm: 8 x 16 heads
        bench.rms_case(4096, 1024, dtype)       # a long prefill's pre-norm
        bench.add_case(8, 1024, dtype)          # decode residual + norm
        bench.add_case(4096, 1024, dtype)       # a long prefill's
        bench.qk_case("decode", 8, 1, 16, 8, 128, dtype)
        bench.qk_case("prefill", 1, 256, 16, 8, 128, dtype)

    lens_rng = torch.Generator().manual_seed(1)
    decode_lens = torch.randint(1, 1025, (8,), generator=lens_rng).tolist()
    decode_lens[0], decode_lens[1] = 1, 1024
    for dtype in (torch.bfloat16, torch.float32):
        bench.attn_case("decode", 8, 16, 8, 1, 1024, 128, decode_lens, None,
                        dtype)
        bench.attn_case("prefill", 1, 16, 8, 256, 1024, 128, [700], None,
                        dtype)
        bench.attn_case("window", 1, 16, 8, 256, 1024, 128, [700], 128,
                        dtype)
    bench.check("kernels")
    bench.close()
    sweep_problems = edge_sweep(torch, kfa, dev, seed=10)
    if sweep_problems:
        fail("kernel 2 edge sweep: " + "; ".join(sweep_problems))

    # ----------------------------------------------------------- 4. model
    stamps["4 model"] = time.perf_counter()
    base = get_config("qwen3-0.6b")
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    t0 = time.perf_counter()
    p_cpu = lm.init_params(0, cfg32, device="cpu")
    p_gpu = _to_device(p_cpu, dev)
    prompt = torch.randint(0, base.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(2))
    outs = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        caches = lm.init_caches(cfg32, 1, 64, device=where)
        logits, _ = lm.forward_cached(params, prompt.to(where), caches, 0,
                                      cfg32)
        outs[where] = logits.float().cpu()
    del p_cpu, p_gpu
    err = float((outs["cpu"] - outs["cuda"]).abs().max())
    same_argmax = int(outs["cpu"].argmax()) == int(outs["cuda"].argmax())
    log(f"[model] qwen3-0.6b full width f32, 64-token prompt: max |logit "
        f"cpu - cuda| = {err:.3g} (tol 2e-3), argmax equal: {same_argmax} "
        f"({time.perf_counter() - t0:.1f}s)")
    # Tolerance: f32 on both sides, sums in other orders over 28 layers.
    if not (err <= 2e-3 and same_argmax
            and bool(torch.isfinite(outs["cuda"]).all())):
        fail("full-width logits differ between the card and the CPU")

    # ----------------------------------------------------------- 5. serve
    stamps["5 serve"] = time.perf_counter()
    t0 = time.perf_counter()
    params = lm.init_params(0, base, device=dev)
    cache = CalibrationCache()
    acc = AdaptiveCoreChunk(cache=cache)
    sched = ServeScheduler(base, params, n_slots=8, max_len=1024,
                           executor=adaptive(SequentialExecutor(), acc),
                           dispatch_depth="auto", device=dev)
    sched.warmup()
    torch.cuda.synchronize()
    log(f"[serve] weights + warmup {time.perf_counter() - t0:.1f}s")
    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(64, 513, (16,), generator=rng).tolist()
    prompts = [torch.randint(0, base.vocab_size, (n,), generator=rng)
               for n in lens]
    strict.enable()
    # Peak memory of this run alone: earlier phases' tensors still held
    # by uncollected reference cycles would count otherwise.
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    krms.reset_counts()
    kfa.launches.reset()
    with ForwardSpy(lm, krms) as fspy:
        t_start = time.monotonic()
        rids = [sched.submit(p, max_new_tokens=64) for p in prompts]
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        makespan = time.monotonic() - t_start
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count}
    entries = {k: c.count for k, c in krms.entry_launches.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    gen_tokens = sum(len(results.get(r, [])) for r in rids)
    ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
             for r in rids]
    depths = decisions(sched.decision_model(), "serve_dispatch_depth")
    log(f"[serve] {len(rids)} requests, prompts {min(lens)}-{max(lens)}, "
        f"{gen_tokens} tokens in {makespan:.3f}s = "
        f"{gen_tokens / makespan:.1f} tok/s; decode {sched.decode_tokens} "
        f"tokens in {sched.decode_dispatches} dispatches; ttft p50="
        f"{percentile(ttfts, 50) * 1e3:.1f}ms p99="
        f"{percentile(ttfts, 99) * 1e3:.1f}ms; peak memory {peak_mb:.0f} "
        f"MiB; launches {launches}")
    log(f"[serve] serve_dispatch_depth decisions (value x count "
        f"(provenance)): {depths}")
    k1_line, problems = fspy.report(8, base)
    log(f"[serve] {k1_line}; kernel 1 launches by entry {entries}")
    for r, n in zip(rids, lens, strict=True):
        out = results.get(r)
        if out is None or len(out) != 64:
            problems.append(f"request {r} (prompt {n}) returned "
                            f"{None if out is None else len(out)} tokens")
        elif not all(0 <= t < base.vocab_size for t in out):
            problems.append(f"request {r} returned a token out of the vocab")
    for name, count in launches.items():
        if count <= 0:
            problems.append(f"the serve path launched no {name} kernel")
    caches = lm.init_caches(base, 1, 1024, device=dev)
    logits, _ = lm.forward_cached(params, prompts[0].to(dev)[None], caches,
                                  0, base)
    if not bool(torch.isfinite(logits).all()):
        problems.append("serve-width logits are not finite")
    if problems:
        fail("; ".join(problems))

    # Device busy share of a short serve window, from a profiler trace
    # (sum of kernel times over wall time); outside the counted run.
    for p in prompts[:8]:
        sched.submit(p[:128], max_new_tokens=16)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    iters_before = sched.decode_loop_iters
    with torch.profiler.profile(activities=activities) as prof:
        t_win = time.perf_counter()
        sched.run_until_idle()
        torch.cuda.synchronize()
        t_win = time.perf_counter() - t_win
    win_iters = sched.decode_loop_iters - iters_before
    # Kernel events only: the CPU ops that launched them carry the same
    # device time again.
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels_run)
    attn_us = sum(e.self_device_time_total for e in kernels_run
                  if "repro_fa::" in e.key)
    top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)[:6]
    win_tokens = 8 * 16
    log(f"[serve] profiled window (8 requests, 128-token prompts, 16 new "
        f"tokens): wall {t_win * 1e3:.1f}ms, device busy "
        f"{busy_us / 1e3:.1f}ms = "
        + (f"{busy_us / 1e6 / t_win:.3f} of the wall, idle share "
           f"{1 - busy_us / 1e6 / t_win:.3f}, host overhead per token "
           f"(wall - device busy) / {win_tokens} = "
           f"{(t_win - busy_us / 1e6) / win_tokens * 1e3:.2f}ms"
           if busy_us > 0 else "not measured (no device time in the trace)")
        + f"; attention kernels (repro_fa::*) {attn_us / 1e3:.1f}ms"
        + f"; CUDA kernels {sum(e.count for e in kernels_run)} over "
          f"{win_iters} decode-loop iterations = "
          f"{sum(e.count for e in kernels_run) / max(win_iters, 1):.1f} per "
          f"iteration (prefill included)"
        + "; top kernels (ms): "
        + ", ".join(f"{e.key[:40]}={e.self_device_time_total / 1e3:.1f}"
                    for e in top))
    census = decode_census(torch, dev, base, params)
    log(f"[serve] decode-loop census (one fused dispatch, 8 lanes, 16 "
        f"steps, profiled): {json.dumps(census)}")
    if census["kernel1_launches_per_iteration"] != 3 * base.n_layers + 1:
        fail(f"kernel 1 launched {census['kernel1_launches_per_iteration']}"
             f" times per decode-loop iteration, not {3 * base.n_layers + 1}")
    graphs = sched.graphs
    log(f"[graph] phase 5: captures {dict(graphs.captures)}, replays "
        f"{graphs.replays}, reserved attention scratch "
        f"{graphs.scratch_bytes} B, graph pool {graphs.pool_bytes()} B; "
        f"decode census (one 16-step dispatch over 8 lanes): host launch "
        f"calls {census['host_launch_calls_per_iteration']:.2f}, device "
        f"kernels {census['cuda_kernels_per_iteration']:.2f}, device time "
        f"{census['device_us_per_iteration']:.1f} us (busy "
        f"{census['device_busy_us_per_iteration']:.1f} us), synced wall "
        f"{census['synced_wall_us_per_iteration']:.1f} us per iteration "
        f"(median of 5: {[round(w, 1) for w in census['walls_us']]}) = "
        f"{census['wall_over_device']:.3f} x the device time")
    if not graphs.replays or "fused" not in graphs.captures:
        fail(f"phase 5 did not decode through the graphs: captures "
             f"{dict(graphs.captures)}, replays {graphs.replays}")
    if census["host_launch_calls_per_iteration"] > 5:
        fail(f"{census['host_launch_calls_per_iteration']} host launch calls "
             f"per decode-loop iteration (at most 5: one graph replay)")
    problems = graph_identity(torch, dev, base, params)
    if problems:
        fail("graphs vs their eager body: " + "; ".join(problems))

    del sched, params, caches, logits
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 6. algorithms
    stamps["6 algorithms"] = time.perf_counter()
    algo_records, algo_launches = _algorithms_phase(torch, dev)
    records.update(algo_records)
    launches.update(algo_launches)

    # ----------------------------------------------------------- 7. paged
    stamps["7 paged"] = time.perf_counter()
    paged_records, paged_launches = _paged_phase(torch, dev, base)
    records.update(paged_records)
    launches.update(paged_launches)

    # ----------------------------------------------------------- 8. train
    stamps["8 train"] = time.perf_counter()
    train_records, train_launches = _train_phase(torch, dev, base, card_line)
    records.update(train_records)
    launches.update(train_launches)

    # ---------------------------------------------------- 9. dense family
    stamps["9 dense"] = time.perf_counter()
    dense_records, path_launches = _dense_phase(torch, dev)
    for name, recs in dense_records.items():
        records[name].extend(recs)
    # -------------------------------------------- 10. mixture-of-experts
    stamps["10 moe"] = time.perf_counter()
    moe_records, moe_launches = _moe_phase(torch, dev)
    for name, recs in moe_records.items():
        records[name].extend(recs)
    path_launches.update(moe_launches)
    # ------------------------------------------------ 11. hybrid Mamba2
    stamps["11 hybrid"] = time.perf_counter()
    hybrid_records, hybrid_launches = _hybrid_phase(torch, dev)
    for name, recs in hybrid_records.items():
        records[name].extend(recs)
    path_launches.update(hybrid_launches)
    # ---------------------------------------------------------- 12. xLSTM
    # -------------------------------------------------------- 13. vision
    # ----------------------------------------------------------- 14. tune
    # ---------------------------------------------------------- 15. mesh
    # ------------------------------------------------- 16. FSDP × TP step
    # ----------------------------- 17. TP blocks, sequence-split decode
    # ------------------------------- 18. attention rules, SP, ff2d experts
    for n, phase in enumerate((_xlstm_phase, _vision_phase, _tune_phase,
                               _mesh_phase, _fsdp_phase, _tp_phase,
                               _levers_phase), start=12):
        stamps[f"{n} {phase.__name__[1:].removesuffix('_phase')}"] = \
            time.perf_counter()
        phase_records, phase_launches = phase(torch, dev)
        for name, recs in phase_records.items():
            records.setdefault(name, []).extend(recs)
        path_launches.update(phase_launches)
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    log("[timing] " + json.dumps({
        a: round(stamps[b] - stamps[a], 1)
        for a, b in zip(names, names[1:])}))
    # Kernel 2 with its statistics runs on the sequence-split decode only.
    launches["flash_attention_lse"] = sum(
        counts.get("flash_attention_lse", 0)
        for counts in path_launches.values())

    path_launches = {"phase 5 qwen3-0.6b contiguous": {
        k: launches[k] for k in ("rmsnorm", "flash_attention")},
        "phase 7 qwen3-0.6b paged": {
            "paged_flash_attention": launches["paged_flash_attention"]},
        **path_launches}

    srcs = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:19"),
            "flash_attention": (
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:93"),
            "flash_attention_lse": (
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:93"),
            "paged_flash_attention": (
                "src/repro_torch/kernels/csrc/paged_attention.cu",
                "src/repro/kernels/flash_attention.py:204"),
            "reduce_sum": ("src/repro_torch/kernels/csrc/reduce_scan.cu",
                           "src/repro/kernels/reduce_scan.py:24"),
            "inclusive_scan": (
                "src/repro_torch/kernels/csrc/reduce_scan.cu",
                "src/repro/kernels/reduce_scan.py:57"),
            "adjacent_difference": (
                "src/repro_torch/kernels/csrc/adjacent_difference.cu",
                "src/repro/kernels/adjacent_difference.py:31"),
            "artificial_work": (
                "src/repro_torch/kernels/csrc/artificial_work.cu",
                "src/repro/kernels/artificial_work.py:22"),
            "rmsnorm_backward": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                                 "src/repro/kernels/ops.py:161")}
    kernels = []
    for name, recs in records.items():
        # Serve kernels: the decode shape in bf16, the serve path's own.
        # 1-d kernels: n = 2^24 in f32, the paper's largest size.
        head = recs[0] if name in ("rmsnorm", "flash_attention",
                                   "flash_attention_lse",
                                   "paged_flash_attention",
                                   "rmsnorm_backward") else next(
            r for r in recs if r["shape"] == f"n={KERNEL_SIZES_1D[1]} float32")
        # Each serve path's own launches (counters reset before it).
        by_path = {path: counts[name] for path, counts
                   in path_launches.items() if counts.get(name)}
        kernels.append({
            "name": name, "route": "cuda", "source": srcs[name][0],
            "replaces": srcs[name][1], "launches": launches[name],
            "max_abs_err": head["err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"]}
            | ({"library_note": head["library_note"]}
               if "library_note" in head else {})
            | ({"launches_by_path": by_path} if by_path else {}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def decisions(model, kind: str) -> str:
    """An ExecutionModel's decisions of ``kind`` as "value x count
    (provenance)"."""
    seen: dict = {}
    for e in model.trace.entries(kind):
        k = (e.decision.chunk if kind != "serve_admission"
             else e.decision.cores, e.decision.provenance)
        seen[k] = seen.get(k, 0) + 1
    return ", ".join(f"{v}x{n}({p})" for (v, p), n in seen.items()) \
        or "none"


def graph_identity(torch, dev, cfg, params) -> list:
    """The decode graphs against their eager body on the card, over the
    same kernels: one fused dispatch over the contiguous and over the
    paged pool, one speculative dispatch at every verify width over the
    contiguous pool (and at 4 over the paged), each twice in a row (the
    first captures, the second only replays), from the same random K/V,
    recurrent states, tokens, positions and mixed budgets (one lane with
    none).  Tokens, the history, the stats, every K/V row and every state
    row must be bit-identical — except the paged stores' scratch page 0,
    which no table maps: every spent lane writes its garbage there,
    several to one row, and which write lands last is not defined.  An
    arch with a recurrent layer runs the fused cases only (speculation
    refuses it).  Returns the problems; prints one ``[graph] identity``
    line per case."""
    from repro_torch.models import lm
    from repro_torch.serve import SPEC_DEPTH_CANDIDATES
    from repro_torch.serve.decode_loop import (make_fused_decode_step,
                                               make_paged_decode_step,
                                               make_paged_spec_decode_step,
                                               make_spec_decode_step)
    from repro_torch.serve.graphs import DecodeGraphs

    n, cap, ps = 8, 1024, 16
    gen = torch.Generator().manual_seed(21)
    toks = torch.randint(0, cfg.vocab_size, (n,), generator=gen).to(dev)
    poss = torch.randint(100, 800, (n,), generator=gen).to(dev)
    budgets = [16, 0, 5, 16, 9, 1, 16, 12]
    hist = torch.randint(0, 64, (n, 64), generator=gen)
    hist[:, -1] = toks.cpu()
    hist = hist.to(dev)
    dgen = torch.Generator(device=dev).manual_seed(22)
    contiguous = lm.init_caches(cfg, n, cap, device=dev)
    for c in contiguous:
        for t in c.values():
            t.normal_(generator=dgen)
    n_blk = cap // ps
    rows = (1 + n * n_blk) * ps
    # The paged pool: flat stores for attention, the same state rows.
    paged = [{name: torch.randn(rows, cfg.n_kv_heads, cfg.head_dim_,
                                dtype=c["k"].dtype, device=dev,
                                generator=dgen) for name in ("k", "v")}
             if "k" in c else {k: t.clone() for k, t in c.items()}
             for c in contiguous]
    table = (1 + torch.randperm(n * n_blk, generator=gen)).view(
        n, n_blk).to(torch.int32).to(dev)
    widths = [w for w in SPEC_DEPTH_CANDIDATES if w >= 2]
    cases = [("fused", None, False), ("fused", None, True)]
    if set(cfg.layer_kinds()) <= {"attn", "shared_attn"}:
        cases += [("spec", d, False) for d in widths] + [("spec", 4, True)]
    problems = []
    for kind, d, is_paged in cases:
        runs = []
        for capture in (True, False):
            graphs = DecodeGraphs(capture=capture)
            caches = [{k: t.clone() for k, t in c.items()}
                      for c in (paged if is_paged else contiguous)]
            pt = (table,) if is_paged else ()
            if kind == "fused":
                step = make_paged_decode_step(cfg, page_size=ps,
                                              graphs=graphs) \
                    if is_paged else make_fused_decode_step(cfg,
                                                            graphs=graphs)
            else:
                step = make_paged_spec_decode_step(
                    cfg, depth=d, page_size=ps, graphs=graphs) \
                    if is_paged else make_spec_decode_step(
                        cfg, depth=d, graphs=graphs)
            outs = []
            t, p, h = toks, poss, hist
            for _ in range(2):
                if kind == "fused":
                    _, out, t = step(params, caches, *pt, t, p, budgets)
                    outs += [out, t]
                else:
                    _, h, out, t, stats, reads = step(
                        params, caches, *pt, h, t, p, budgets)
                    outs += [out, t, h, stats, torch.tensor(reads)]
                p = p + torch.tensor(budgets, device=dev)
            torch.cuda.synchronize()
            runs.append((outs, caches, dict(graphs.captures),
                         graphs.replays))
        (g_out, g_caches, g_caps, g_reps), (e_out, e_caches, _, e_reps) = runs
        same_out = all(torch.equal(a, b) for a, b in zip(g_out, e_out,
                                                          strict=True))
        skip = ps if is_paged else 0
        same_kv = all(torch.equal(a[k][skip:], b[k][skip:]) for a, b in
                      zip(g_caches, e_caches, strict=True) for k in a
                      if k in ("k", "v"))
        # The state rows of every lane, the spent one's too.
        same_state = all(torch.equal(a[k], b[k]) for a, b in
                         zip(g_caches, e_caches, strict=True) for k in a
                         if k not in ("k", "v"))
        n_states = sum(k not in ("k", "v") for c in g_caches for k in c)
        name = f"{kind}{d or ''} {'paged' if is_paged else 'contiguous'}"
        log(f"[graph] identity {name}: two dispatches, budgets {budgets}, "
            f"captures {g_caps} replays {g_reps} (eager: {e_reps}); tokens"
            f"{' and history' if kind == 'spec' else ''} bit-identical: "
            f"{same_out}, every K/V row"
            f"{' outside the scratch page' if is_paged else ''} "
            f"bit-identical: {same_kv}"
            + (f", every row of {n_states} state tensors bit-identical: "
               f"{same_state}" if n_states else ""))
        if not (same_out and same_kv and same_state):
            problems.append(f"{name}: tokens equal {same_out}, K/V equal "
                            f"{same_kv}, states equal {same_state}")
        if not g_reps or e_reps:
            problems.append(f"{name}: the graph run replayed {g_reps} times"
                            f", the eager run {e_reps}")
        del runs, g_caches, e_caches
    del contiguous, paged
    torch.cuda.empty_cache()
    return problems


class ForwardSpy:
    """Counts kernel 1's launches inside each ``lm.forward_cached`` call,
    keyed by the call's (B, L): a decode-loop iteration is one forward
    over every slot (B = n_slots), a prefill chunk one over one lane.
    Reads only host counters and shapes, so the run neither syncs nor
    launches more.  ``with ForwardSpy(lm, krms) as spy:`` patches the
    module attribute every caller goes through.  A decode step on the
    card is a graph replay, which calls no Python: the spy hears of each
    replay (``graphs.replay_listeners``) with the forward its capture
    held and the kernel-1 launches the capture counted, and skips the
    forward a capture traces (it launches nothing)."""

    def __init__(self, lm, krms):
        from repro_torch.serve import graphs

        self.lm, self.krms, self.graphs = lm, krms, graphs
        self.per_call: dict = {}

    def _note(self, key, n):
        self.per_call.setdefault(key, []).append(n)

    def _replayed(self, cap):
        self._note(cap.forward, cap.tally.get(self.krms.launches, (0,))[0])

    def __enter__(self):
        import torch

        real = self.real = self.lm.forward_cached

        def spy(params, tokens, *args, **kwargs):
            before = self.krms.launches.count
            out = real(params, tokens, *args, **kwargs)
            if not torch.cuda.is_current_stream_capturing():
                self._note((int(tokens.shape[0]), int(tokens.shape[1])),
                           self.krms.launches.count - before)
            return out

        self.lm.forward_cached = spy
        self.graphs.replay_listeners.append(self._replayed)
        return self

    def __exit__(self, *exc):
        self.lm.forward_cached = self.real
        self.graphs.replay_listeners.remove(self._replayed)

    def report(self, n_slots: int, cfg) -> tuple[str, list]:
        """A log line and the problems: every forward must launch kernel
        1 exactly ``kernel1_per_forward(cfg)`` times."""
        want = kernel1_per_forward(cfg)
        loop = [n for (b, _), ns in self.per_call.items() if b == n_slots
                for n in ns]
        per_iter = sum(loop) / max(len(loop), 1)
        seen = {k: sorted(set(v)) for k, v in sorted(self.per_call.items())}
        line = (f"kernel 1 launches per decode-loop iteration {per_iter:.2f} "
                f"over {len(loop)} iterations (want {want}); per forward by "
                f"(B, L): {seen}")
        bad = [f"forward {k} launched kernel 1 {v} times, not {want}"
               for k, v in seen.items() if v != [want]]
        if not loop:
            bad.append("no decode-loop forward ran")
        return line, bad


def kernel1_per_forward(cfg) -> int:
    """Kernel 1's launches in one ``lm.forward_cached``: layer 0's ln1,
    one residual add + norm per layer (the last one's with the final
    norm), and per attention layer (``attn``, or ``shared_attn``: the
    shared block) the add + ln2 inside it and, with qk-norm, a q/k-norm
    + rotary launch; per ``cross_attn`` layer the add + ln2 and
    ``kv_norm``.  (3 if qk-norm else 2) * L + 1 for an attention stack;
    1 + 38 + 6 = 45 for zamba2-1.2b, 1 + 24 = 25 for xlstm-350m,
    1 + 40 + 32 + 2 * 8 = 89 for llama-3.2-vision-11b."""
    kinds = cfg.layer_kinds()
    n_attn = sum(kind in ("attn", "shared_attn") for kind in kinds)
    n_cross = kinds.count("cross_attn")
    return 1 + cfg.n_layers + n_attn * (2 if cfg.qk_norm else 1) \
        + 2 * n_cross


# Host calls that launch device work, as the profiler names them.
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
               "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
               "cudaLaunchCooperativeKernel")


def decode_census(torch, dev, cfg=None, params=None, iters: int = 16):
    """CUDA kernels per decode-loop iteration: one fused dispatch of
    ``iters`` steps over 8 lanes of qwen3-0.6b at full width (bf16,
    random weights, lanes at cache positions 100-800), profiled; the
    device kernel events and the host's launch calls (``LAUNCH_APIS``)
    over ``iters``, and kernel 1's launch counter over ``iters``; the
    device time both as the sum of kernel times and as the union of their
    intervals (busy time: overlapping kernels count once).  Then
    the synced wall of the same dispatch, five times unprofiled, per
    iteration.  The kernels are grouped by the launch audit's
    ``kernel_group``; otherwise it uses only APIs the port has had since
    its first slice, so a parent tree that has the launch audit counts
    the same way."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.serve.decode_loop import make_fused_decode_step

    if cfg is None:
        cfg = get_config("qwen3-0.6b")
        params = lm.init_params(0, cfg, device=dev)
    caches = lm.init_caches(cfg, 8, 1024, device=dev)
    step = make_fused_decode_step(cfg)
    gen = torch.Generator().manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (8,), generator=gen).to(dev)
    poss = torch.randint(100, 800, (8,), generator=gen).to(dev)
    step(params, caches, toks, poss, [2] * 8)        # warm
    torch.cuda.synchronize()
    krms.launches.reset()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        step(params, caches, toks, poss, [iters] * 8)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host_launches = sum(e.count for e in events if e.key in LAUNCH_APIS
                        and e.device_type != torch.autograd.DeviceType.CUDA)
    n_kernels = sum(e.count for e in kernels)
    busy_us = sum(e.self_device_time_total for e in kernels)
    k1 = krms.launches.count
    # Kernels that overlap (kernel 2's merge starts while its splits run)
    # count once in the busy time: the union of their intervals.
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    union_us, reach = 0.0, float("-inf")
    for lo, hi in spans:
        union_us += max(hi - max(lo, reach), 0.0)
        reach = max(reach, hi)
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(_kernel_group(e.key), [0, 0.0])
        g[0] += e.count / iters
        g[1] += e.self_device_time_total / iters
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, caches, toks, poss, [iters] * 8)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6 / iters)
    wall = sorted(walls)[len(walls) // 2]
    return {"positions": poss.tolist(),
            "cuda_kernels_per_iteration": n_kernels / iters,
            "kernel1_launches_per_iteration": k1 / iters,
            "host_launch_calls_per_iteration": host_launches / iters,
            "device_us_per_iteration": busy_us / iters,
            "device_busy_us_per_iteration": union_us / iters,
            "synced_wall_us_per_iteration": wall,
            "wall_over_device": wall / (busy_us / iters) if busy_us else None,
            "walls_us": walls,
            "groups_kernels_us_per_iteration": {
                k: [round(n, 2), round(us, 1)] for k, (n, us) in groups.items()},
            "top": {e.key[:40]: e.count / iters for e in sorted(
                kernels, key=lambda e: -e.count)[:8]},
            "top_us": {e.key[:40]: round(e.self_device_time_total / iters, 1)
                       for e in sorted(kernels, key=lambda e:
                                       -e.self_device_time_total)[:12]}}


def _kernel_group(name: str) -> str:
    """A profiled kernel's group: GEMMs (cuBLAS), kernel 1, the attention
    kernels, NCCL, copies, or the rest (PyTorch's elementwise and
    reduction kernels): the launch audit's grouping
    (``analysis/launch_audit.kernel_group``)."""
    from repro_torch.analysis.launch_audit import kernel_group

    return kernel_group(name)


def census_main(src: str) -> None:
    """``python3 -c "import chip_smoke; chip_smoke.census_main('<tree>/src')"``:
    ``decode_census`` for the port under ``src`` (a parent's tree, to
    compare in one call); prints one ``[census]`` line."""
    import torch

    sys.path.insert(0, os.path.abspath(src))
    dev = torch.device("cuda")
    log(f"[census] {os.path.abspath(src)}: "
        f"{json.dumps(decode_census(torch, dev))}")


def serve_pinned_main(src: str) -> None:
    """``python3 -c "import chip_smoke; chip_smoke.serve_pinned_main('<tree>/src')"``:
    phase 7's paged serve run for the port under ``src`` with every online
    decision pinned (page size 16, speculation depth 2, dispatch depth 8,
    prefill interleave 1, a static one-core chunk plan, so greedy
    admission), to compare two trees in one call without the spread of
    the online decisions.  Prints one ``[pinned]`` line: tok/s, TTFT,
    decode loop iterations, the host time of every eager forward by (B,
    L) (the prefill chunks: a graph replay calls no Python), and the host
    time and synced span of one ``forward_cached`` at L = 128, 16 and 1
    on fresh contiguous caches (median of 20)."""
    import torch

    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.configs import get_config
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.models import lm
    from repro_torch.serve import (ServeScheduler, materialize, percentile,
                                   shared_prefix_trace)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-0.6b")
    params = lm.init_params(0, cfg, device=dev)
    sched = ServeScheduler(cfg, params, n_slots=8, max_len=1024,
                           executor=adaptive(SequentialExecutor(),
                                             StaticCoreChunk(cores=1)),
                           dispatch_depth=8, paged=True, page_size=16,
                           prefill_interleave=1, speculate=2, device=dev)
    sched.warmup()
    torch.cuda.synchronize()
    trace = shared_prefix_trace(16, rate_rps=50.0, prefix_len=64,
                                shared_fraction=1.0, median_suffix=160,
                                suffix_sigma=0.6, max_suffix=448, seed=8)
    mat = materialize(trace, cfg.vocab_size, seed=8)
    host = {}
    inner = lm.forward_cached

    def timed(params, tokens, *a, **kw):
        t = time.perf_counter()
        out = inner(params, tokens, *a, **kw)
        if not torch.cuda.is_current_stream_capturing():
            host.setdefault(f"{tokens.shape[0]}x{tokens.shape[1]}",
                            []).append(time.perf_counter() - t)
        return out

    gc.collect()
    lm.forward_cached = timed
    try:
        t_start = time.monotonic()
        rids = [sched.submit(p, max_new_tokens=64) for _, p in mat]
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        makespan = time.monotonic() - t_start
    finally:
        lm.forward_cached = inner
    n_tok = sum(len(results.get(r, [])) for r in rids)
    ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
             for r in rids]
    if n_tok != 64 * len(rids):
        fail(f"pinned serve run returned {n_tok} tokens")
    caches = lm.init_caches(cfg, 1, 1024, device=dev)
    gen = torch.Generator().manual_seed(14)
    forward = {}
    for length in (128, 16, 1):
        toks = torch.randint(0, cfg.vocab_size, (1, length),
                             generator=gen).to(dev)
        hs, spans = [], []
        for _ in range(25):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lm.forward_cached(params, toks, caches, 0, cfg)
            hs.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t)
        forward[length] = {"host_ms": sorted(hs[5:])[10] * 1e3,
                           "span_ms": sorted(spans[5:])[10] * 1e3}
    log(f"[pinned] {os.path.abspath(src)}: " + json.dumps({
        "tok_s": n_tok / makespan, "makespan_s": makespan,
        "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
        "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
        "decode_loop_iters": sched.decode_loop_iters,
        "decode_dispatches": sched.decode_dispatches,
        "eager_forward_host_ms_by_BxL": {
            k: {"n": len(v), "mean": sum(v) / len(v) * 1e3}
            for k, v in sorted(host.items())},
        "forward_cached": forward}))


# The schedules' edges (attention_plan): query rows around the split path's
# 16 packed rows and the tile path's 64, kv lengths around the 64-key tiles
# and the 128-key (f32) and 256-key (bf16) splits.  (Hq, Hkv): group 2 as
# in qwen3-0.6b, then groups 1 and 4 at a small width, so that the row
# packing changes.
EDGE_SQ = (1, 3, 8, 9, 16, 17, 63, 64, 65, 100, 256)
EDGE_KV = (1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 1023, 1024)
EDGE_HEADS = ((16, 8), (4, 4), (8, 2))
EDGE_WINDOWS = ((17, 128), (64, 40), (100, 128), (256, 40))   # (Sq, window)


def paged_stores(torch, kc, vc, lens, ps, gen):
    """Kernel 3's view of contiguous K/V ``(B, Hkv, Skv, D)``: flat stores
    through a permuted table (from ``gen``); rows past each lane's length
    (its later pages and the tail of its last one) hold finite garbage,
    the scratch page zeros, as the reference's test lays them out.
    Returns (k_store, v_store, table)."""
    b, hkv, skv, d = kc.shape
    nblk = -(-skv // ps)
    n_pages = 1 + b * nblk
    dev = kc.device
    pt = (torch.randperm(n_pages - 1, generator=gen) + 1)[
        :b * nblk].reshape(b, nblk).to(torch.int32).to(dev)
    ks = torch.full((n_pages * ps, hkv, d), 7.5e4, dtype=kc.dtype, device=dev)
    vs = ks.clone()
    ks[:ps] = 0
    vs[:ps] = 0
    pos = torch.arange(nblk * ps, device=dev)
    rows = pt.long()[:, pos // ps] * ps + pos % ps
    valid = (pos[None] < lens.long()[:, None]) & (pos[None] < skv)
    ks[rows[valid]] = kc.permute(0, 2, 1, 3)[valid[:, :skv]]
    vs[rows[valid]] = vc.permute(0, 2, 1, 3)[valid[:, :skv]]
    return ks, vs, pt


def edge_sweep(torch, kfa, dev, seed, page_sizes=(), heads=EDGE_HEADS,
               dims=(128,), sqs=EDGE_SQ, windows=None):
    """Kernels 2 and 3 at the schedules' edges.  For each (Hq, Hkv) of
    ``heads``, head dim of ``dims``, dtype and Sq of ``sqs``, one call
    whose lanes sit at every kv length of EDGE_KV that is at least Sq
    (queries are end-aligned); and kernel 2 with sliding windows
    (``windows``: (Hq, Hkv, D, Sq, window) cases; by default phase 3's
    EDGE_WINDOWS at qwen3-0.6b's heads when no page size is given).
    Kernel 2 is held against its plain version (phase 3's tolerances)
    and two calls must give the same bits.  With ``page_sizes``, kernel 3
    over the same K/V at each page size (no window: it takes none) is
    held against its plain version, bit for bit against kernel 2, and two
    calls must give the same bits.  Logs one record per case, naming the
    path ``attention_plan`` chose, and returns the problems found."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.Generator().manual_seed(seed + 1)
    kernel = "paged_flash_attention" if page_sizes else "flash_attention"
    problems = []
    n_cases = 0
    if windows is None:
        windows = [] if page_sizes else [
            (16, 8, 128, sq, w) for sq, w in EDGE_WINDOWS]
    cases = [(hq, hkv, d, sq, None) for hq, hkv in heads for d in dims
             for sq in sqs] + list(windows)
    for dtype in (torch.bfloat16, torch.float32):
        # f32: exp and sums in another order; bf16: P and the output
        # rounded to bf16.
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        for hq, hkv, d, sq, window in cases:
            lens_l = [kv for kv in EDGE_KV if kv >= sq]
            b, skv = len(lens_l), max(EDGE_KV)
            q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dtype)
            kc = torch.randn(b, hkv, skv, d, generator=gen,
                             device=dev).to(dtype)
            vc = torch.randn(b, hkv, skv, d, generator=gen,
                             device=dev).to(dtype)
            lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
            out = kfa.flash_attention(q, kc, vc, lens, window=window)
            again = kfa.flash_attention(q, kc, vc, lens, window=window)
            ref = kfa.attention_ref(q, kc, vc, lens, window=window)
            ok, err = within(torch, out, ref, tol, tol)
            rec = dict(
                case=f"B={b} Hq={hq} Hkv={hkv} D={d} Sq={sq} kv="
                     f"{lens_l[0]}..{lens_l[-1]} window={window} "
                     f"{str(dtype)[6:]}",
                path=kfa.attention_plan(b, hq, hkv, sq, dtype).path,
                kernel2_err=err, kernel2_ok=ok,
                kernel2_deterministic=torch.equal(out, again))
            for ps in page_sizes if window is None else ():
                ks, vs, pt = paged_stores(torch, kc, vc, lens, ps, perm)
                po = kfa.paged_flash_attention(q, ks, vs, pt, lens,
                                               page_size=ps)
                po2 = kfa.paged_flash_attention(q, ks, vs, pt, lens,
                                                page_size=ps)
                pref = kfa.paged_attention_ref(q, ks, vs, pt, lens,
                                               page_size=ps)
                pok, perr = within(torch, po, pref, tol, tol)
                rec[f"ps{ps}"] = dict(
                    err=perr, ok=pok, bit_equal_kernel2=torch.equal(po, out),
                    deterministic=torch.equal(po, po2))
            torch.cuda.synchronize()
            log(f"[sweep {kernel}] {rec}")
            n_cases += 1
            bad = [k for k in ("kernel2_ok", "kernel2_deterministic")
                   if not rec[k]]
            bad += [f"{key} {k}" for key, sub in rec.items()
                    if key.startswith("ps")
                    for k, v in sub.items() if k != "err" and not v]
            if bad:
                problems.append(f"{rec['case']}: {bad}")
    log(f"[sweep] {n_cases} cases, {len(problems)} with a problem")
    return problems


U32, U16 = 2.0 ** -24, 2.0 ** -8     # unit roundoff of f32 and of bf16


def sum_limit(torch, x, exact, prefix: bool):
    """Largest |out - exact| that a sound f32-accumulated sum of ``x``
    (``prefix`` False: ``exact`` is 0-d) or prefix sum (``prefix`` True),
    rounded once to x's type, may show against the float64 ``exact``,
    element by element:

    * 2·u32·|exact|: the rounding of the result and of its last add;
    * u32·log2(n)·rms(x)·sqrt(m): the roundings of the partial sums on
      the way, for a result of m terms (m = n for the sum, i + 1 at
      element i of the scan).  A partial sum of m terms is about
      rms(x)·sqrt(m), the plan's sums are at most about log2(n) levels
      deep, and roundings of random sign add as a square root, so this
      is a statistical limit; PERF.md gives the readings it is held to;
    * bf16: 2·u16·|exact| for the one rounding of the f32 result to bf16.

    On randn data the limit stays far below one element's size, so a
    result that is 0, or that drops or repeats an element, fails."""
    n = x.numel()
    xd = x.double()
    rms = float(xd.square().mean().sqrt())
    m = (torch.arange(1, n + 1, device=x.device, dtype=torch.float64)
         if prefix else torch.tensor(float(n), device=x.device,
                                     dtype=torch.float64))
    lim = 2 * U32 * exact.abs() + U32 * math.log2(max(n, 2)) * rms * m.sqrt()
    if x.dtype == torch.bfloat16:
        lim = lim + 2 * U16 * exact.abs()
    return lim


def signed_ints(torch, n, gen, dev):
    """n integers in ±[1, 8], as float32: every sum and prefix sum of
    them is exact in f32 at the sizes here (|partial| << 2^24), so a
    sound sum or scan of them equals the exact one bit for bit, and one
    dropped or repeated element shows."""
    mag = torch.randint(1, 9, (n,), generator=gen, device=dev)
    sign = torch.randint(0, 2, (n,), generator=gen, device=dev) * 2 - 1
    return (mag * sign).float()


def sum_sweep(torch, dev, seed):
    """Kernels 4 and 5 at their edges, in f32 and bf16: n around one tile
    and around ``scan_seg_max`` (the scan's largest segment), views
    x[o:] for o = 1-7 (a misaligned head and, for the scan, an output
    whose alignment differs from the input's), several segments, groups
    of 31, 32 and 33 segments, and ``block`` at one tile, three tiles
    (both below the scan's least segment) and above ``scan_seg_max``.  Each case: within ``sum_limit`` of the
    float64 exact sum, within twice that of the plain version, bit-exact
    on ``signed_ints``, and two calls bit-identical.  Then reduce and
    scan run concurrently on two streams and are held bit for bit
    against the sequential calls.  Logs one record per case and returns
    the problems found."""
    from repro_torch.kernels import ops, tuning
    from repro_torch.kernels import reduce_scan as krs

    gen = torch.Generator(device=dev).manual_seed(seed)
    kernels = {"reduce_sum": (krs.reduce_sum, krs.reduce_sum_ref),
               "inclusive_scan": (krs.inclusive_scan, krs.inclusive_scan_ref)}
    problems = []
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.empty((), dtype=dtype).element_size()
        tile, smax = tuning.tile_elems(item), krs.scan_seg_max(item)
        # (n, offset of the view, block; None: the plan's)
        cases = [(n, 0, None) for n in (1, 255, 256, 1023, 1024, 1025)]
        cases += [(n, 0, smax) for n in (smax - 1, smax, smax + 1)]
        # Full segments behind a misaligned head fill all 17 stage tiles.
        cases += [(3 * smax + 5, o, smax) for o in range(1, 8)]
        cases += [(3 * smax + 5, 3, None)]
        # Blocks of one tile and of three: the scan raises both to its
        # least segment; groups of 31, 32 and 33 of those segments.
        seg = krs.scan_plan(2 ** 20, tile, item).seg
        cases += [(5 * seg + 17, 0, tile),                # several segments
                  (31 * seg + 7, 0, tile), (32 * seg, 0, tile),
                  (33 * seg + 1, 0, tile), (32 * seg + 1, 3, tile),
                  (40 * 3 * tile + 5, 0, 3 * tile),
                  (5 * (2 * smax + tile) + 3, 0, 2 * smax + tile),
                  (5 * (2 * smax + tile) + 3, 5, 2 * smax + tile),
                  (2 ** 22, 0, None)]
        for n, o, block in cases:
            base = torch.randn(n + o, generator=gen, device=dev).to(dtype)
            ints = signed_ints(torch, n + o, gen, dev).to(dtype)
            x, xi = base[o:], ints[o:]
            b = block or tuning.plan_1d(n, num_sms=ops.num_sms(x),
                                        bytes_per_elem=item).block
            for name, (kernel, plain) in kernels.items():
                prefix = name == "inclusive_scan"
                out, again = kernel(x, block=b), kernel(x, block=b)
                exact = (torch.cumsum(x.double(), 0) if prefix
                         else x.double().sum())
                exact_i = (torch.cumsum(xi.double(), 0) if prefix
                           else xi.double().sum())
                lim = sum_limit(torch, x, exact, prefix)
                off = (out.double() - exact).abs()
                diff = (out.double() - plain(x).double()).abs()
                rec = dict(
                    case=f"n={n} x[{o}:] block={b} {str(dtype)[6:]}",
                    segments=krs.scan_plan(n, b, item).n_segs if prefix
                    else math.ceil(n / b),
                    err_over_limit=float((off / lim).max()),
                    within_limit=bool((off <= lim).all()),
                    within_plain=bool((diff <= 2 * lim).all()),
                    signed_ints_exact=torch.equal(kernel(xi, block=b),
                                                  exact_i.to(dtype)),
                    deterministic=torch.equal(out, again))
                torch.cuda.synchronize()
                log(f"[sweep {name}] {rec}")
                n_cases += 1
                bad = [k for k, v in rec.items() if v is False]
                if bad:
                    problems.append(f"{name} {rec['case']}: {bad}")
            del base, ints, x, xi
    # Two streams at once: the per-call counters and status words of one
    # call never meet another's.
    x = torch.randn(3 * 2 ** 20 + 7, generator=gen, device=dev)
    y = torch.randn(2 ** 21 + 3, generator=gen,
                    device=dev).to(torch.bfloat16)[1:]
    b_x = tuning.plan_1d(x.numel(), num_sms=ops.num_sms(x)).block
    b_y = tuning.plan_1d(y.numel(), num_sms=ops.num_sms(y),
                         bytes_per_elem=2).block
    want = [krs.inclusive_scan(x, block=b_x), krs.reduce_sum(y, block=b_y),
            krs.reduce_sum(x, block=b_x), krs.inclusive_scan(y, block=b_y)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    torch.cuda.synchronize()
    for _ in range(4):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(streams[0]):
            a = [krs.inclusive_scan(x, block=b_x), krs.reduce_sum(y, block=b_y)]
        with torch.cuda.stream(streams[1]):
            c = [krs.reduce_sum(x, block=b_x), krs.inclusive_scan(y, block=b_y)]
        got.append(a + c)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for gs in got for g, w in zip(gs, want,
                                                                strict=True))
    log(f"[sweep reduce_sum+inclusive_scan] two streams, 4 rounds: "
        f"bit-equal to the sequential calls: {same}")
    if not same:
        problems.append("two streams: results differ from sequential calls")
    log(f"[sweep] {n_cases} cases, {len(problems)} with a problem")
    return problems


def adjdiff_sweep(torch, dev, seed):
    """Kernel 6 at its edges, in f32 and bf16: n around one vector and
    one tile, views x[o:] for o = 1-7 (a misaligned head; the output is
    allocated at the same offset), blocks below a tile and blocks that are
    no whole number of vectors (every chunk then starts off a boundary),
    and the interior chunks of a `par` call (x[c.start - 1:...]).  Each
    case bit-equal to the plain version.  Logs one record per case and
    returns the problems found."""
    from repro_torch.kernels import adjacent_difference as kad
    from repro_torch.kernels import ops, tuning

    gen = torch.Generator(device=dev).manual_seed(seed)
    problems = []
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.empty((), dtype=dtype).element_size()
        tile, vec = tuning.tile_elems(item), 16 // item
        # (n, offset of the view, block; None: the plan's)
        cases = [(n, 0, None) for n in (1, 2, vec - 1, vec, vec + 1,
                                         tile - 1, tile, tile + 1)]
        cases += [(3 * tile + 5, o, None) for o in range(1, 8)]
        cases += [(5 * tile + 3, 0, tile // 2), (5 * tile + 3, 3, 100),
                  (1000, 1, 7), (7 * tile + 9, 5, 3 * tile + 1),
                  (2 ** 20 + 3, 1, None)]
        for n, o, block in cases:
            base = torch.randn(n + o, generator=gen, device=dev).to(dtype)
            x = base[o:]
            b = block or tuning.plan_1d(n, num_sms=ops.num_sms(x),
                                        bytes_per_elem=item).block
            out = kad.adjacent_difference(x, block=b)
            ref = kad.adjacent_difference_ref(x)
            # Interior par chunks: a view one element left of the chunk,
            # the first element of the result dropped.
            chunk = max(b, 1)
            pieces = [kad.adjacent_difference(x[:chunk], block=b)] + [
                kad.adjacent_difference(x[c - 1:c + chunk], block=b)[1:]
                for c in range(chunk, n, chunk)]
            torch.cuda.synchronize()
            rec = dict(case=f"n={n} x[{o}:] block={b} {str(dtype)[6:]}",
                       bit_equal=torch.equal(out, ref),
                       chunks_bit_equal=torch.equal(torch.cat(pieces), ref),
                       out_aligned_like_x=out.data_ptr() % 16
                       == x.data_ptr() % 16)
            log(f"[sweep adjacent_difference] {rec}")
            n_cases += 1
            bad = [k for k, v in rec.items() if v is False]
            if bad:
                problems.append(f"{rec['case']}: {bad}")
            del base, x, out, ref, pieces
    log(f"[sweep] {n_cases} cases, {len(problems)} with a problem")
    return problems


def affine(c):
    """transform's body in phase 6: one function object, so that acc's
    calibration, keyed by it, is made once."""
    return c * 2 + 1


def _algorithms_phase(torch, dev):
    """Phase 6: the four 1-d kernels against their plain versions, then
    the algorithms under three policies with the launch counters read.
    Returns ({kernel: [record, ...]}, {kernel: launches})."""
    from repro_torch import algorithms as alg
    from repro_torch.core import (HostParallelExecutor, StaticCoreChunk,
                                  adaptive, par, seq)
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.kernels import adjacent_difference as kad
    from repro_torch.kernels import artificial_work as kaw
    from repro_torch.kernels import autotune, ops, tuning
    from repro_torch.kernels import reduce_scan as krs

    gen = torch.Generator(device=dev).manual_seed(4)
    scratch = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def flush_clean():
        # Reads 96 MB: evicts L2 like `flush`, but leaves no dirty lines
        # for the timed call to write back.
        scratch.view(torch.float32).sum()

    iters = 256
    cases = {
        "reduce_sum": dict(
            kernel=ops.reduce_sum, plain=krs.reduce_sum_ref,
            library=lambda x: torch.sum(x, dtype=torch.float32),
            bytes=lambda n, item: n * item + item, ops=lambda n: n,
            dtypes=(torch.float32, torch.bfloat16)),
        "inclusive_scan": dict(
            kernel=ops.inclusive_scan, plain=krs.inclusive_scan_ref,
            library=lambda x: torch.cumsum(x, 0, dtype=torch.float32),
            bytes=lambda n, item: 2 * n * item, ops=lambda n: n,
            dtypes=(torch.float32, torch.bfloat16)),
        "adjacent_difference": dict(
            kernel=ops.adjacent_difference, plain=kad.adjacent_difference_ref,
            library=lambda x: torch.diff(x, prepend=x.new_zeros(1)),
            bytes=lambda n, item: 2 * n * item, ops=lambda n: n,
            dtypes=(torch.float32, torch.bfloat16)),
        "artificial_work": dict(
            kernel=lambda x: ops.artificial_work(x, iters=iters),
            plain=lambda x: kaw.artificial_work_ref(x, iters),
            library=None,        # no one PyTorch call computes it
            bytes=lambda n, item: 2 * n * item,
            ops=lambda n: 2 * iters * n, dtypes=(torch.float32,)),
    }

    # Tolerances, with their reasons:
    # - adjacent_difference: the same one subtraction, rounded once: exact.
    # - reduce_sum, inclusive_scan: sum_limit against the float64 exact
    #   sum, for the kernel and for the plain version, so kernel against
    #   plain within twice it; on signed integers, exact bit for bit
    #   (f32, and the bf16 sum: one rounding of an exact f32 sum).
    # - artificial_work: both round each step once (FMA; f64 then f32):
    #   rtol 1e-5, atol 1e-6.
    def check(name, x, out, ref):
        """(ok, max |out - ref|, None or (max |out - exact| / limit,
        the largest limit))."""
        diff = (out.double() - ref.double()).abs()
        err = float(diff.max())
        if name == "adjacent_difference":
            return bool((diff == 0).all()), err, None
        if name == "artificial_work":
            return (bool((diff <= 1e-6 + 1e-5 * ref.double().abs()).all()),
                    err, None)
        prefix = name == "inclusive_scan"
        exact = (torch.cumsum(x.double(), 0) if prefix
                 else x.double().sum())
        lim = sum_limit(torch, x, exact, prefix)
        off = (out.double() - exact).abs()
        ok = bool((off <= lim).all()) and bool((diff <= 2 * lim).all())
        return ok, err, (float((off / lim).max()), float(lim.max()))

    records = {name: [] for name in cases}
    exact_bad = []
    for name, c in cases.items():
        for dtype in c["dtypes"]:
            for n in KERNEL_SIZES_1D:
                x = torch.randn(n, generator=gen, device=dev).to(dtype)
                out = c["kernel"](x)
                ref = c["plain"](x)
                torch.cuda.synchronize()
                ok, err, ratio = check(name, x, out, ref)
                same = None
                if name in ("reduce_sum", "inclusive_scan"):
                    # Five calls, the same bits (the sums' order is fixed).
                    same = all(torch.equal(out, c["kernel"](x))
                               for _ in range(4))
                    ok = ok and same
                del out, ref
                if name in ("reduce_sum", "inclusive_scan"):
                    xi = signed_ints(torch, n, gen, dev).to(dtype)
                    out = c["kernel"](xi)
                    exact = (torch.cumsum(xi.double(), 0)
                             if name == "inclusive_scan"
                             else xi.double().sum())
                    if not torch.equal(out, exact.to(dtype)):
                        exact_bad.append(f"{name} n={n} {dtype}")
                    del xi, out, exact
                item = x.element_size()
                t_bytes = c["bytes"](n, item) / HBM_BYTES_PER_S
                t_ops = c["ops"](n) / PEAK_F32
                heavy = name == "artificial_work" and n >= 2 ** 24
                rec = dict(
                    shape=f"n={n} {str(dtype)[6:]}", err=err, ok=ok,
                    deterministic_5=same,
                    err_over_limit=None if ratio is None else ratio[0],
                    limit=None if ratio is None else ratio[1],
                    ms=time_ms(torch, lambda: c["kernel"](x), flush=flush),
                    plain_ms=time_ms(torch, lambda: c["plain"](x),
                                     iters=3 if heavy else 20, flush=flush),
                    library_ms=None if c["library"] is None else time_ms(
                        torch, lambda: c["library"](x), flush=flush),
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    plan=str(tuning.plan_1d(
                        n, num_sms=ops.num_sms(x), bytes_per_elem=item)))
                if name in ("reduce_sum", "inclusive_scan",
                            "adjacent_difference"):
                    # Yardsticks: the same calls after a flush that leaves
                    # L2 clean, and (scan) a copy of x, the same bytes.
                    rec["ms_clean_l2"] = time_ms(
                        torch, lambda: c["kernel"](x), flush=flush_clean)
                    rec["library_ms_clean_l2"] = time_ms(
                        torch, lambda: c["library"](x), flush=flush_clean)
                if name == "inclusive_scan":
                    y = torch.empty_like(x)
                    rec["copy_ms"] = time_ms(torch, lambda: y.copy_(x),
                                             flush=flush)
                    del y
                records[name].append(rec)
                log(f"[kernel {name}] {rec}")
                del x
    bad = [f"{name} {r['shape']}" for name, rs in records.items()
           for r in rs if not r["ok"]]
    if bad or exact_bad:
        fail(f"1-d kernels disagree with their plain versions or the exact "
             f"sums, or differ between calls: {bad}; on signed integers: "
             f"{exact_bad}")
    sweep_problems = sum_sweep(torch, dev, seed=12)
    if sweep_problems:
        fail("kernels 4 and 5 edge sweep: " + "; ".join(sweep_problems))
    sweep_problems = adjdiff_sweep(torch, dev, seed=14)
    if sweep_problems:
        fail("kernel 6 edge sweep: " + "; ".join(sweep_problems))

    # The measured block plan (kernels/autotune.py) on the card: one
    # search per kernel, then a hit in the store for the same bucket.
    tuner = autotune.KernelTuner(CalibrationCache())
    x = torch.randn(KERNEL_SIZES_1D[1], generator=gen, device=dev)
    for name in ("reduce_sum", "adjacent_difference"):
        c = cases[name]
        for _ in range(2):
            ok, err, _ = check(name, x, getattr(ops, name)(x, tuner=tuner),
                               c["plain"](x))
            if not ok:
                fail(f"{name} with the tuner's block disagrees: {err}")
        r = tuner.reports[-2]
        log(f"[tuner] {name} n={x.numel()}: prior block {r.prior[0]}, "
            f"winner {r.winner[0]}; wall-clock per candidate (ms): "
            + ", ".join(f"{b[0]}={t * 1e3:.3f}" for b, t in r.timings))
    log(f"[tuner] searches {tuner.searches}, store hits "
        f"{tuner.cache_hits}")
    if (tuner.searches, tuner.cache_hits) != (2, 2):
        fail("the kernel tuner searched again for a stored bucket")
    del x

    counters = {"reduce_sum": krs.reduce_launches,
                "inclusive_scan": krs.scan_launches,
                "adjacent_difference": kad.launches,
                "artificial_work": kaw.launches}
    static_ex = HostParallelExecutor(max_workers=8)
    adapt_ex = adaptive(HostParallelExecutor(max_workers=8))
    policies = {"seq": seq,
                "par-static(8,4)": par.on(static_ex).with_(
                    StaticCoreChunk(8, 4)),
                "par-acc": par.on(adapt_ex)}

    def exclusive(x):
        return torch.cat([x.new_zeros(1), x[:-1]])

    algos = {
        "adjacent_difference": (alg.adjacent_difference,
                                kad.adjacent_difference_ref),
        "reduce": (alg.reduce, krs.reduce_sum_ref),
        "inclusive_scan": (alg.inclusive_scan, krs.inclusive_scan_ref),
        "exclusive_scan": (
            lambda p, x: alg.exclusive_scan(p, x, 0.0),
            lambda x: exclusive(krs.inclusive_scan_ref(x))),
        "artificial_work": (lambda p, x: alg.artificial_work(p, x, iters),
                            lambda x: kaw.artificial_work_ref(x, iters)),
        "transform": (lambda p, x: alg.transform(p, x, affine), affine),
    }
    sums = ("reduce", "inclusive_scan", "exclusive_scan")

    def limits(aname, x):
        """(float64 exact result, sum_limit) of a sum algorithm."""
        if aname == "reduce":
            exact = x.double().sum()
            return exact, sum_limit(torch, x, exact, False)
        exact = torch.cumsum(x.double(), 0)
        lim = sum_limit(torch, x, exact, True)
        if aname == "exclusive_scan":
            return exclusive(exact), torch.cat([lim[:1], lim[:-1]])
        return exact, lim

    problems = []
    for c in counters.values():
        c.reset()
    for n in ALGORITHM_SIZES:
        x = torch.randn(n, generator=gen, device=dev)
        xi = signed_ints(torch, n, gen, dev)
        for aname, (fn, plain) in algos.items():
            ref = plain(x)
            if aname in sums:
                exact, lim = limits(aname, x)
                exact_i = limits(aname, xi)[0].float()
            for pname, pol in policies.items():
                walls = []
                calibrations = []
                for _ in range(2):          # the first call calibrates acc
                    calibrations.append(len(adapt_ex.params.cache))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(pol, x)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                diff = (out.double() - ref.double()).abs()
                ok = out.shape == ref.shape and \
                    bool(torch.isfinite(out).all())
                ratio = ""
                if aname in sums:
                    off = (out.double() - exact).abs()
                    ok = ok and bool((off <= lim).all()) and \
                        bool((diff <= 2 * lim).all()) and \
                        torch.equal(fn(pol, xi), exact_i)
                    ratio = f", max |out - exact| / limit " \
                        f"{float((off / lim).max()):.3g}"
                elif aname == "artificial_work":
                    ok = ok and bool((diff <= 1e-6 + 1e-5 *
                                      ref.double().abs()).all())
                else:
                    ok = ok and bool((diff == 0).all())
                decision = ""
                if pname == "par-acc":
                    d = adapt_ex.params.model.trace.entries()[-1].decision
                    again = len(adapt_ex.params.cache) > calibrations[1]
                    decision = (f" acc: key={d.key} t_iter="
                                f"{d.input('t_iter'):.3e}s T0="
                                f"{d.input('t0'):.3e}s cores={d.cores} "
                                f"chunk={d.chunk}; second call calibrated "
                                f"again: {again}")
                    if again:
                        problems.append(f"{aname} n={n}: acc calibrated "
                                        f"again on its second call")
                log(f"[algorithm] {aname} n={n} {pname}: wall "
                    f"{walls[0] * 1e3:.3f} ms (first), {walls[1] * 1e3:.3f}"
                    f" ms (second); max |out - plain| {float(diff.max()):.3g}"
                    f"{ratio} ok={ok}{decision}")
                if not ok:
                    problems.append(f"{aname} n={n} {pname}")
                del out, diff
            del ref
            if aname in sums:
                del exact, lim, exact_i
        del x, xi
    launches = {name: c.count for name, c in counters.items()}
    log(f"[algorithms] kernel launches in this run: {launches}")

    # Device busy share of one adjacent_difference call per policy at
    # n = 2^24, from a profiler trace (kernel events only); outside the
    # counted run.
    x = torch.randn(ALGORITHM_SIZES[0], generator=gen, device=dev)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for pname, pol in policies.items():
        alg.adjacent_difference(pol, x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t_win = time.perf_counter()
            alg.adjacent_difference(pol, x)
            torch.cuda.synchronize()
            t_win = time.perf_counter() - t_win
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        log(f"[algorithms] profiled adjacent_difference n={x.numel()} "
            f"{pname}: wall {t_win * 1e3:.3f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms, "
            + (f"idle share {1 - busy_us / 1e6 / t_win:.3f}" if busy_us > 0
               else "idle share not measured (no device time in the trace)"))
    del x
    static_ex.shutdown()
    adapt_ex.inner.shutdown()
    for name, count in launches.items():
        if count <= 0:
            problems.append(f"the algorithms launched no {name} kernel")
    if problems:
        fail("algorithms phase: " + "; ".join(problems))
    return records, launches


def _paged_phase(torch, dev, base):
    """Phase 7: kernel 3 against its plain version and kernel 2, the
    paged serve path at full width with its launch counters, token
    identity in f32 and the front end.  Returns ({kernel: [record]},
    {kernel: launches in the paged serve run})."""
    import asyncio

    from repro_torch.core.acc import AdaptiveCoreChunk, StaticCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.serve import (SPEC_DEPTH_CANDIDATES, ServeFrontend,
                                   ServeScheduler, SLOModel, materialize,
                                   percentile, poisson_trace,
                                   shared_prefix_trace)

    bench = KernelBench(torch, dev, seed=5, perm_seed=6,
                        kernels=("paged_flash_attention",))
    records = bench.records

    # Paged serving at full width: the main path of this slice.  It runs
    # first, so the kernel checks below follow the page size "auto" picked
    # and every shape kernel 3 ran at here.  What earlier phases leave
    # allocated counts in this run's peak memory.
    gc.collect()
    log(f"[paged] device memory allocated at the phase's start: "
        f"{torch.cuda.memory_allocated() / 2 ** 20:.0f} MiB")
    t0 = time.perf_counter()
    params = lm.init_params(0, base, device=dev)
    cache = CalibrationCache()
    sched = ServeScheduler(base, params, n_slots=8, max_len=1024,
                           executor=adaptive(SequentialExecutor(),
                                             AdaptiveCoreChunk(cache=cache)),
                           dispatch_depth="auto", paged=True,
                           page_size="auto", speculate="auto", device=dev)
    sched.warmup()
    torch.cuda.synchronize()
    main_ps = sched.pool.page_size
    log(f"[paged] weights + warmup {time.perf_counter() - t0:.1f}s, page "
        f"size {main_ps}, {sched.pool.n_pages} pages")
    trace = shared_prefix_trace(16, rate_rps=50.0, prefix_len=64,
                                shared_fraction=1.0, median_suffix=160,
                                suffix_sigma=0.6, max_suffix=448, seed=8)
    mat = materialize(trace, base.vocab_size, seed=8)
    lens = [len(p) for _, p in mat]
    # The shapes of the run: kernel 3's counter keys each launch by (B,
    # Sq, page size, dtype), and a graph replay adds what its capture
    # counted, so the run neither syncs nor launches more to note them.
    gc.collect()                     # as in phase 5
    torch.cuda.reset_peak_memory_stats()
    krms.reset_counts()
    for counter in (kfa.launches, kfa.paged_launches):
        counter.reset()
    replays0 = sched.graphs.replays
    with ForwardSpy(lm, krms) as fspy:
        t_start = time.monotonic()
        rids = [sched.submit(p, max_new_tokens=64) for _, p in mat]
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        makespan = time.monotonic() - t_start
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count,
                "paged_flash_attention": kfa.paged_launches.count}
    shapes = dict(kfa.paged_launches.by_key)
    graphs = sched.graphs
    log(f"[graph] phase 7: captures {dict(graphs.captures)}, replays "
        f"{graphs.replays - replays0} in the counted run "
        f"({graphs.replays} with warmup), reserved attention scratch "
        f"{graphs.scratch_bytes} B, graph pool {graphs.pool_bytes()} B")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    gen_tokens = sum(len(results.get(r, [])) for r in rids)
    ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
             for r in rids]
    stats = sched.pool.prefix_stats()
    model = sched.decision_model()
    log(f"[paged] {len(rids)} requests, prompts {min(lens)}-{max(lens)} "
        f"(shared 64-token prefix), {gen_tokens} tokens in {makespan:.3f}s "
        f"= {gen_tokens / makespan:.1f} tok/s; ttft p50="
        f"{percentile(ttfts, 50) * 1e3:.1f}ms p99="
        f"{percentile(ttfts, 99) * 1e3:.1f}ms; peak memory {peak_mb:.0f} "
        f"MiB; decode {sched.decode_tokens} tokens in "
        f"{sched.decode_dispatches} dispatches, {sched.decode_loop_iters} "
        f"loop iterations, {sched.host_roundtrips} host round trips")
    log(f"[paged] prefix_stats {stats}; pages_in_use "
        f"{sched.pool.pages_in_use()}; prefill stall "
        f"{sched.prefill_stall_s * 1e3:.1f}ms")
    log(f"[paged] decisions (value x count (provenance)): serve_page_size "
        f"{decisions(model, 'serve_page_size')}; serve_prefill_interleave "
        f"{decisions(model, 'serve_prefill_interleave')}; serve_spec_depth "
        f"{decisions(model, 'serve_spec_depth')}; serve_dispatch_depth "
        f"{decisions(model, 'serve_dispatch_depth')}")
    # A dispatch runs all 8 lanes (B = 8), a prefill chunk one (B = 1).
    dispatch_launches = sum(n for (b, _, _, _), n in shapes.items()
                            if b == sched.pool.n_slots)
    per_iter = dispatch_launches / max(sched.decode_loop_iters, 1)
    log(f"[paged] spec_stats {sched.spec_stats()}; launches {launches}; "
        f"paged attention in decode and verify: {dispatch_launches} "
        f"launches over {sched.decode_loop_iters} loop iterations = "
        f"{per_iter:.2f} per iteration, in prefill: "
        f"{launches['paged_flash_attention'] - dispatch_launches}")
    names = {v: str(k)[6:] for k, v in kfa._DTYPES.items()}
    log("[paged] kernel 3 shapes in this run (B, Sq, page size, dtype: "
        "launches): " + ", ".join(
            f"({b}, {sq}, {ps}, {names[dt]}): {n}"
            for (b, sq, ps, dt), n in sorted(shapes.items())))
    k1_line, problems = fspy.report(sched.pool.n_slots, base)
    log(f"[paged] {k1_line}; kernel 1 launches by entry "
        f"{ {k: c.count for k, c in krms.entry_launches.items()} }")
    for r, n in zip(rids, lens, strict=True):
        out = results.get(r)
        if out is None or len(out) != 64:
            problems.append(f"request {r} (prompt {n}) returned "
                            f"{None if out is None else len(out)} tokens")
        elif not all(0 <= t < base.vocab_size for t in out):
            problems.append(f"request {r} returned a token out of the vocab")
    if stats["prefix_hits"] < 1:
        problems.append("no prefix hit on the shared-prefix trace")
    if launches["paged_flash_attention"] <= 0 or launches["rmsnorm"] <= 0:
        problems.append(f"the paged serve path skipped a kernel: {launches}")
    if launches["flash_attention"] != 0:
        problems.append("the paged serve path ran the contiguous kernel")
    if sum(shapes.values()) != launches["paged_flash_attention"]:
        problems.append("kernel 3's launches by shape and its launch count "
                        "disagree")
    if graphs.replays == replays0:
        problems.append("the paged run did not decode through the graphs")
    if sched.pool.allocations != 1:
        problems.append("the page pool reallocated")
    if problems:
        fail("paged serving: " + "; ".join(problems))
    del sched, params
    torch.cuda.empty_cache()

    # Kernel 3 against its plain version and kernel 2: the listed shapes
    # (decode, a verify at every speculation width the scheduler can
    # pick, a prefill chunk) at page sizes 16, 64 and the main path's,
    # then every other shape the main path ran.
    lens_rng = torch.Generator().manual_seed(7)
    decode_lens = torch.randint(1, 1025, (8,), generator=lens_rng).tolist()
    decode_lens[0], decode_lens[1] = 1, 1024
    widths = [w for w in SPEC_DEPTH_CANDIDATES if w >= 2]
    checked = set()
    for dtype in (torch.bfloat16, torch.float32):
        for ps in dict.fromkeys((main_ps, 16, 64)):
            bench.paged_case("decode", 8, 16, 8, 1, decode_lens, 128, ps,
                             dtype)
            for sq in widths:
                bench.paged_case(f"verify{sq}", 8, 16, 8, sq,
                                 [max(n, sq) for n in decode_lens], 128, ps,
                                 dtype)
            bench.paged_case("prefill", 1, 16, 8, 256, [700], 128, ps, dtype)
            checked.update((b, sq, ps, kfa._DTYPES[dtype])
                           for b, sq in [(8, 1), (1, 256)]
                           + [(8, w) for w in widths])
    for b, sq, ps, dt in sorted(set(shapes) - checked):
        dtype = next(k for k, v in kfa._DTYPES.items() if v == dt)
        if b == 1:      # a prefill chunk, end-aligned after 100 keys
            bench.paged_case("main-prefill", 1, 16, 8, sq,
                             [min(sq + 100, 1024)], 128, ps, dtype)
        else:
            bench.paged_case(f"main-Sq{sq}", b, 16, 8, sq,
                             [max(n, sq) for n in decode_lens], 128, ps,
                             dtype)
    bench.check("paged_flash_attention (kernel 3 against its plain "
                "version, kernel 2 over the same K/V, two calls)")
    sweep_problems = edge_sweep(torch, kfa, dev, seed=11,
                                page_sizes=tuple(dict.fromkeys((main_ps, 16))))
    if sweep_problems:
        fail("kernel 3 edge sweep: " + "; ".join(sweep_problems))
    bench.close()
    torch.cuda.empty_cache()

    # Token identity in f32 at full width: contiguous, paged, paged with
    # speculation.  StaticCoreChunk fixes the prefill chunks, so the three
    # runs run the same GEMM shapes except the speculative verify's.
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    p32 = lm.init_params(0, cfg32, device=dev)
    rng = torch.Generator().manual_seed(9)
    lens8 = torch.randint(64, 257, (8,), generator=rng).tolist()
    prompts8 = [torch.randint(0, base.vocab_size, (n,), generator=rng)
                for n in lens8]

    def serve32(**kw):
        s = ServeScheduler(cfg32, p32, n_slots=8, max_len=1024,
                           acc=StaticCoreChunk(cores=2), dispatch_depth=8,
                           device=dev, **kw)
        s.warmup()
        ids = [s.submit(p, max_new_tokens=32) for p in prompts8]
        out = s.run_until_idle()
        toks = [out[i] for i in ids]
        st = s.spec_stats()
        del s
        torch.cuda.empty_cache()
        return toks, st

    # The paged runs use the page size the main path picked; speculation
    # runs at every width the scheduler can pick.
    t0 = time.perf_counter()
    contiguous, _ = serve32()
    paged, _ = serve32(paged=True, page_size=main_ps)
    log(f"[identity] f32, 8 requests x 32 tokens, prompts "
        f"{min(lens8)}-{max(lens8)}: paged (page size {main_ps}) == "
        f"contiguous: {paged == contiguous}")
    if paged != contiguous:
        fail("paged f32 tokens differ from the contiguous pool's")
    for width in widths:
        spec, spec_st = serve32(paged=True, page_size=main_ps,
                                speculate=width)
        log(f"[identity] speculative (d={width}, "
            f"{spec_st['tokens_per_verify']:.2f} tokens/verify) == plain: "
            f"{spec == paged}")
        for i, (a, b) in enumerate(zip(paged, spec, strict=True)):
            if a == b:
                continue
            t = next(j for j in range(len(a)) if a[j] != b[j])
            seq = torch.cat([prompts8[i],
                             torch.tensor(a[:t], dtype=torch.long)])
            caches = lm.init_caches(cfg32, 1, 1024, device=dev)
            logits, _ = lm.forward_cached(p32, seq.to(dev)[None], caches, 0,
                                          cfg32)
            top = torch.topk(logits[0, 0].float(), 2).values.tolist()
            gap = (top[0] - top[1]) / abs(top[0])
            log(f"[identity] d={width} request {i}: speculative tokens "
                f"diverge at {t} ({a[t]} vs {b[t]}); the plain run's top-2 "
                f"logit gap there is {gap:.3e} relative (allowed < 1e-4)")
            if gap >= 1e-4:
                fail(f"speculative tokens (d={width}) diverge from plain "
                     f"decoding away from a near-tie (request {i}, "
                     f"position {t}, gap {gap})")
    log(f"[identity] three ways in {time.perf_counter() - t0:.1f}s")
    del p32
    torch.cuda.empty_cache()

    # The front end over the paged scheduler (page size and dispatch
    # depth "auto"), speculation and adaptive admission.  The streamed
    # and the batch run must go through the same GEMM shapes to agree in
    # bf16, so the two decisions that set those shapes from timings are
    # pinned: every prompt (<= 256 tokens) is prefilled in one chunk, and
    # the speculation width is fixed at 4 (the main run above takes it
    # "auto").
    class WholePrompts(AdaptiveCoreChunk):
        def decide(self, executor, t_iter, count, key=None, evidence=()):
            d = super().decide(executor, t_iter, count, key=key,
                               evidence=evidence)
            return dataclasses.replace(d, chunk_elems=max(d.chunk_elems,
                                                          256))

    params = lm.init_params(0, base, device=dev)
    ptrace = poisson_trace(16, rate_rps=8.0, prompt_lens=(64, 128, 256),
                           new_tokens=32, seed=10,
                           slo=SLOModel(ttft_s=2.0, per_token_s=0.1))
    pmat = materialize(ptrace, base.vocab_size, seed=10)

    def front_sched(acc, speculate):
        s = ServeScheduler(base, params, n_slots=8, max_len=1024,
                           executor=adaptive(SequentialExecutor(), acc),
                           dispatch_depth="auto", paged=True,
                           page_size="auto", speculate=speculate,
                           admission="adaptive", device=dev)
        s.warmup()
        return s

    async def replay(frontend):
        async with frontend:
            t_0 = time.monotonic()

            async def one(tr, prompt):
                delay = tr.arrival_s - (time.monotonic() - t_0)
                if delay > 0:
                    await asyncio.sleep(delay)
                stream = await frontend.submit(
                    prompt, tr.new_tokens, deadline=t_0 + tr.deadline_s,
                    wait=True)
                return [tok async for tok in stream]

            got = await asyncio.gather(*(one(tr, p) for tr, p in pmat))
            return got, time.monotonic() - t_0

    def report(tag, fsched, frontend, span, extra):
        st = frontend.stats()
        spec = fsched.spec_stats()
        model = fsched.decision_model()
        log(f"[{tag}] 16 Poisson requests (8 rps, prompts 64/128/256, 32 "
            f"new tokens) in {span:.3f}s: goodput "
            f"{st['goodput_tokens'] / span:.1f} tok/s in SLO, completed "
            f"{st['completed']} (in SLO {st['completed_in_slo']}), deadline "
            f"misses {st['deadline_misses']}; decisions (value x count "
            f"(provenance)): serve_admission "
            f"{decisions(model, 'serve_admission')}; serve_spec_depth "
            f"{decisions(model, 'serve_spec_depth')}; page size "
            f"{fsched.pool.page_size}; speculation {spec['verifies']} "
            f"verifies, {spec['tokens_per_verify']:.2f} tokens/verify; "
            f"{extra}")

    fsched = front_sched(WholePrompts(cache=CalibrationCache()), 4)
    frontend = ServeFrontend(fsched, enforce_deadlines=False)
    streamed, fe_span = asyncio.run(replay(frontend))
    bsched = front_sched(WholePrompts(cache=CalibrationCache()), 4)
    bids = [bsched.submit(p, max_new_tokens=tr.new_tokens) for tr, p in pmat]
    bout = bsched.run_until_idle()
    batch = [bout[i] for i in bids]
    del bsched
    report("frontend", fsched, frontend, fe_span,
           f"streamed == batch: {streamed == batch}")
    del fsched, frontend
    if streamed != batch:
        fail("the front end's streamed tokens differ from the batch path's")

    # The whole path with nothing pinned: speculation "auto" and the
    # plain AdaptiveCoreChunk behind the front end.  Its GEMM shapes
    # follow timings, so its tokens are held to their budgets and the
    # vocabulary, not to a batch run; the launch counters are reset
    # before and read after it.
    asched = front_sched(AdaptiveCoreChunk(cache=CalibrationCache()), "auto")
    afront = ServeFrontend(asched, enforce_deadlines=False)
    krms.reset_counts()
    for counter in (kfa.launches, kfa.paged_launches):
        counter.reset()
    auto_streams, a_span = asyncio.run(replay(afront))
    torch.cuda.synchronize()
    a_launches = {"rmsnorm": krms.launches.count,
                  "flash_attention": kfa.launches.count,
                  "paged_flash_attention": kfa.paged_launches.count}
    report("frontend auto", asched, afront, a_span,
           f"launches {a_launches}")
    problems = [f"request {i} streamed {len(got)} of {tr.new_tokens} tokens"
                for i, (got, (tr, _)) in enumerate(
                    zip(auto_streams, pmat, strict=True))
                if len(got) != tr.new_tokens]
    if any(not 0 <= t < base.vocab_size for got in auto_streams
           for t in got):
        problems.append("a token out of the vocab")
    if a_launches["paged_flash_attention"] <= 0 \
            or a_launches["rmsnorm"] <= 0 or a_launches["flash_attention"]:
        problems.append(f"the path skipped kernel 3 or RMSNorm, or ran "
                        f"kernel 2: {a_launches}")
    if problems:
        fail("front end, everything auto: " + "; ".join(problems))
    del asched, afront
    del params
    torch.cuda.empty_cache()
    return records, {"paged_flash_attention":
                     launches["paged_flash_attention"]}


def _train_phase(torch, dev, base, card_line):
    """Phase 8: kernel 1's backward against its plain version, full-width
    gradients card vs CPU, bf16 training steps (the main path, counted),
    a fault-tolerant restart against an uninterrupted run, and kernel 2's
    forward-only prefill against the chunked forward.  Returns
    ({"rmsnorm_backward": [record]}, {"rmsnorm_backward": launches in
    the counted training run})."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import strict
    from repro_torch.core.acc import AdaptiveCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import MeshExecutor
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.runtime import FaultTolerantTrainer, SimulatedFailure
    from repro_torch.serve import make_prefill_step
    from repro_torch.train import choose_plan, make_train_step

    # ---- 8a: kernel 1's backward against its plain version -------------
    t_sweep = time.perf_counter()
    records = _bwd_sweep(torch, dev, base)
    _bwd_check(records, time.perf_counter() - t_sweep)
    # The bound of one training step's backward calls (8c): 1 rmsnorm,
    # 2L add_rmsnorm and L q/k at 8 x 512 (bf16), from the records above.
    step_calls = {"rmsnorm": 1, "add_rmsnorm": 2 * base.n_layers,
                  "qk_norm_rope": base.n_layers}
    step_bound = sum(n * next(r["bound_ms"] for r in records
                              if r["entry"] == e and (
                                  r["shape"] == "rows=4096 d=1024 bfloat16"
                                  or r["shape"].startswith("B=8 S=512")
                                  and r["shape"].endswith("bfloat16")))
                     for e, n in step_calls.items())

    # ---- 8b: full-width gradients, card vs CPU (f32) ---------------------
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    p_cpu = lm.init_params(0, cfg32, device="cpu", dtype=torch.float32)
    p_gpu = _to_device(p_cpu, dev)
    batch = make_batch(cfg32, 1, 64, kind="train", seed=9, device="cpu")
    names = ["/".join(map(str, path)) for path, _ in tree.with_paths(p_cpu)]
    grads = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
        b = {k: v.to(where) for k, v in batch.items()}
        loss = lm.loss_fn(tree.unflatten(params, flat), b, cfg32)
        grads[where] = (float(loss.detach()), [
            g.cpu() for g in torch.autograd.grad(loss, flat)])
    del p_cpu, p_gpu
    worst, worst_at = 0.0, None
    for name, gc_, gg in zip(names, grads["cpu"][1], grads["cuda"][1],
                             strict=True):
        rel = float((gg - gc_).norm() / gc_.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_at = rel, name
    loss_err = abs(grads["cpu"][0] - grads["cuda"][0])
    log(f"[train] full-width gradients qwen3-0.6b f32, batch 1 x 64: "
        f"{len(grads['cpu'][1])} leaves, worst |g_cuda - g_cpu| / |g_cpu| "
        f"= {worst:.3g} (leaf {worst_at}; tol 1e-3), loss cpu "
        f"{grads['cpu'][0]:.6f} cuda {grads['cuda'][0]:.6f} "
        f"({time.perf_counter() - t0:.1f}s)")
    # Tolerance: f32 on both sides, sums in other orders over 28 layers
    # and, for the embedding, atomics in the card's index_add_.
    if not (worst <= 1e-3 and loss_err <= 1e-4 * abs(grads["cpu"][0])):
        fail("full-width gradients differ between the card and the CPU")
    del grads

    # ---- 8c: full-width bf16 training steps (the main path) -------------
    b_size, seq, n_steps = 8, 512, 8
    acc = AdaptiveCoreChunk(cache=CalibrationCache())
    plan = choose_plan(base, ShapeConfig("chip", seq, b_size, "train"),
                       adaptive(MeshExecutor(make_host_mesh(dev)), acc))
    log(f"[train] acc plan: data_parallel={plan.data_parallel} "
        f"accum={plan.accum} microbatch={plan.microbatch}; train_plan "
        f"decisions (chunk x count (provenance)): "
        f"{decisions(acc.model, 'train_plan')}")
    opt_cfg = AdamWConfig(lr=1e-3)
    params = lm.init_params(0, base, device=dev, dtype=torch.float32)
    init = tree.map_leaves(torch.clone, params)
    opt = adamw.init_state(params)
    step_fn = make_train_step(base, opt_cfg, accum=plan.accum, remat=True)
    batch = make_batch(base, b_size, seq, kind="train", seed=10, device=dev)
    params, opt, m = step_fn(params, opt, batch)          # warm-up step
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    krms.reset_counts()
    losses, step_ms = [float(m["loss"])], []
    for i in range(n_steps):
        t_s = time.perf_counter()
        with strict.hot_dispatch_guard():
            params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t_s) * 1e3)
        losses.append(float(m["loss"]))
        log(f"[train] step {i + 1}: loss {losses[-1]:.4f} grad norm "
            f"{float(m['grad_norm']):.4f} step {step_ms[-1]:.1f} ms "
            f"({b_size * seq / step_ms[-1] * 1e3:.1f} tok/s)")
    k1 = {"forward": krms.launches.count,
          "backward": krms.bwd_launches.count,
          "forward_by_entry": {k: c.count for k, c in
                               krms.entry_launches.items()},
          "backward_by_entry": {k: c.count for k, c in
                                krms.bwd_entry_launches.items()}}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    med = sorted(step_ms)[len(step_ms) // 2]
    per_mb = n_steps * plan.accum
    log(f"[train] {n_steps} steps of batch {b_size} x {seq} (accum "
        f"{plan.accum}, remat on, bf16 compute, f32 masters, AdamW): step "
        f"ms median {med:.1f} (all {[round(t, 1) for t in step_ms]}), "
        f"tok/s {b_size * seq / med * 1e3:.1f}, peak memory {peak_mb:.0f} "
        f"MiB; kernel 1 launches per step forward "
        f"{k1['forward'] / n_steps:.2f} (remat's recompute included) "
        f"backward {k1['backward'] / n_steps:.2f}; {json.dumps(k1)}; "
        f"{card_line}")
    n_layers = base.n_layers
    problems = []
    if k1["forward"] != per_mb * (3 * n_layers + 1 + 3 * n_layers):
        problems.append(f"kernel 1 forward launched {k1['forward']} times, "
                        f"not {per_mb} x {6 * n_layers + 1}")
    if k1["backward"] != per_mb * (3 * n_layers + 1):
        problems.append(f"kernel 1 backward launched {k1['backward']} "
                        f"times, not {per_mb} x {3 * n_layers + 1}")
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        problems.append(f"the loss of a repeated batch did not fall: "
                        f"{losses}")
    if problems:
        fail("training steps: " + "; ".join(problems))
    launches = k1["backward"]

    # One profiled step: device busy share and where the time goes.
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t_win = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        t_win = time.perf_counter() - t_win
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels_run)
    groups = dict.fromkeys(("gemm", "kernel 1", "optimizer (foreach)",
                            "elementwise", "reduce", "index / gather",
                            "other"), 0.0)
    for e in kernels_run:
        key = e.key.lower()
        if "norm_rows" in key or "norm_bwd_rows" in key \
                or "qk_norm_rope_rows" in key:
            group = "kernel 1"
        elif any(w in key for w in ("gemm", "cutlass", "nvjet", "sm90_",
                                    "sm80_")):
            group = "gemm"
        elif "multi_tensor" in key:
            group = "optimizer (foreach)"
        elif "elementwise" in key:
            group = "elementwise"
        elif "reduce" in key:
            group = "reduce"
        elif any(w in key for w in ("index", "gather", "scatter")):
            group = "index / gather"
        else:
            group = "other"
        groups[group] += e.self_device_time_total
    bwd_run = [e for e in kernels_run if "norm_bwd_rows" in e.key]
    bwd_us = sum(e.self_device_time_total for e in bwd_run)
    bwd_n = sum(e.count for e in bwd_run)
    log(f"[train] kernel 1 backward device time per step: "
        f"{bwd_us / 1e3:.3f} ms over {bwd_n} kernels "
        f"({launches // n_steps} calls a step), bound of the same calls "
        f"{step_bound:.3f} ms (8a's 4096 x 1024 and q/k bf16 records); "
        f"{card_line}" if bwd_run else "[train] kernel 1 backward device "
        "time per step: no backward kernel in the trace (not measured)")
    top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[train] profiled step: wall {t_win * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms"
        + (f", idle share {1 - busy_us / 1e6 / t_win:.3f} of the profiled "
           f"wall, {1 - busy_us / 1e3 / med:.3f} of the unprofiled median "
           f"step ({med:.1f} ms)" if busy_us > 0
           else " (no device time in the trace: not measured)")
        + f"; CUDA kernels {sum(e.count for e in kernels_run)}; by group "
          f"(ms): {json.dumps({k: round(v / 1e3, 3) for k, v in groups.items()})}"
        + "; top kernels (ms): "
        + ", ".join(f"{e.key[:48]}={e.self_device_time_total / 1e3:.2f}"
                    for e in top))
    del params, opt, m, prof
    torch.cuda.empty_cache()
    _wide_steps(torch, dev, card_line)

    # ---- 8d: fault-tolerant restart against an uninterrupted run --------
    # Depth cut to 2 layers at full width: every checkpoint writes the f32
    # parameters and both moments (12 bytes a parameter) to disk.
    ft_cfg = dataclasses.replace(base, n_layers=2)
    ft_init = lm.init_params(0, ft_cfg, device=dev, dtype=torch.float32)
    ft_batch = make_batch(ft_cfg, b_size, seq, kind="train", seed=11,
                          device=dev)
    ft_step = make_train_step(ft_cfg, opt_cfg, accum=plan.accum, remat=True)

    def repeat():
        while True:
            yield ft_batch

    fails = {3}

    def hook(s):
        if s in fails:
            fails.discard(s)
            raise SimulatedFailure(f"injected at step {s}")

    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    runs = {}
    try:
        for name, h in (("uninterrupted", None), ("restart", hook)):
            t_r = time.perf_counter()
            p0 = tree.map_leaves(torch.clone, ft_init)
            trainer = FaultTolerantTrainer(
                ft_step, os.path.join(ckpt_root, name), save_every=2, keep=2,
                failure_hook=h)
            p1, _, lg = trainer.run(p0, adamw.init_state(p0), repeat(),
                                    num_steps=6)
            torch.cuda.synchronize()
            runs[name] = (p1, lg, time.perf_counter() - t_r)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    (pa, la, ta), (pb, lb, tb) = runs["uninterrupted"], runs["restart"]
    max_dp = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(pa), tree.leaves(pb), strict=True))
    dl = abs(la[-1]["loss"] - lb[-1]["loss"])
    log(f"[train] fault tolerance (qwen3-0.6b widths, 2 layers, bf16 "
        f"compute, batch {b_size} x {seq}, checkpoint every 2 steps, a "
        f"failure at step 3): {len(lb)} steps run (6 + 1 repeated), final "
        f"loss {lb[-1]['loss']:.6f} vs uninterrupted {la[-1]['loss']:.6f} "
        f"(|diff| {dl:.3g}, tol 1e-3), max |param diff| {max_dp:.3g} (tol "
        f"1e-4); wall {ta:.1f} s / {tb:.1f} s")
    # The embedding's backward (index_add_) adds by atomics, so the two
    # runs may differ in the last bits of a step's gradient; AdamW keeps
    # such a difference at the size of a rounding of one update (lr 1e-3).
    if fails or len(lb) != 7 or dl > 1e-3 or max_dp > 1e-4:
        fail("the restarted run does not agree with the uninterrupted one")
    del runs, pa, pb, ft_init
    torch.cuda.empty_cache()

    # ---- 8e: kernel 2's forward-only prefill vs the chunked forward ----
    # Each layer's kernel-2 output is held against the plain version on
    # that layer's own q/k/v (phase 3's tolerances: f32 exp and sums in
    # another order; bf16 one rounding of P and of the output), then the
    # logits of the whole forward against the chunked forward.
    sdpa0 = attn_mod.sdpa
    for dtype_name, atol in (("float32", 2e-3), ("bfloat16", None)):
        cfg = dataclasses.replace(base, compute_dtype=dtype_name)
        params = lm.init_params(0, cfg, device=dev)
        toks = make_batch(cfg, 2, 512, kind="prefill", seed=12, device=dev)
        lt, rt = (1e-4, 1e-4) if dtype_name == "float32" else (1e-2, 1e-2)
        layer_errs, layer_bad, v_max = [], [], 0.0

        def held_sdpa(q, k, v, *, impl="chunked", **kw):
            nonlocal v_max
            out = sdpa0(q, k, v, impl=impl, **kw)
            if impl == "flash":
                ref = kfa.attention_ref(q, k, v, causal=kw["causal"],
                                        window=kw["window"])
                ok, err = within(torch, out, ref, lt, rt)
                layer_errs.append(err)
                v_max = max(v_max, float(v.float().abs().max()))
                if not ok:
                    layer_bad.append(len(layer_errs) - 1)
            return out

        kfa.launches.reset()
        attn_mod.sdpa = held_sdpa
        try:
            with torch.no_grad():
                flash = make_prefill_step(cfg, attn_impl="flash")(params,
                                                                  toks)
                n_flash = kfa.launches.count
                chunked = make_prefill_step(cfg, attn_impl="chunked")(
                    params, toks)
        finally:
            attn_mod.sdpa = sdpa0
        torch.cuda.synchronize()
        log(f"[train] kernel 2 per layer in the flash prefill, "
            f"{dtype_name}, q (2, 16, 512, 128): {len(layer_errs)} layers, "
            f"max |out - attention_ref| {max(layer_errs):.3g} (tol "
            f"atol={lt} rtol={rt}), max |v| {v_max:.3g}, layers outside "
            f"{layer_bad}")
        if layer_bad or len(layer_errs) != base.n_layers:
            fail(f"kernel 2 disagrees with its plain version on the "
                 f"prefill's own q/k/v ({dtype_name}, layers {layer_bad})")
        err = float((flash.float() - chunked.float()).abs().max())
        scale = float(chunked.float().abs().max())
        same = bool((flash.argmax(-1) == chunked.argmax(-1)).all())
        # f32: phase 4's tolerance.  bf16: both round every layer's
        # activations to bf16 and kernel 2 rounds P to bf16 before P·V,
        # so the logits carry bf16 noise over 28 layers: held to 5% of the
        # largest logit (each layer's attention is held above).
        lim = atol if atol is not None else 0.05 * scale
        log(f"[train] prefill flash vs chunked, qwen3-0.6b full width "
            f"{dtype_name}, batch 2 x 512: max |logit diff| {err:.3g} (tol "
            f"{lim:.3g}), max |logit| {scale:.3g}, argmax equal {same}, "
            f"kernel 2 launches {n_flash}")
        if not (err <= lim and n_flash == base.n_layers
                and bool(torch.isfinite(flash.float()).all())
                and (same or atol is None)):
            fail(f"kernel 2's prefill disagrees with the chunked forward "
                 f"({dtype_name})")
        del params
    torch.cuda.empty_cache()
    return {"rmsnorm_backward": records}, {"rmsnorm_backward": launches}


def _bwd_sweep(torch, dev, base) -> list:
    """Phase 8a: kernel 1's backward against its plain version at the
    training path's shapes and the wide archs' rows, bf16 and f32; each
    record with its error, two calls' bits, clean-L2 time beside the
    plain version, the library (or the chain a fused entry replaces) and
    the bound, the kernel's plan and its device kernels a call."""
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import common as cm

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(7)
    scratch = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    records = []
    # f32: the same closed form, sums in other orders (dγ over 4096-8192
    # rows).  bf16: dx is rounded once to bf16 (one step, 2^-8 relative,
    # |dx| up to ~8); dγ in γ's type, each output held to the bf16
    # tolerance where its rows or its own type are bf16.
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}

    # The bound counts what the function must move (the kernel module's
    # own count, ``rmsnorm.*_bwd_work``): its inputs read once and dx, dγ
    # written once.  The dγ partial rows are this kernel's choice of
    # grid, not the function's, so they stay out of the bound and are
    # reported beside it (``partials_bytes``), with the plan the kernel
    # took (``plan``: ``rmsnorm.bwd_plan``).

    def plan_of(tokens, d, dtype, **kw):
        """The kernel's plan for the call and its dγ partial rows'
        traffic: one row per block (per segment), written once and read
        once; none when one block takes the whole call.  A tree without
        ``bwd_plan`` (an earlier one, run by ``bwd_main``): not known."""
        if not hasattr(krms, "bwd_plan"):
            return None, None
        plan = krms.bwd_plan(tokens, d, dtype, **kw)
        cols = d * (2 if kw.get("rope") else 1)
        part = 2 * plan["blocks"] * cols * 4 if plan["blocks"] > 1 else 0
        return plan, part

    side = torch.cuda.Stream()

    def kernels_per_call(fn):
        """Device work one call of ``fn`` puts on its stream: the kernel,
        copy and fill nodes of a CUDA graph that captures that call
        alone (after a warm call on the capture's stream, after the
        case's timed spans), read with `cuGraphGetNodes`.  Independent of a
        profiler's trace, which in a long process can come back without
        the kernels' events."""
        import ctypes

        cu = ctypes.CDLL("libcuda.so.1")
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, stream=side):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
            fail("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
        count = 0
        for node in nodes:
            kind = ctypes.c_int(-1)
            cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
            count += kind.value in (0, 1, 2)    # kernel, memcpy, memset
        del graph
        return count

    def check(rec, outs, outs2, refs, dtype, cpu_refs=None):
        """Against the plain version on the card, two calls' bits, and
        (``cpu_refs``: the plain version run on the CPU on the same
        inputs) each f32 gradient within 1e-3 of its norm of the CPU's."""
        def tol_of(out):
            return tol[torch.bfloat16 if torch.bfloat16 in (dtype, out.dtype)
                       else torch.float32]

        errs = [within(torch, o, r, *tol_of(o)) for o, r in
                zip(outs, refs, strict=True)]
        rec["err"] = max(e for _, e in errs)
        rec["ok"] = all(ok for ok, _ in errs)
        rec["tol"] = " / ".join(sorted({f"atol={a} rtol={r}" for a, r in
                                        map(tol_of, outs)}))
        rec["bit_identical_2_calls"] = all(
            torch.equal(a, b) for a, b in zip(outs, outs2, strict=True))
        if cpu_refs is not None and dtype == torch.float32:
            rel = max(float((o.cpu().float() - c.float()).norm()
                            / c.float().norm().clamp_min(1e-30))
                      for o, c in zip(outs, cpu_refs, strict=True))
            rec["cpu_rel_err"] = rel
            rec["ok"] = rec["ok"] and rel <= 1e-3

    def gamma_name(g):
        return "" if g.dtype == torch.float32 else f" γ {str(g.dtype)[6:]}"

    def rms_bwd_case(rows, d, dtype, gdtype=torch.float32):
        t_case = time.perf_counter()
        x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        dy = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        g = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
             ).to(gdtype)
        outs = krms.rmsnorm_bwd(x, g, dy, eps=1e-6)
        outs2 = krms.rmsnorm_bwd(x, g, dy, eps=1e-6)
        refs = krms.rmsnorm_bwd_ref(x, g, dy, 1e-6)
        cpu = krms.rmsnorm_bwd_ref(x.cpu(), g.cpu(), dy.cpu(), 1e-6) \
            if d > 1024 else None
        torch.cuda.synchronize()
        bound, by = work_bound(krms.rmsnorm_bwd_work(x, g, dy))
        plan, part = plan_of(rows, d, dtype)
        rec = dict(entry="rmsnorm", shape=f"rows={rows} d={d} "
                   f"{str(dtype)[6:]}{gamma_name(g)}", bound_ms=bound,
                   bound_by=by,
                   partials_bytes=part, plan=plan)
        check(rec, outs, outs2, refs, dtype, cpu)
        xl = x.detach().clone().requires_grad_()
        gl = g.to(dtype).requires_grad_()
        out = F.rms_norm(xl, (d,), gl, 1e-6)
        rec["ms"] = time_ms(torch, lambda: krms.rmsnorm_bwd(
            x, g, dy, eps=1e-6), flush=flush)
        rec["plain_ms"] = time_ms(torch, lambda: krms.rmsnorm_bwd_ref(
            x, g, dy, 1e-6), flush=flush)
        rec["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            out, (xl, gl), dy, retain_graph=True), flush=flush)
        rec["library_note"] = "torch.autograd.grad through F.rms_norm"
        rec["kernels_per_call"] = kernels_per_call(
            lambda: krms.rmsnorm_bwd(x, g, dy, eps=1e-6))
        rec["case_s"] = time.perf_counter() - t_case
        records.append(rec)
        log(f"[kernel rmsnorm_backward] {rec}")

    def add_bwd_case(rows, d, dtype, gdtype=torch.float32):
        t_case = time.perf_counter()
        s = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        dh = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        ds = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        g = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
             ).to(gdtype)
        outs = krms.add_rmsnorm_bwd(s, g, dh, ds, eps=1e-6)
        outs2 = krms.add_rmsnorm_bwd(s, g, dh, ds, eps=1e-6)
        refs = krms.add_rmsnorm_bwd_ref(s, g, dh, ds, 1e-6)
        cpu = krms.add_rmsnorm_bwd_ref(s.cpu(), g.cpu(), dh.cpu(), ds.cpu(),
                                       1e-6) if d > 1024 else None
        torch.cuda.synchronize()
        bound, by = work_bound(krms.add_rmsnorm_bwd_work(s, g, dh, ds))
        plan, part = plan_of(rows, d, dtype, residual=True)
        rec = dict(entry="add_rmsnorm", shape=f"rows={rows} d={d} "
                   f"{str(dtype)[6:]}{gamma_name(g)}", bound_ms=bound,
                   bound_by=by,
                   partials_bytes=part, plan=plan,
                   library_ms=None,
                   library_note="no one PyTorch call; chain_ms: autograd "
                                "through x + y and F.rms_norm")
        check(rec, outs, outs2, refs, dtype, cpu)
        xl = s.detach().clone().requires_grad_()
        yl = torch.zeros_like(s).requires_grad_()
        gl = g.to(dtype).requires_grad_()
        sl = xl + yl
        hl = F.rms_norm(sl, (d,), gl, 1e-6)
        rec["ms"] = time_ms(torch, lambda: krms.add_rmsnorm_bwd(
            s, g, dh, ds, eps=1e-6), flush=flush)
        rec["plain_ms"] = time_ms(torch, lambda: krms.add_rmsnorm_bwd_ref(
            s, g, dh, ds, 1e-6), flush=flush)
        rec["chain_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            (sl, hl), (xl, yl, gl), (ds, dh), retain_graph=True),
            flush=flush)
        rec["kernels_per_call"] = kernels_per_call(
            lambda: krms.add_rmsnorm_bwd(s, g, dh, ds, eps=1e-6))
        rec["case_s"] = time.perf_counter() - t_case
        records.append(rec)
        log(f"[kernel rmsnorm_backward] {rec}")

    def qk_bwd_case(b, length, hq, hkv, d, dtype, gdtype=torch.float32):
        t_case = time.perf_counter()
        q = torch.randn(b, length, hq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, length, hkv, d, generator=gen,
                        device=dev).to(dtype)
        dq = torch.randn(b, length, hq, d, generator=gen,
                         device=dev).to(dtype)
        dk = torch.randn(b, length, hkv, d, generator=gen,
                         device=dev).to(dtype)
        gq = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
              ).to(gdtype)
        gk = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
              ).to(gdtype)
        pos = torch.arange(length, device=dev).expand(b, length)
        cos, sin = cm.rope_angles(pos, d, base.rope_theta)
        args = (q, k, gq, gk, cos, sin, dq, dk)
        outs = krms.qk_norm_rope_bwd(*args, eps=1e-6)
        outs2 = krms.qk_norm_rope_bwd(*args, eps=1e-6)
        refs = krms.qk_norm_rope_bwd_ref(*args, 1e-6)
        torch.cuda.synchronize()
        bound, by = work_bound(krms.qk_norm_rope_bwd_work(*args))
        plan, part = plan_of(b * length, d, dtype, heads=(hq, hkv),
                             rope=True)
        rec = dict(entry="qk_norm_rope",
                   shape=f"B={b} S={length} Hq={hq} Hkv={hkv} D={d} "
                         f"{str(dtype)[6:]}{gamma_name(gq)}", bound_ms=bound,
                   bound_by=by,
                   partials_bytes=part, plan=plan,
                   library_ms=None,
                   library_note="no one PyTorch call; chain_ms: autograd "
                                "through F.rms_norm and apply_rope, q and k")
        check(rec, outs, outs2, refs, dtype)
        ql = q.detach().clone().requires_grad_()
        kl = k.detach().clone().requires_grad_()
        gql = gq.to(dtype).requires_grad_()
        gkl = gk.to(dtype).requires_grad_()
        qo = cm.apply_rope(F.rms_norm(ql, (d,), gql, 1e-6), cos, sin)
        ko = cm.apply_rope(F.rms_norm(kl, (d,), gkl, 1e-6), cos, sin)
        rec["ms"] = time_ms(torch, lambda: krms.qk_norm_rope_bwd(
            *args, eps=1e-6), flush=flush)
        rec["plain_ms"] = time_ms(torch, lambda: krms.qk_norm_rope_bwd_ref(
            *args, 1e-6), flush=flush)
        rec["chain_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            (qo, ko), (ql, kl, gql, gkl), (dq, dk), retain_graph=True),
            flush=flush)
        rec["kernels_per_call"] = kernels_per_call(
            lambda: krms.qk_norm_rope_bwd(*args, eps=1e-6))
        rec["case_s"] = time.perf_counter() - t_case
        records.append(rec)
        log(f"[kernel rmsnorm_backward] {rec}")

    for dtype in (torch.bfloat16, torch.float32):
        for rows in (4096, 8192):
            rms_bwd_case(rows, 1024, dtype)
            add_bwd_case(rows, 1024, dtype)
        qk_bwd_case(8, 512, 16, 8, 128, dtype)      # B·S 4096
    # The wide archs' rows (8: a decode-size batch; 4096: a training
    # step's B·S): every one held in registers (the generic loop takes
    # only widths past 8192: BWD_GENERIC_WIDTH below).  The rotary entry
    # takes head rows only (its forward's widths), checked above.
    for dtype in (torch.bfloat16, torch.float32):
        for d in WIDE_WIDTHS:
            for rows in (8, 4096):
                rms_bwd_case(rows, d, dtype)
                add_bwd_case(rows, d, dtype)
    # γ in bf16, as a model with bf16 parameters has it (mixtral in phases
    # 16 and 18): the kernel reads γ in its own type and writes dγ in it.
    # The training path's shapes, mixtral's 6144 and the generic loop; one
    # f32 case with a bf16 γ.
    bf16 = torch.bfloat16
    for rows, d in ((4096, 1024), (8, 6144), (4096, 6144),
                    (8, BWD_GENERIC_WIDTH), (4096, BWD_GENERIC_WIDTH)):
        rms_bwd_case(rows, d, bf16, gdtype=bf16)
        add_bwd_case(rows, d, bf16, gdtype=bf16)
    qk_bwd_case(8, 512, 16, 8, 128, bf16, gdtype=bf16)
    rms_bwd_case(4096, 1024, torch.float32, gdtype=bf16)
    # Past 8192 (norm_bwd_rows_generic), γ in f32.
    for dtype in (bf16, torch.float32):
        for rows in (8, 4096):
            rms_bwd_case(rows, BWD_GENERIC_WIDTH, dtype)
            add_bwd_case(rows, BWD_GENERIC_WIDTH, dtype)
    del scratch
    return records


def _bwd_check(records, seconds: float) -> None:
    """Phase 8a's gates: every case within tolerance, bit-identical over
    two calls, and one or two device kernels a call; ``seconds``: the
    sweep's wall time, logged beside them."""
    bad = [r["shape"] for r in records if not r["ok"]]
    nondet = [r["shape"] for r in records if not r["bit_identical_2_calls"]]
    # One C call a call, at most two device kernels (one is the design).
    launches_bad = [(r["entry"], r["shape"], r["kernels_per_call"])
                    for r in records if not 1 <= r["kernels_per_call"] <= 2]
    if bad or nondet or launches_bad:
        fail(f"kernel 1's backward: outside tolerance {bad}; not "
             f"bit-identical over two calls {nondet}; kernels per call "
             f"not 1-2 {launches_bad}")
    added = sum(r["case_s"] for r in records if "γ" in r["shape"]
                or f"d={BWD_GENERIC_WIDTH}" in r["shape"])
    log(f"[train] kernel 1's backward: {len(records)} cases within "
        f"tolerance and bit-identical over two calls, "
        f"{sum('cpu_rel_err' in r for r in records)} f32 wide cases within "
        f"1e-3 of the CPU's (worst "
        f"{max((r['cpu_rel_err'] for r in records if 'cpu_rel_err' in r), default=0):.3g}), "
        f"device kernels per call "
        f"{sorted({r['kernels_per_call'] for r in records})}; the sweep "
        f"{seconds:.1f} s, the cases with γ in bf16 or past 8192 "
        f"{added:.1f} s")


def bwd_main(src: str = "src") -> None:
    """``python3 -c "import chip_smoke; chip_smoke.bwd_main('<tree>/src')"``:
    phase 8a alone (kernel 1's backward sweep and its gates) for the port
    under ``src``: a parent's tree, to compare two trees in one call
    (parent, change, change, parent)."""
    import torch

    if not torch.cuda.is_available():
        fail("bwd_main needs a CUDA card")
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    log(f"[build] {sorted(build.build_all())} from {os.path.abspath(src)}")
    log(_card_line())
    t_sweep = time.perf_counter()
    records = _bwd_sweep(torch, torch.device("cuda"), get_config("qwen3-0.6b"))
    _bwd_check(records, time.perf_counter() - t_sweep)


# Kernel 1's backward at the wide archs' rows (phase 8), and one AdamW step
# of three wide archs cut to whole pattern groups: (arch, layers, batch).
WIDE_WIDTHS = (1536, 2048, 2560, 4096, 5120, 6144)
# A width past the backward's register layouts (8192), for its generic loop.
BWD_GENERIC_WIDTH = 12288
WIDE_STEPS = (("h2o-danube-1.8b", 2, 8), ("zamba2-1.2b", 6, 8),
              ("llama-3.2-vision-11b", 5, 2))


def _wide_steps(torch, dev, card_line) -> None:
    """Phase 8's wide training steps: per ``WIDE_STEPS`` arch, random f32
    master weights drawn on the card (seed 0), bf16 compute, batch x 512
    (the vision arch with its 1601 frontend tokens), remat on, one warm-up
    step and one timed AdamW step; loss, step ms, peak memory and kernel
    1's launches.  Fails the run on a loss that is not finite or a norm
    that did not run its backward on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step

    for name, layers, b_size in WIDE_STEPS:
        cfg = dataclasses.replace(get_config(name), n_layers=layers)
        t0 = time.perf_counter()
        params = lm.init_params(0, cfg, device=dev, dtype=torch.float32,
                                draw_on_device=True)
        opt = adamw.init_state(params)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), accum=1,
                               remat=True)
        batch = make_batch(cfg, b_size, 512, kind="train", seed=20,
                           device=dev)
        params, opt, m = step(params, opt, batch)          # warm-up
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        krms.reset_counts()
        t_s = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_s) * 1e3
        losses = [float(m["loss"])]
        rec = {"arch": name, "layers": layers, "d": cfg.d_model,
               "batch": f"{b_size} x 512"
               + (f" + {cfg.num_frontend_tokens} frontend tokens"
                  if cfg.frontend == "vision" else ""),
               "params": _count_params(params), "loss": losses[0],
               "grad_norm": float(m["grad_norm"]), "step_ms": ms,
               "tok_s": b_size * 512 / ms * 1e3,
               "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
               "kernel1_forward": krms.launches.count,
               "kernel1_backward": krms.bwd_launches.count,
               "setup_s": t_s - t0}
        log(f"[train wide] {json.dumps(rec)}; {card_line}")
        if not (math.isfinite(losses[0]) and math.isfinite(rec["grad_norm"])
                and rec["kernel1_backward"] > 0):
            fail(f"phase 8: the wide training step of {name} failed: {rec}")
        del params, opt, m, step, batch
        torch.cuda.empty_cache()


# Phase 9: the dense family.  granite-34b and qwen1.5-32b keep 2 of their
# layers: at full depth their bf16 weights are 68 and 70 GB, drawn in f32
# on the host (``lm.init_params``), which the run's time limit does not
# hold.  The others run at full width and full depth.
DENSE_ARCHS = ("h2o-danube-1.8b", "musicgen-medium", "granite-34b",
               "qwen1.5-32b")
DENSE_DEPTH = {"granite-34b": 2, "qwen1.5-32b": 2}
DENSE_WIDTHS = (1536, 2560, 5120, 6144)   # kernel 1's rows, one per arch
# Kernels 2 and 3 at the family's heads: (48, 1) granite's MQA, (40, 40)
# qwen1.5's MHA (group 1), (32, 8) danube's group 4; head dims 64
# (musicgen), 80 (danube) and 128.
DENSE_SWEEP_HEADS = ((48, 1), (40, 40), (32, 8))
DENSE_SWEEP_DIMS = (64, 80, 128)
DENSE_SWEEP_SQ = (1, 4, 8, 16, 17, 64, 256)


def _arch_kernel_cases(torch, bench, cfg, max_len, shapes2, shapes3,
                       page_size, lens_rng):
    """Kernels 2 and 3 at one arch's decode shape (8 lanes, lengths
    1..kv) and main-run prefill shapes (``shapes2`` / ``shapes3``: the
    counters' keys of its serve runs), in bf16 and f32; kernel 3 when the
    arch served paged (``page_size``).  Fails the run on a disagreement."""
    name = cfg.name
    windowed = cfg.attn_window is not None
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    skv = min(cfg.attn_window, max_len) if windowed else max_len
    decode_lens = torch.randint(1, skv + 1, (8,), generator=lens_rng).tolist()
    decode_lens[0], decode_lens[1] = 1, skv
    prefill = max(sq for (b, sq, _, _, _) in shapes2 if b == 1)
    for dtype in (torch.bfloat16, torch.float32):
        bench.attn_case(f"{name} decode", 8, hq, hkv, 1, skv, d,
                        decode_lens, None, dtype)
        if windowed:
            # The ring before its wrap (rows are positions) and after it
            # (the ring in position order, then the chunk).
            bench.attn_case(f"{name} prefill", 1, hq, hkv, prefill, skv,
                            d, [skv], cfg.attn_window, dtype)
            bench.attn_case(f"{name} ring", 1, hq, hkv, prefill,
                            skv + prefill, d, [skv + prefill],
                            cfg.attn_window, dtype)
        else:
            bench.attn_case(f"{name} prefill", 1, hq, hkv, prefill, skv,
                            d, [min(prefill + 444, skv)], None, dtype)
        if page_size is not None:
            bench.paged_case(f"{name} decode", 8, hq, hkv, 1,
                             decode_lens, d, page_size, dtype,
                             max_len=skv)
            p3 = max(sq for (b, sq, _, _) in shapes3 if b == 1)
            bench.paged_case(f"{name} prefill", 1, hq, hkv, p3,
                             [min(p3 + 444, skv)], d, page_size, dtype,
                             max_len=skv)
    bench.check(f"{name}'s kernels")


def _cast_weights(tree, dtype):
    """The serving copy of f32 weights: every weight in ``dtype``, the norm
    gains (``g``) and MoE routers kept in f32 -- what ``lm.init_params``
    draws for the compute dtype from the same seed (it draws in f32 and
    casts)."""
    from repro_torch.models import lm

    if isinstance(tree, dict):
        return {k: v if k in lm.KEEP_PARAM_DTYPE else _cast_weights(v, dtype)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_weights(v, dtype) for v in tree]
    return tree.to(dtype)


def _count_params(tree, nbytes: bool = False) -> int:
    """The elements (or with ``nbytes`` the bytes) of a tree's tensors."""
    if isinstance(tree, dict):
        return sum(_count_params(v, nbytes) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count_params(v, nbytes) for v in tree)
    return tree.numel() * (tree.element_size() if nbytes else 1)


def _serve9(torch, dev, cfg, params, prompts, *, max_len, paged=False,
            phase=9):
    """One phase-9 (or ``phase``) serve run: 8 slots, dispatch depth "auto" (decode
    through the graphs), page size "auto" when paged; the launch counters
    reset just before and read just after it, every forward held to its
    kernel-1 count (``ForwardSpy``).  Returns the run's numbers; fails
    the run on any problem."""
    from repro_torch.core.acc import AdaptiveCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.serve import ServeScheduler, percentile

    pool = "paged" if paged else "contiguous"
    sched = ServeScheduler(
        cfg, params, n_slots=8, max_len=max_len,
        executor=adaptive(SequentialExecutor(),
                          AdaptiveCoreChunk(cache=CalibrationCache())),
        dispatch_depth="auto", paged=paged, page_size="auto", device=dev)
    sched.warmup()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    krms.reset_counts()
    for counter in (kfa.launches, kfa.paged_launches):
        counter.reset()
    replays0 = sched.graphs.replays
    with ForwardSpy(lm, krms) as fspy:
        t_start = time.monotonic()
        rids = [sched.submit(p, max_new_tokens=64) for p in prompts]
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        makespan = time.monotonic() - t_start
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count,
                "paged_flash_attention": kfa.paged_launches.count}
    shapes2, shapes3 = dict(kfa.launches.by_key), dict(kfa.paged_launches.by_key)
    ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
             for r in rids]
    n_tok = sum(len(results.get(r, [])) for r in rids)
    run = dict(tok_s=n_tok / makespan, makespan_s=makespan, tokens=n_tok,
               ttft_p50_ms=percentile(ttfts, 50) * 1e3,
               ttft_p99_ms=percentile(ttfts, 99) * 1e3,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               launches=launches,
               page_size=sched.pool.page_size if paged else None,
               replays=sched.graphs.replays - replays0,
               decode_dispatches=sched.decode_dispatches,
               kv_mib=_pool_mib(sched.pool.caches, True),
               state_mib=_pool_mib(sched.pool.caches, False),
               prefill_lengths=sorted({n for (b, n) in fspy.per_call
                                       if b == 1}))
    k1_line, problems = fspy.report(8, cfg)
    log(f"[serve{phase}] {cfg.name} {pool} bf16, {len(rids)} requests, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}: "
        f"{json.dumps(run)}; {k1_line}")
    for r in rids:
        out = results.get(r)
        if out is None or len(out) != 64:
            problems.append(f"request {r} returned "
                            f"{None if out is None else len(out)} tokens")
        elif not all(0 <= t < cfg.vocab_size for t in out):
            problems.append(f"request {r} returned a token out of the vocab")
    used, unused = ("paged_flash_attention", "flash_attention") if paged \
        else ("flash_attention", "paged_flash_attention")
    if any(kind in lm.ATTN_KINDS for kind in cfg.layer_kinds()):
        ran = launches["rmsnorm"] > 0 and launches[used] > 0 \
            and not launches[unused]
    else:                # no layer attends (xlstm): neither kernel runs
        ran = launches["rmsnorm"] > 0 and not launches[used] \
            and not launches[unused]
    if not ran:
        problems.append(f"the {pool} path skipped a kernel or ran the "
                        f"other attention kernel: {launches}")
    if not run["replays"]:
        problems.append("the run did not decode through the graphs")
    if problems:
        fail(f"phase {phase} {cfg.name} {pool} serving: "
             + "; ".join(problems))
    del sched
    torch.cuda.empty_cache()
    return run, shapes2, shapes3


def _pool_mib(caches, kv: bool) -> float:
    """MiB a pool holds in its K/V stores (``kv``) or recurrent states."""
    return sum(t.numel() * t.element_size() for c in caches
               for name, t in c.items() if (name in ("k", "v")) == kv) \
        / 2 ** 20


def _identity9(torch, dev, cfg32, p32, page_size, phase=9):
    """f32 tokens of 8 requests x 32 new tokens, contiguous == paged (at
    the bf16 run's page size), on fixed chunk decisions."""
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.serve import ServeScheduler

    rng = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, cfg32.vocab_size, (int(n),), generator=rng)
               for n in torch.randint(64, 257, (8,), generator=rng)]
    outs = []
    for paged in (False, True):
        s = ServeScheduler(cfg32, p32, n_slots=8, max_len=1024,
                           acc=StaticCoreChunk(cores=2), dispatch_depth=8,
                           paged=paged, page_size=page_size, device=dev)
        s.warmup()
        ids = [s.submit(p, max_new_tokens=32) for p in prompts]
        got = s.run_until_idle()
        outs.append([got[i] for i in ids])
        del s
        torch.cuda.empty_cache()
    same = outs[0] == outs[1]
    log(f"[identity{phase}] {cfg32.name} f32, 8 requests x 32 tokens: "
        f"paged (page size {page_size}) == contiguous: {same}")
    if not same:
        fail(f"phase {phase} {cfg32.name}: paged f32 tokens differ from the "
             f"contiguous pool's")
    return same


def _ring9(torch, dev, cfg32, p_cpu, p32, tol=2e-3, phase=9):
    """A windowed arch in f32: logits of one 64-token prompt, card vs CPU
    (skipped when ``p_cpu`` is None); then a 4600-token prompt prefilled
    on the card in chunks of 256 (cut at the ring's end, 4096), its last
    row against ``lm.forward`` over the whole sequence (kernel 2, window
    4096), and the decode step after it against ``lm.forward`` over one
    more token, within ``tol``.  Returns (card vs CPU error or None,
    chunked-vs-full error after the wrap, decode error)."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import prefill_segments

    window = cfg32.attn_window
    cpu_err, cpu_argmax = None, True
    if p_cpu is not None:
        prompt = torch.randint(0, cfg32.vocab_size, (1, 64),
                               generator=torch.Generator().manual_seed(2))
        outs = []
        for where, params in (("cpu", p_cpu), (dev, p32)):
            caches = lm.init_caches(cfg32, 1, 64, device=where)
            for start, step in prefill_segments(64, 64, window=window):
                logits, _ = lm.forward_cached(
                    params, prompt[:, start:start + step].to(where), caches,
                    start, cfg32)
            outs.append(logits.float().cpu())
        cpu_err = float((outs[0] - outs[1]).abs().max())
        cpu_argmax = int(outs[0].argmax()) == int(outs[1].argmax())
    seq = torch.randint(0, cfg32.vocab_size, (1, 4600),
                        generator=torch.Generator().manual_seed(4)).to(dev)
    caches = lm.init_caches(cfg32, 1, 8192, device=dev)
    for start, step in prefill_segments(4600, 256, window=window):
        last, _ = lm.forward_cached(p32, seq[:, start:start + step], caches,
                                    start, cfg32)
    with torch.no_grad():
        full, _ = lm.forward(p32, {"tokens": seq}, cfg32, attn_impl="flash")
        full_last = full[:, -1].float()
        del full
        nxt = full_last.argmax(-1)
        dec, _ = lm.forward_cached(p32, nxt[:, None], caches,
                                   torch.tensor([4600], device=dev), cfg32)
        full2, _ = lm.forward(p32, {"tokens": torch.cat(
            [seq, nxt[:, None]], 1)}, cfg32, attn_impl="flash")
        full2_last = full2[:, -1].float()
        del full2
    ring_err = float((last[:, 0].float() - full_last).abs().max())
    dec_err = float((dec[:, 0].float() - full2_last).abs().max())
    same = int(last[0, 0].argmax()) == int(nxt[0]) and \
        int(dec[0, 0].argmax()) == int(full2_last[0].argmax())
    cpu_part = "" if cpu_err is None else (
        f"64-token prompt, max |logit cpu - cuda| = {cpu_err:.3g} (tol "
        f"{tol:g}), argmax equal {cpu_argmax}; ")
    log(f"[ring] {cfg32.name} f32: {cpu_part}4600-token prompt in chunks of "
        f"256 through the ring of {caches[0]['k'].shape[2]} rows: last row "
        f"vs lm.forward (kernel 2, window {window}) {ring_err:.3g}, the "
        f"decode step after the wrap {dec_err:.3g} (tol {tol:g}), argmax "
        f"equal {same}")
    torch.cuda.empty_cache()
    if not ((cpu_err is None or cpu_err <= tol) and cpu_argmax
            and ring_err <= tol and dec_err <= tol and same):
        fail(f"phase {phase} {cfg32.name}: the ring or the card disagrees "
             f"(cpu {cpu_err}, ring {ring_err}, decode {dec_err})")
    return cpu_err, ring_err, dec_err


def _dense_phase(torch, dev):
    """Phase 9: the dense family on the card.  Returns ({kernel: [record]},
    {path: {kernel: launches}}): the kernel records of this phase, and the
    launch counters of each serve run, reset just before and read just
    after it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import lm

    bench = KernelBench(torch, dev, seed=30, perm_seed=31,
                        kernels=("rmsnorm", "flash_attention",
                                 "paged_flash_attention"))
    for d in DENSE_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for rows in (8, 2048):      # a decode step's lanes, a prefill
                bench.rms_case(rows, d, dtype)
                bench.add_case(rows, d, dtype)
    bench.check("kernel 1 at the family's widths")
    problems = edge_sweep(
        torch, kfa, dev, seed=12, page_sizes=(16,), heads=DENSE_SWEEP_HEADS,
        dims=DENSE_SWEEP_DIMS, sqs=DENSE_SWEEP_SQ,
        windows=[(32, 8, 80, sq, w) for sq, w in EDGE_WINDOWS])
    if problems:
        fail("phase 9 kernel 2 and 3 sweep: " + "; ".join(problems))

    path_launches = {}
    lens_rng = torch.Generator().manual_seed(1)
    for name in DENSE_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(name)
        if name in DENSE_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=DENSE_DEPTH[name])
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        windowed = cfg.attn_window is not None
        # One f32 draw serves the f32 runs and (cast) the bf16 runs; only
        # the bf16 copy is on the card while it serves.  The ring's check
        # against the CPU needs the host's stream of numbers (the weights
        # lm.init_params(0, cfg) would draw); the others are drawn on the
        # card, which takes seconds less than the host, and held there.
        if windowed:
            p_cpu = lm.init_params(0, cfg32, device="cpu")
        else:
            p_cpu = _to_device(lm.init_params(
                0, cfg32, device=dev, draw_on_device=True), "cpu")
        p16 = _to_device(_cast_weights(p_cpu, torch.bfloat16), dev)
        n_params = _count_params(p16)
        log(f"[arch] {name}: weights drawn in "
            f"{time.perf_counter() - t0:.1f}s")
        ring = None
        if windowed:
            p32 = _to_device(p_cpu, dev)
            ring = _ring9(torch, dev, cfg32, p_cpu, p32)
            del p32
        rng = torch.Generator().manual_seed(3)
        lens = torch.randint(64, 513, (16,), generator=rng).tolist()
        max_len = 1024
        if windowed:
            # 4 of the 16 prompts past the ring (4096 rows), so it wraps.
            lens[::4] = torch.randint(4200, 4601, (4,), generator=rng).tolist()
            max_len = 8192
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
                   for n in lens]
        runs = {}
        runs["contiguous"], shapes2, _ = _serve9(torch, dev, cfg, p16,
                                                 prompts, max_len=max_len)
        page_size = shapes3 = None
        if not windowed:
            runs["paged"], _, shapes3 = _serve9(torch, dev, cfg, p16,
                                                prompts, max_len=max_len,
                                                paged=True)
            page_size = runs["paged"]["page_size"]
            p32 = _to_device(p_cpu, dev)
            _identity9(torch, dev, cfg32, p32, page_size)
            del p32
        del p_cpu
        for pool, run in runs.items():
            path_launches[f"phase 9 {name} {pool}"] = run["launches"]
        _arch_kernel_cases(torch, bench, cfg, max_len, shapes2, shapes3,
                           page_size, lens_rng)
        main = runs["contiguous"]
        log(f"[arch] " + json.dumps({
            "name": name, "layers": cfg.n_layers,
            "depth": "full" if name not in DENSE_DEPTH
            else f"cut to {cfg.n_layers} of {get_config(name).n_layers}",
            "params": n_params, "peak_mib": main["peak_mib"],
            "tok_s": main["tok_s"], "ttft_p50_ms": main["ttft_p50_ms"],
            "ttft_p99_ms": main["ttft_p99_ms"],
            "paged_tok_s": runs["paged"]["tok_s"] if "paged" in runs
            else None,
            "ring_chunked_vs_full_err": None if ring is None else ring[1],
            "ring_decode_err": None if ring is None else ring[2],
            "logits_cpu_vs_card_err": None if ring is None else ring[0],
            "kernel1_per_forward": (3 if cfg.qk_norm else 2)
            * cfg.n_layers + 1,
            "seconds": time.perf_counter() - t0}))
        del p16
        torch.cuda.empty_cache()
    bench.close()
    return bench.records, path_launches


def dense_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.dense_main()"``: the
    build and phase 9 alone (the dense family), for work on that phase."""
    import torch

    if not torch.cuda.is_available():
        fail("phase 9 needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import strict
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[build] {sorted(build.build_all())}")
    strict.enable()
    records, path_launches = _dense_phase(torch, torch.device("cuda"))
    log(f"[phase 9] {sum(map(len, records.values()))} kernel records; "
        f"launches by path {json.dumps(path_launches)}")


# Phase 10: mixture-of-experts.  Both archs keep 2 of their 56 and 64
# layers at full width (d 6144, 48/8 heads, 8 experts, top-2): at full
# depth their weights are 141 G and 316 G, which no card holds; at 2
# layers every shape a kernel or an expert product sees is the model's.
MOE_ARCHS = ("mixtral-8x22b", "grok-1-314b")
MOE_DEPTH = 2
MOE_ROWS = (8, 256)          # a decode step's lanes; a prefill chunk
# Kernels 2 and 3 at the family's heads: group 6, head dim 128; windows
# (mixtral's) on kernel 2.
MOE_SWEEP_HEADS = ((48, 8),)


def _keep_cast(tree, dtype):
    """Casts ``tree``'s weights to ``dtype`` on the card in place, one
    tensor at a time, so that each f32 tensor is freed as its copy is
    made (the norm gains and routers, ``lm.KEEP_PARAM_DTYPE``, stay f32)."""
    from repro_torch.models import lm

    for k in range(len(tree)) if isinstance(tree, list) else list(tree):
        if k in lm.KEEP_PARAM_DTYPE:
            continue
        if isinstance(tree[k], (dict, list)):
            _keep_cast(tree[k], dtype)
        else:
            tree[k] = tree[k].to(dtype)
    return tree


def _moe_layer10(torch, dev, cfg32, p_layer):
    """One full-width MoE layer in f32, card against the same function on
    the CPU (the same weights), at 8 and 256 rows and the config's
    capacity factor: the experts picked, the kept choices and the
    outputs (within 1e-4 of the CPU output's largest magnitude).  The
    rows share a direction, as a layer's hidden states do, so the router
    favours some experts and a chunk drops choices.  Returns the
    records; fails the run on a disagreement."""
    from repro_torch.models import moe

    cpu_p = _to_device(p_layer, "cpu")
    gen = torch.Generator().manual_seed(5)
    d = cfg32.d_model
    shared = torch.randn(d, generator=gen)
    recs = []
    for rows in MOE_ROWS:
        x = torch.randn(1, rows, d, generator=gen) + shared
        got = {}
        for where, params in (("cpu", cpu_p), (dev, p_layer)):
            xs = x.to(where)
            with torch.no_grad():
                gate_w, gate_idx, _ = moe.route(params, xs[0], cfg32)
                cap = moe.capacity(rows, cfg32)
                _, keep = moe.placement(gate_idx, cfg32, cap)
                out, aux = moe.apply(params, xs, cfg32)
            got[where] = (gate_idx.cpu(), keep.cpu(), out.float().cpu(),
                          float(aux))
        (i0, k0, o0, a0), (i1, k1, o1, a1) = got["cpu"], got[dev]
        same_experts = torch.equal(i0, i1)
        same_kept = torch.equal(k0, k1)
        rel = float((o0 - o1).abs().max() / o0.abs().max())
        rec = dict(rows=rows, capacity=cap, choices=int(k0.numel()),
                   dropped=int((~k0).sum()), same_experts=same_experts,
                   same_kept=same_kept, out_rel_err=rel,
                   aux_err=abs(a0 - a1), tol="1e-4 relative")
        log(f"[moe layer] {cfg32.name} f32 layer 0, card vs CPU: "
            f"{json.dumps(rec)}")
        recs.append(rec)
        if not (same_experts and same_kept and rel <= 1e-4):
            fail(f"phase 10 {cfg32.name}: the MoE layer on the card "
                 f"disagrees with the CPU at {rows} rows: {rec}")
    del cpu_p
    return recs


def _moe_times10(torch, cfg, p_layer, bench):
    """Device time of one bf16 MoE layer at a decode step (8 rows) and a
    prefill chunk (256), L2 flushed, beside its bound: the router and the
    expert weights read once, the rows read and written once, and
    2·d·ff·3 operations a place of each expert's buffer."""
    from repro_torch.models import moe

    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    n_mats = 3 if cfg.ffn_gated else 2
    out = {}
    for rows in MOE_ROWS:
        x = bench.randn(rows, 1, d, dtype=torch.bfloat16)
        cap = moe.capacity(rows, cfg)
        byts = e * n_mats * d * ff * 2 + d * e * 4 + 2 * rows * d * 2
        ops = 2 * e * cap * d * ff * n_mats
        bound, by = bench.bound_of(byts, ops, PEAK_BF16)
        with torch.no_grad():
            ms = time_ms(torch, lambda: moe.apply(p_layer, x, cfg),
                         iters=10, flush=bench.flush)
        out[rows] = dict(ms=ms, bound_ms=bound, bound_by=by, capacity=cap,
                         weight_bytes=e * n_mats * d * ff * 2)
        log(f"[moe time] {cfg.name} bf16 MoE layer at {rows} rows "
            f"(capacity {cap}): {json.dumps(out[rows])}")
    return out


def _moe_phase(torch, dev):
    """Phase 10: mixtral-8x22b and grok-1-314b on the card, 2 layers at
    full width.  Returns ({kernel: [record]}, {path: {kernel: launches}}),
    as ``_dense_phase`` does."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import lm

    bench = KernelBench(torch, dev, seed=40, perm_seed=41,
                        kernels=("rmsnorm", "flash_attention",
                                 "paged_flash_attention"))
    problems = edge_sweep(
        torch, kfa, dev, seed=14, page_sizes=(16,), heads=MOE_SWEEP_HEADS,
        dims=(128,), sqs=DENSE_SWEEP_SQ,
        windows=[(48, 8, 128, sq, w) for sq, w in EDGE_WINDOWS])
    if problems:
        fail("phase 10 kernel 2 and 3 sweep: " + "; ".join(problems))

    path_launches = {}
    lens_rng = torch.Generator().manual_seed(6)
    for name in MOE_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), n_layers=MOE_DEPTH)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        windowed = cfg.attn_window is not None
        # One f32 draw on the card (the host's stream of numbers took ~50
        # and ~100 s here; every check of this phase compares the card
        # with the CPU on the same weights, or the card with itself).
        p32 = lm.init_params(0, cfg32, device=dev, draw_on_device=True)
        n_params = _count_params(p32)
        t_draw = time.perf_counter() - t0
        log(f"[arch] {name}: {n_params} weights drawn in f32 in "
            f"{t_draw:.1f}s")
        layer = _moe_layer10(torch, dev, cfg32, p32["layers"][0]["moe"])
        ring = None
        if windowed:
            # Drop-free (capacity factor E/k: every expert holds every
            # token), so the chunked prefill and lm.forward over the
            # whole sequence route alike: a chunk of 256 and 4600 rows
            # drop other choices at the config's 1.25 (ROADMAP.md,
            # faults of the reference).
            free = dataclasses.replace(
                cfg32, capacity_factor=cfg.n_experts / cfg.experts_per_token)
            ring = _ring9(torch, dev, free, None, p32, tol=1e-4, phase=10)
        else:
            _identity9(torch, dev, cfg32, p32, 16, phase=10)
        p16 = _keep_cast(p32, torch.bfloat16)
        del p32
        torch.cuda.empty_cache()
        times = _moe_times10(torch, cfg, p16["layers"][0]["moe"], bench)

        rng = torch.Generator().manual_seed(3)
        lens = torch.randint(64, 513, (16,), generator=rng).tolist()
        max_len = 1024
        if windowed:
            # 4 of the 16 prompts past the ring (4096 rows), so it wraps.
            lens[::4] = torch.randint(4200, 4601, (4,), generator=rng).tolist()
            max_len = 8192
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
                   for n in lens]
        runs = {}
        runs["contiguous"], shapes2, _ = _serve9(
            torch, dev, cfg, p16, prompts, max_len=max_len, phase=10)
        page_size = shapes3 = None
        if not windowed:
            runs["paged"], _, shapes3 = _serve9(
                torch, dev, cfg, p16, prompts, max_len=max_len, paged=True,
                phase=10)
            page_size = runs["paged"]["page_size"]
            graph_problems = graph_identity(torch, dev, cfg, p16)
            if graph_problems:
                fail(f"phase 10 {name}: graphs vs their eager body: "
                     + "; ".join(graph_problems))
        census = decode_census(torch, dev, cfg, p16)
        log(f"[moe census] {name} (one fused dispatch, 8 lanes, 16 steps, "
            f"profiled): {json.dumps(census)}")
        if census["kernel1_launches_per_iteration"] != 2 * cfg.n_layers + 1 \
                or census["host_launch_calls_per_iteration"] > 5:
            fail(f"phase 10 {name}: a decode step launched kernel 1 "
                 f"{census['kernel1_launches_per_iteration']} times (want "
                 f"{2 * cfg.n_layers + 1}) with "
                 f"{census['host_launch_calls_per_iteration']} host launch "
                 f"calls (at most 5: one graph replay)")
        for pool, run in runs.items():
            path_launches[f"phase 10 {name} {pool}"] = run["launches"]
        _arch_kernel_cases(torch, bench, cfg, max_len, shapes2, shapes3,
                           page_size, lens_rng)
        main = runs["contiguous"]
        log("[arch] " + json.dumps({
            "name": name, "layers": cfg.n_layers,
            "depth": f"cut to {cfg.n_layers} of {get_config(name).n_layers}",
            "params": n_params, "draw_s": t_draw,
            "peak_mib": main["peak_mib"], "tok_s": main["tok_s"],
            "ttft_p50_ms": main["ttft_p50_ms"],
            "ttft_p99_ms": main["ttft_p99_ms"],
            "paged_tok_s": runs["paged"]["tok_s"] if "paged" in runs
            else None,
            "paged_ttft_p50_ms": runs["paged"]["ttft_p50_ms"]
            if "paged" in runs else None,
            "moe_layer_dropped": {r["rows"]: r["dropped"] for r in layer},
            "moe_layer_out_rel_err": max(r["out_rel_err"] for r in layer),
            "host_launch_calls_per_step":
                census["host_launch_calls_per_iteration"],
            "decode_device_us_per_step": census["device_us_per_iteration"],
            "moe_decode_ms": times[8]["ms"],
            "moe_decode_bound_ms": times[8]["bound_ms"],
            "moe_prefill256_ms": times[256]["ms"],
            "moe_prefill256_bound_ms": times[256]["bound_ms"],
            "ring_chunked_vs_full_err": None if ring is None else ring[1],
            "ring_decode_err": None if ring is None else ring[2],
            "kernel1_per_forward": 2 * cfg.n_layers + 1,
            "seconds": time.perf_counter() - t0}))
        del p16
        torch.cuda.empty_cache()
    bench.close()
    return bench.records, path_launches


def moe_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.moe_main()"``: the build
    and phase 10 alone (mixture-of-experts), for work on that phase."""
    import torch

    if not torch.cuda.is_available():
        fail("phase 10 needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import strict
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"[build] {sorted(build.build_all())}")
    strict.enable()
    records, path_launches = _moe_phase(torch, torch.device("cuda"))
    log(f"[phase 10] {sum(map(len, records.values()))} kernel records; "
        f"launches by path {json.dumps(path_launches)}; "
        f"{time.perf_counter() - t0:.1f}s")


# Phase 11: the hybrid Mamba2 family.  zamba2-1.2b at full width and
# depth, no cut: 38 layers (32 Mamba2 blocks, 6 uses of one shared
# attention block), 1.04 G weights, 2.08 GB in bf16.
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_ROWS = (8, 2048)      # a decode step's lanes; a long prefill's rows


def _kernel1_twice(torch, bench, d: int) -> list:
    """``rmsnorm`` and ``add_rmsnorm`` at rows of ``d``, bf16 and f32, each
    called twice on the same inputs; returns the cases whose two outputs
    differ in any bit."""
    from repro_torch.kernels import rmsnorm as krms

    problems = []
    for dtype in (torch.bfloat16, torch.float32):
        for rows in HYBRID_ROWS:
            x = bench.randn(rows, d, dtype=dtype)
            y = bench.randn(rows, d, dtype=dtype)
            g = 1.0 + 0.1 * bench.randn(d, dtype=torch.float32)
            outs = [(krms.rmsnorm(x, g, eps=1e-6),
                     *krms.add_rmsnorm(x, y, g, eps=1e-6)) for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(*outs, strict=True))
            log(f"[kernel rmsnorm twice] rows={rows} d={d} "
                f"{str(dtype)[6:]}: rmsnorm and add_rmsnorm bit-identical "
                f"over two calls: {same}")
            if not same:
                problems.append(f"rows={rows} d={d} {dtype}")
    return problems


def _cpu_vs_card(torch, dev, cfg32, p_cpu, p32, tag: str, phase: int,
                 tol=2e-3) -> float:
    """f32 at full width and depth: the logits of one 64-token prompt
    through ``forward_cached`` (a recurrent layer steps once a token) on
    the CPU and on the card, the same weights; within ``tol`` (sums in
    other orders over every layer) with the same argmax.  Returns the
    error; fails the run otherwise."""
    from repro_torch.models import lm

    prompt = torch.randint(0, cfg32.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(2))
    outs = []
    for where, params in (("cpu", p_cpu), (dev, p32)):
        caches = lm.init_caches(cfg32, 1, 64, device=where)
        logits, _ = lm.forward_cached(params, prompt.to(where), caches, 0,
                                      cfg32)
        outs.append(logits.float().cpu())
    err = float((outs[0] - outs[1]).abs().max())
    same = int(outs[0].argmax()) == int(outs[1].argmax())
    log(f"[{tag}] {cfg32.name} full width and depth f32, 64-token prompt "
        f"through forward_cached: max |logit cpu - cuda| = {err:.3g} (tol "
        f"{tol:g}), argmax equal {same}")
    if not (err <= tol and same and bool(torch.isfinite(outs[1]).all())):
        fail(f"phase {phase} {cfg32.name}: logits differ between the card "
             f"and the CPU ({err})")
    return err


def _hybrid_chunked(torch, dev, cfg32, p32, tol=2e-3, phase=11):
    """f32 on the card: one 300-token prompt served by the scheduler (one
    slot, two new tokens), its prefill chunks replayed through
    ``lm.forward_cached`` into fresh caches (one recurrent step per token
    in each Mamba2 layer), the last prompt row and the decode step after
    it against ``lm.forward`` over the sequence (the chunk-parallel
    ``chunked_gla``; kernel 2 for the shared attention), within ``tol``;
    the scheduler's two tokens must be ``lm.forward``'s argmax unless the
    top two logits lie within 2 * tol (a near-tie).  Returns (chunked
    error, decode error, chunk sizes, tokens equal)."""
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.models import lm
    from repro_torch.serve import ServeScheduler

    n = 300
    prompt = torch.randint(0, cfg32.vocab_size, (n,),
                           generator=torch.Generator().manual_seed(4))
    sched = ServeScheduler(cfg32, p32, n_slots=1, max_len=512,
                           acc=StaticCoreChunk(cores=1, chunks_per_core=3),
                           dispatch_depth=2, device=dev)
    rid = sched.submit(prompt, max_new_tokens=2)
    served = sched.run_until_idle()[rid]
    steps = [step for t in sched.trace for _, step in t.prefill_ops]
    del sched
    seq = prompt.to(dev)[None]
    caches = lm.init_caches(cfg32, 1, 512, device=dev)
    start = 0
    for step in steps:
        last, _ = lm.forward_cached(p32, seq[:, start:start + step], caches,
                                    start, cfg32)
        start += step
    with torch.no_grad():
        full, _ = lm.forward(p32, {"tokens": seq}, cfg32, attn_impl="flash")
        full_last = full[:, -1].float()
        del full
        nxt = full_last.argmax(-1)
        dec, _ = lm.forward_cached(p32, nxt[:, None], caches,
                                   torch.tensor([n], device=dev), cfg32)
        full2, _ = lm.forward(p32, {"tokens": torch.cat(
            [seq, nxt[:, None]], 1)}, cfg32, attn_impl="flash")
        full2_last = full2[:, -1].float()
        del full2
    chunk_err = float((last[:, 0].float() - full_last).abs().max())
    dec_err = float((dec[:, 0].float() - full2_last).abs().max())
    want = [int(nxt[0]), int(full2_last[0].argmax())]
    gaps = [float(v[0, 0] - v[0, 1]) for v in (
        full_last.topk(2).values, full2_last.topk(2).values)]
    same = all(a == b or gap < 2 * tol
               for a, b, gap in zip(served, want, gaps, strict=True))
    log(f"[{'hybrid' if phase == 11 else 'xlstm'} chunked] {cfg32.name} "
        f"f32: a {n}-token prompt in the "
        f"scheduler's chunks {steps}: last row vs lm.forward (chunked_gla; "
        f"kernel 2 where a layer attends) {chunk_err:.3g}, the decode step "
        f"after it {dec_err:.3g} "
        f"(tol {tol:g}); served tokens {served}, lm.forward's argmax {want} "
        f"(top-2 gaps {[round(g, 4) for g in gaps]}): equal {same}")
    torch.cuda.empty_cache()
    if not (chunk_err <= tol and dec_err <= tol and same):
        fail(f"phase {phase} {cfg32.name}: the per-token prefill disagrees with "
             f"the chunk-parallel forward (chunked {chunk_err}, decode "
             f"{dec_err}, tokens {served} vs {want})")
    return chunk_err, dec_err, steps, same


def _serve_window(torch, dev, cfg, params) -> dict:
    """A profiled serve window (2 requests, 32-token prompts, 8 new
    tokens, 8 slots, depth "auto"; device activity only, since the
    per-token prefill launches ~22 k kernels here and the profiler's
    post-processing grows with its events): wall, the device's busy
    time (the union of kernel intervals) and idle share, and the
    kernels' count and device time by group (``_kernel_group``)."""
    from repro_torch.core.acc import AdaptiveCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.serve import ServeScheduler

    sched = ServeScheduler(
        cfg, params, n_slots=8, max_len=1024,
        executor=adaptive(SequentialExecutor(),
                          AdaptiveCoreChunk(cache=CalibrationCache())),
        dispatch_depth="auto", device=dev)
    sched.warmup()
    gen = torch.Generator().manual_seed(8)
    for _ in range(2):
        sched.submit(torch.randint(0, cfg.vocab_size, (32,), generator=gen),
                     max_new_tokens=8)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t_win = time.perf_counter()
        sched.run_until_idle()
        torch.cuda.synchronize()
        t_win = time.perf_counter() - t_win
    del sched
    torch.cuda.empty_cache()
    return _device_profile(torch, prof, t_win)


def _device_profile(torch, prof, wall_s: float) -> dict:
    """A device-only profile over a synced wall of ``wall_s``: the wall,
    the device's busy time (the union of kernel intervals) and idle
    share, and the kernels' count and device time by group
    (``_kernel_group``)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(hi - max(lo, reach), 0.0)
        reach = max(reach, hi)
    groups: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = groups.setdefault(_kernel_group(e.key), [0, 0.0])
            g[0] += e.count
            g[1] += e.self_device_time_total / 1e3
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e6 / wall_s if busy_us else None,
            "kernels": len(spans),
            "groups_kernels_ms": {k: [n, round(ms, 3)]
                                  for k, (n, ms) in groups.items()}}


def _decode_bound_ms(cfg, params, positions, iters) -> float:
    """The least time one decode step of ``decode_census`` could take
    (bf16 weights, 8 lanes at ``positions``, ``iters`` steps): every
    weight read once (the embedding table's 8 rows only), each lane's
    recurrent state read and written once, each shared-attention layer's
    K/V read up to the lane's position (the dispatch's mean) and one row
    written, the logits written; over the card's memory rate."""
    from repro_torch.models import lm

    import torch

    lanes = len(positions)
    weights = _count_params(params, True) \
        - _count_params(params["embed"], True) \
        + lanes * cfg.d_model * 2
    kinds = cfg.layer_kinds()
    n_attn = sum(kind in lm.ATTN_KINDS for kind in kinds)
    # One lane's recurrent state (mamba2: ssm f32 and the conv carry in
    # bf16; mlstm: mem f32; slstm: c, n, m f32), from its own shapes.
    meta = torch.device("meta")
    state = sum(t.numel() * t.element_size() for kind in kinds
                if kind not in lm.ATTN_KINDS
                for t in lm.init_state(kind, cfg, 1, torch.bfloat16,
                                       meta).values())
    row = 2 * cfg.n_kv_heads * cfg.head_dim_ * 2          # K and V, bf16
    kv = n_attn * row * sum(p + 1 + (iters - 1) / 2 for p in positions)
    logits = lanes * cfg.vocab_size * 2
    return (weights + 2 * lanes * state + kv + logits) / HBM_BYTES_PER_S * 1e3


# The recurrent archs' served prompts (phases 11-12): 32-128 tokens
# (64-512 before phase 18 came, 64-256 before the mesh serving checks of
# phases 13, 15 and 18 came); they prefill token by token, and the cuts
# pay for those phases.
RECURRENT_PROMPTS = (32, 129)


def _hybrid_phase(torch, dev):
    """Phase 11: zamba2-1.2b on the card at full width and depth.  Returns
    ({kernel: [record]}, {path: {kernel: launches}}), as ``_dense_phase``
    does."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    bench = KernelBench(torch, dev, seed=50, perm_seed=51,
                        kernels=("rmsnorm", "flash_attention",
                                 "paged_flash_attention"))
    for dtype in (torch.bfloat16, torch.float32):
        for rows in HYBRID_ROWS:
            bench.rms_case(rows, cfg.d_model, dtype)
            bench.add_case(rows, cfg.d_model, dtype)
    bench.check("kernel 1 at zamba2's width")
    twice = _kernel1_twice(torch, bench, cfg.d_model)
    if twice:
        fail("phase 11: kernel 1 is not deterministic at d 2048: "
             + "; ".join(twice))

    # One f32 draw on the host serves the CPU and the f32 runs; cast on
    # the card, in place, it is the bf16 serving copy.
    t0 = time.perf_counter()
    p_cpu = lm.init_params(0, cfg32, device="cpu")
    p32 = _to_device(p_cpu, dev)
    n_params = _count_params(p32)
    t_draw = time.perf_counter() - t0
    log(f"[arch] {HYBRID_ARCH}: {n_params} weights drawn in f32 in "
        f"{t_draw:.1f}s")
    cpu_err = _cpu_vs_card(torch, dev, cfg32, p_cpu, p32, "hybrid", 11)
    del p_cpu
    chunk_err, dec_err, steps, _ = _hybrid_chunked(torch, dev, cfg32, p32)
    _identity9(torch, dev, cfg32, p32, 16, phase=11)
    p16 = _keep_cast(p32, torch.bfloat16)
    del p32
    torch.cuda.empty_cache()

    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(*RECURRENT_PROMPTS, (16,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
               for n in lens]
    runs = {}
    runs["contiguous"], shapes2, _ = _serve9(
        torch, dev, cfg, p16, prompts, max_len=1024, phase=11)
    runs["paged"], _, shapes3 = _serve9(
        torch, dev, cfg, p16, prompts, max_len=1024, paged=True, phase=11)
    graph_problems = graph_identity(torch, dev, cfg, p16)
    if graph_problems:
        fail(f"phase 11 {HYBRID_ARCH}: graphs vs their eager body: "
             + "; ".join(graph_problems))
    window = _serve_window(torch, dev, cfg, p16)
    log(f"[hybrid window] {HYBRID_ARCH} bf16, 2 requests of 32-token "
        f"prompts and 8 new tokens, profiled: {json.dumps(window)}")
    census = decode_census(torch, dev, cfg, p16)
    bound = _decode_bound_ms(cfg, p16, census["positions"], 16)
    log(f"[hybrid census] {HYBRID_ARCH} (one fused dispatch, 8 lanes, 16 "
        f"steps, profiled): {json.dumps(census)}; bound of a step "
        f"{bound:.4f} ms")
    want = kernel1_per_forward(cfg)
    if census["kernel1_launches_per_iteration"] != want \
            or census["host_launch_calls_per_iteration"] > 5:
        fail(f"phase 11 {HYBRID_ARCH}: a decode step launched kernel 1 "
             f"{census['kernel1_launches_per_iteration']} times (want "
             f"{want}) with {census['host_launch_calls_per_iteration']} "
             f"host launch calls (at most 5: one graph replay)")
    path_launches = {f"phase 11 {HYBRID_ARCH} {pool}": run["launches"]
                     for pool, run in runs.items()}
    _arch_kernel_cases(torch, bench, cfg, 1024, shapes2, shapes3,
                       runs["paged"]["page_size"],
                       torch.Generator().manual_seed(7))
    main = runs["contiguous"]
    log("[arch] " + json.dumps({
        "name": HYBRID_ARCH, "layers": cfg.n_layers, "depth": "full",
        "params": n_params, "draw_s": t_draw,
        "logits_cpu_vs_card_err": cpu_err,
        "chunked_prefill_vs_forward_err": chunk_err,
        "chunked_decode_vs_forward_err": dec_err,
        "scheduler_chunks": steps,
        "peak_mib": main["peak_mib"], "tok_s": main["tok_s"],
        "ttft_p50_ms": main["ttft_p50_ms"],
        "ttft_p99_ms": main["ttft_p99_ms"],
        "paged_tok_s": runs["paged"]["tok_s"],
        "paged_ttft_p50_ms": runs["paged"]["ttft_p50_ms"],
        "paged_peak_mib": runs["paged"]["peak_mib"],
        "state_mib": main["state_mib"], "kv_mib": main["kv_mib"],
        "paged_kv_mib": runs["paged"]["kv_mib"],
        "kernel1_per_forward": want,
        "host_launch_calls_per_step":
            census["host_launch_calls_per_iteration"],
        "cuda_kernels_per_step": census["cuda_kernels_per_iteration"],
        "decode_device_us_per_step": census["device_us_per_iteration"],
        "decode_busy_us_per_step":
            census["device_busy_us_per_iteration"],
        "decode_wall_us_per_step": census["synced_wall_us_per_iteration"],
        "decode_bound_ms": bound,
        "window_idle_share": window["idle_share"],
        "seconds": time.perf_counter() - t_phase}))
    del p16
    torch.cuda.empty_cache()
    bench.close()
    return bench.records, path_launches


def hybrid_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.hybrid_main()"``: the
    build and phase 11 alone (the hybrid Mamba2 family), for work on that
    phase."""
    _phase_main(11, _hybrid_phase)


# Phase 12: the xLSTM family.  xlstm-350m at full width and depth, no
# cut: 24 layers (21 mLSTM, 3 sLSTM blocks), 355 M weights.  No layer
# attends: kernel 1 is the only kernel on its path.
XLSTM_ARCH = "xlstm-350m"


def _xlstm_phase(torch, dev):
    """Phase 12: xlstm-350m on the card at full width and depth.  Returns
    ({kernel: [record]}, {path: {kernel: launches}}), as ``_hybrid_phase``
    does."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    bench = KernelBench(torch, dev, seed=60, kernels=("rmsnorm",))
    twice = _kernel1_twice(torch, bench, cfg.d_model)
    if twice:
        fail("phase 12: kernel 1 is not deterministic at d 1024: "
             + "; ".join(twice))

    t0 = time.perf_counter()
    p_cpu = lm.init_params(0, cfg32, device="cpu")
    p32 = _to_device(p_cpu, dev)
    n_params = _count_params(p32)
    t_draw = time.perf_counter() - t0
    log(f"[arch] {XLSTM_ARCH}: {n_params} weights drawn in f32 in "
        f"{t_draw:.1f}s")
    cpu_err = _cpu_vs_card(torch, dev, cfg32, p_cpu, p32, "xlstm", 12)
    del p_cpu
    chunk_err, dec_err, steps, _ = _hybrid_chunked(torch, dev, cfg32, p32,
                                                   phase=12)
    _identity9(torch, dev, cfg32, p32, 16, phase=12)
    p16 = _keep_cast(p32, torch.bfloat16)
    del p32
    torch.cuda.empty_cache()

    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(*RECURRENT_PROMPTS, (16,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
               for n in lens]
    runs = {}
    runs["contiguous"], _, _ = _serve9(torch, dev, cfg, p16, prompts,
                                       max_len=1024, phase=12)
    runs["paged"], _, _ = _serve9(torch, dev, cfg, p16, prompts,
                                  max_len=1024, paged=True, phase=12)
    graph_problems = graph_identity(torch, dev, cfg, p16)
    if graph_problems:
        fail(f"phase 12 {XLSTM_ARCH}: graphs vs their eager body: "
             + "; ".join(graph_problems))
    window = _serve_window(torch, dev, cfg, p16)
    log(f"[xlstm window] {XLSTM_ARCH} bf16, 2 requests of 32-token "
        f"prompts and 8 new tokens, profiled: {json.dumps(window)}")
    census = decode_census(torch, dev, cfg, p16)
    bound = _decode_bound_ms(cfg, p16, census["positions"], 16)
    log(f"[xlstm census] {XLSTM_ARCH} (one fused dispatch, 8 lanes, 16 "
        f"steps, profiled): {json.dumps(census)}; bound of a step "
        f"{bound:.4f} ms")
    want = kernel1_per_forward(cfg)
    if census["kernel1_launches_per_iteration"] != want \
            or census["host_launch_calls_per_iteration"] > 5:
        fail(f"phase 12 {XLSTM_ARCH}: a decode step launched kernel 1 "
             f"{census['kernel1_launches_per_iteration']} times (want "
             f"{want}) with {census['host_launch_calls_per_iteration']} "
             f"host launch calls (at most 5: one graph replay)")
    del p16
    torch.cuda.empty_cache()

    # Training at full depth: f32 masters drawn on the card, bf16
    # compute, 8 x 512, remat on, AdamW; kernel 1 per step: 25 + 24
    # forward launches (remat recomputes every layer, not layer 0's ln1
    # before them) and 25 backward.
    params = lm.init_params(0, cfg, device=dev, dtype=torch.float32,
                            draw_on_device=True)
    opt = adamw.init_state(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), accum=1, remat=True)
    batch = make_batch(cfg, 8, 512, kind="train", seed=21, device=dev)
    params, opt, m = step(params, opt, batch)              # warm-up
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    krms.reset_counts()
    losses, step_ms = [float(m["loss"])], []
    for _ in range(3):
        t_s = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t_s) * 1e3)
        losses.append(float(m["loss"]))
    train = {"steps": 3, "batch": "8 x 512", "losses": losses,
             "step_ms": step_ms, "tok_s": 8 * 512 / sorted(step_ms)[1] * 1e3,
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             "kernel1_forward_per_step": krms.launches.count / 3,
             "kernel1_backward_per_step": krms.bwd_launches.count / 3}
    log(f"[xlstm train] {XLSTM_ARCH} full depth: {json.dumps(train)}")
    if not (all(math.isfinite(x) for x in losses)
            and train["kernel1_forward_per_step"] == 2 * want - 1
            and train["kernel1_backward_per_step"] == want):
        fail(f"phase 12 {XLSTM_ARCH}: training steps {train}")
    del params, opt, m, step, batch
    torch.cuda.empty_cache()

    path_launches = {f"phase 12 {XLSTM_ARCH} {pool}": run["launches"]
                     for pool, run in runs.items()}
    main = runs["contiguous"]
    log("[arch] " + json.dumps({
        "name": XLSTM_ARCH, "layers": cfg.n_layers, "depth": "full",
        "params": n_params, "draw_s": t_draw,
        "logits_cpu_vs_card_err": cpu_err,
        "chunked_prefill_vs_forward_err": chunk_err,
        "chunked_decode_vs_forward_err": dec_err,
        "scheduler_chunks": steps,
        "peak_mib": main["peak_mib"], "tok_s": main["tok_s"],
        "ttft_p50_ms": main["ttft_p50_ms"],
        "ttft_p99_ms": main["ttft_p99_ms"],
        "paged_tok_s": runs["paged"]["tok_s"],
        "paged_ttft_p50_ms": runs["paged"]["ttft_p50_ms"],
        "paged_peak_mib": runs["paged"]["peak_mib"],
        "state_mib": main["state_mib"], "kv_mib": main["kv_mib"],
        "kernel1_per_forward": want,
        "host_launch_calls_per_step":
            census["host_launch_calls_per_iteration"],
        "cuda_kernels_per_step": census["cuda_kernels_per_iteration"],
        "decode_device_us_per_step": census["device_us_per_iteration"],
        "decode_busy_us_per_step":
            census["device_busy_us_per_iteration"],
        "decode_wall_us_per_step": census["synced_wall_us_per_iteration"],
        "decode_bound_ms": bound,
        "window_idle_share": window["idle_share"],
        "train_step_ms": train["step_ms"], "train_losses": losses,
        "seconds": time.perf_counter() - t_phase}))
    bench.close()
    return bench.records, path_launches


# Phase 13: the vision family.  llama-3.2-vision-11b at full width and
# depth (40 layers, 8 of them cross-attention), 9.8 G weights drawn in
# bf16 on the card; its f32 check against the CPU runs at one pattern
# group (5 layers), drawn on the host.
VISION_ARCH = "llama-3.2-vision-11b"
VISION_ROWS = (8, 2048)       # a decode step's lanes; a prefill's rows


def _vision_phase(torch, dev):
    """Phase 13: llama-3.2-vision-11b served through the engine's
    lock-step path (``launch.serve.serve_cross_attention``).  Returns
    ({kernel: [record]}, {path: {kernel: launches}})."""
    import argparse

    from repro_torch.configs import get_config
    from repro_torch.core.acc import AdaptiveCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.launch.serve import serve_cross_attention
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(VISION_ARCH)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    nf = cfg.num_frontend_tokens
    bench = KernelBench(torch, dev, seed=70,
                        kernels=("rmsnorm", "flash_attention"))
    lens_rng = torch.Generator().manual_seed(71)
    decode_lens = torch.randint(1, 1025, (8,), generator=lens_rng).tolist()
    decode_lens[0], decode_lens[1] = 1, 1024
    for dtype in (torch.bfloat16, torch.float32):
        for rows in VISION_ROWS:
            bench.rms_case(rows, d, dtype)
            bench.add_case(rows, d, dtype)
        bench.rms_case(8 * nf, d, dtype, name="kv_norm ")
        bench.attn_case(f"{VISION_ARCH} decode", 8, hq, hkv, 1, 1024, hd,
                        decode_lens, None, dtype)
        bench.attn_case(f"{VISION_ARCH} prefill", 8, hq, hkv, 256, 1024, hd,
                        [256] * 8, None, dtype)
        bench.attn_case(f"{VISION_ARCH} cross decode", 8, hq, hkv, 1, nf,
                        hd, [nf] * 8, None, dtype, causal=False)
        bench.attn_case(f"{VISION_ARCH} cross prefill", 8, hq, hkv, 256, nf,
                        hd, [nf] * 8, None, dtype, causal=False)
    bench.check(f"{VISION_ARCH}'s kernels")
    twice = _kernel1_twice(torch, bench, d)
    if twice:
        fail("phase 13: kernel 1 is not deterministic at d 4096: "
             + "; ".join(twice))

    # f32, one pattern group on the host and the card: the logits of a
    # 64-token prompt and its features through forward_cached.
    period = len(cfg.block_pattern)
    cfg32 = dataclasses.replace(cfg, n_layers=period,
                                compute_dtype="float32")
    t0 = time.perf_counter()
    p_cpu = lm.init_params(0, cfg32, device="cpu")
    batch = make_batch(cfg32, 1, 64, kind="prefill", seed=2, device="cpu")
    outs = []
    for where, params in (("cpu", p_cpu), (dev, None)):
        params = params if params is not None else _to_device(p_cpu, dev)
        caches = lm.init_caches(cfg32, 1, 64, device=where)
        logits, _ = lm.forward_cached(
            params, batch["tokens"].to(where), caches, 0, cfg32,
            frontend_feats=batch["frontend_feats"].to(where))
        outs.append(logits.float().cpu())
        del params, caches
    del p_cpu
    torch.cuda.empty_cache()
    cpu_err = float((outs[0] - outs[1]).abs().max())
    cpu_argmax = int(outs[0].argmax()) == int(outs[1].argmax())
    log(f"[vision] {VISION_ARCH} full width f32, one pattern group "
        f"({period} layers, 1 cross-attention), a 64-token prompt with "
        f"{nf} frontend tokens: max |logit cpu - cuda| = {cpu_err:.3g} "
        f"(tol 2e-3), argmax equal {cpu_argmax} "
        f"({time.perf_counter() - t0:.1f}s)")
    if not (cpu_err <= 2e-3 and cpu_argmax
            and bool(torch.isfinite(outs[1]).all())):
        fail(f"phase 13 {VISION_ARCH}: logits differ between the card and "
             f"the CPU ({cpu_err})")

    # Serving at full width and depth, bf16 weights drawn on the card.
    t0 = time.perf_counter()
    p16 = lm.init_params(0, cfg, device=dev, draw_on_device=True)
    torch.cuda.synchronize()
    n_params = _count_params(p16)
    weight_bytes = _count_params(p16, True)
    t_draw = time.perf_counter() - t0
    log(f"[arch] {VISION_ARCH}: {n_params} weights ({weight_bytes} B) "
        f"drawn in bf16 on the card in {t_draw:.1f}s")
    args = argparse.Namespace(requests=8, prompt_len=256, new_tokens=64,
                              seed=0)
    executor = adaptive(SequentialExecutor(),
                        AdaptiveCoreChunk(cache=CalibrationCache()))
    serve_cross_attention(cfg, p16, args, executor, dev)   # warm-up
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    krms.reset_counts()
    for counter in (kfa.launches, kfa.paged_launches):
        counter.reset()
    with ForwardSpy(lm, krms) as fspy:
        t_s = time.monotonic()
        out = serve_cross_attention(cfg, p16, args, executor, dev)
        torch.cuda.synchronize()
        makespan = time.monotonic() - t_s
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count,
                "paged_flash_attention": kfa.paged_launches.count}
    by_key = {str(k): v for k, v in kfa.launches.by_key.items()}
    cross_launched = any(key[2] == nf for key in kfa.launches.by_key)
    k1_line, problems = fspy.report(args.requests, cfg)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    mesh_run = _vision_mesh13(torch, dev, cfg, p16, args, executor, out)
    log(f"[serve13 mesh] {VISION_ARCH} lock-step bf16 on a 1x1 mesh: "
        + json.dumps(mesh_run))
    if not mesh_run["tokens_bit_equal"]:
        problems.append("the 1x1 mesh's lock-step tokens differ from the "
                        "no-mesh run's")
    if not mesh_run["launches"].get("rmsnorm") \
            or not mesh_run["launches"].get("flash_attention"):
        problems.append(f"the 1x1 mesh run launched {mesh_run['launches']}")
    if tuple(out.shape) != (8, 64) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        problems.append(f"served tokens {tuple(out.shape)} out of shape or "
                        f"vocab")
    if launches["rmsnorm"] <= 0 or launches["flash_attention"] <= 0 \
            or launches["paged_flash_attention"]:
        problems.append(f"the lock-step path skipped a kernel: {launches}")
    if not cross_launched:
        problems.append("no cross-attention launch of kernel 2 over the "
                        "frontend tokens")
    # The same requests timed by part: the prefill (TTFT of the batch)
    # and each decode step, synced.
    eng = ServeEngine(cfg, p16, batch=8, max_len=256 + 64 + 1,
                      executor=executor, device=dev)
    b = make_batch(cfg, 8, 256, kind="prefill", seed=0, device=dev)
    torch.cuda.synchronize()
    t_p = time.perf_counter()
    logits = eng.prefill(b["tokens"], b["frontend_feats"])
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t_p) * 1e3
    tok = logits[:, -1].argmax(-1, keepdim=True)
    dec_ms = []
    for _ in range(16):
        t_d = time.perf_counter()
        logits = eng.decode(tok, b["frontend_feats"])
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t_d) * 1e3)
    # Where a decode step's time goes: one step profiled, device only.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_d = time.perf_counter()
        eng.decode(tok, b["frontend_feats"])
        torch.cuda.synchronize()
        t_d = time.perf_counter() - t_d
    step_profile = _device_profile(torch, prof, t_d)
    del eng, logits, prof
    # The least time of one decode step: every weight read once (the
    # embedding's 8 rows only) over the memory rate, and the cross K/V
    # recomputed from the features (8 layers x 2 x 8 x 1601 x 4096 x
    # 1024 x 2 operations) over the bf16 peak; the larger of the two.
    n_cross = cfg.layer_kinds().count("cross_attn")
    read = weight_bytes - _count_params(p16["embed"], True) + 8 * d * 2
    xkv_ops = n_cross * 2 * 8 * nf * d * hkv * hd * 2
    dec_bound = max(read / HBM_BYTES_PER_S, xkv_ops / PEAK_BF16) * 1e3
    med = sorted(dec_ms)[len(dec_ms) // 2]
    run = {"requests": 8, "prompt": 256, "new_tokens": 64,
           "frontend_tokens": nf, "makespan_s": makespan,
           "tok_s": out.numel() / makespan, "ttft_ms": ttft_ms,
           "decode_step_ms_median": med,
           "decode_step_ms": [round(x, 2) for x in dec_ms],
           "decode_bound_ms": dec_bound,
           "decode_bound_weights_ms": read / HBM_BYTES_PER_S * 1e3,
           "decode_bound_cross_kv_ms": xkv_ops / PEAK_BF16 * 1e3,
           "peak_mib": peak, "launches": launches,
           "kernel2_by_key": by_key, "decode_step_profile": step_profile}
    log(f"[serve13] {VISION_ARCH} lock-step bf16: {json.dumps(run)}; "
        f"{k1_line}")
    if problems:
        fail(f"phase 13 {VISION_ARCH} serving: " + "; ".join(problems))
    del p16
    torch.cuda.empty_cache()
    log("[arch] " + json.dumps({
        "name": VISION_ARCH, "layers": cfg.n_layers, "depth": "full",
        "params": n_params, "draw_s": t_draw,
        "logits_cpu_vs_card_err": cpu_err, "cpu_check_layers": period,
        "tok_s": run["tok_s"], "ttft_ms": ttft_ms,
        "decode_step_ms": med, "decode_bound_ms": dec_bound,
        "decode_idle_share": step_profile["idle_share"],
        "peak_mib": peak, "kernel1_per_forward": kernel1_per_forward(cfg),
        "seconds": time.perf_counter() - t_phase}))
    bench.close()
    return bench.records, {
        f"phase 13 {VISION_ARCH} lock-step": launches,
        f"phase 13 {VISION_ARCH} lock-step mesh 1x1": mesh_run["launches"]}


VISION_MESH_NEW = 16


def _vision_mesh13(torch, dev, cfg, params, args, executor, want) -> dict:
    """What ``launch/serve.py --mesh 1,1`` runs for a cross-attention
    arch (``serve_cross_attention`` on a one-rank NCCL mesh), with phase
    13's weights and requests, ``VISION_MESH_NEW`` new tokens each
    (``main`` would draw the 11B weights on the host): its tokens
    against the first ones of the no-mesh run's (``want``), its makespan
    and the kernels' launches."""
    import argparse
    import contextlib
    import io
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import serve_cross_attention

    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_distributed("cuda", init_method=f"file://{tmp}/rdv",
                                  rank=0, world_size=1, timeout_s=120)
        try:
            mesh = mesh_lib.make_serve_mesh(1, 1)
            krms.reset_counts()
            for counter in (kfa.launches, kfa.paged_launches):
                counter.reset()
            short = argparse.Namespace(**{**vars(args),
                                          "new_tokens": VISION_MESH_NEW})
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.monotonic()
                got = serve_cross_attention(cfg, params, short, executor,
                                            dev, mesh=mesh)
                torch.cuda.synchronize()
                took = time.monotonic() - t0
            launches = {"rmsnorm": krms.launches.count,
                        "flash_attention": kfa.launches.count,
                        "paged_flash_attention": kfa.paged_launches.count}
        finally:
            dist.destroy_process_group()
    return {"tokens_bit_equal": torch.equal(got, want[:, :VISION_MESH_NEW]),
            "new_tokens": VISION_MESH_NEW, "makespan_s": took,
            "tok_s": got.numel() / took,
            "launches": {k: v for k, v in launches.items() if v}}


def _phase_main(n: int, phase) -> None:
    """The build and one phase alone, for work on that phase."""
    import torch

    if not torch.cuda.is_available():
        fail(f"phase {n} needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import strict
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"[build] {sorted(build.build_all())}")
    strict.enable()
    records, path_launches = phase(torch, torch.device("cuda"))
    log(f"[phase {n}] {sum(map(len, records.values()))} kernel records; "
        f"launches by path {json.dumps(path_launches)}; "
        f"{time.perf_counter() - t0:.1f}s")


# Phase 14: measured kernel plans (``kernels/autotune.KernelTuner``) for
# kernels 1-3 on the main path, qwen3-0.6b at full width.
TUNE_HEADS = (16, 8)
TUNE_PAGE = 16
TUNE_SERVE = ["--arch", "qwen3-0.6b", "--requests", "16", "--slots", "8",
              "--prompt-len", "512", "--new-tokens", "64",
              "--kernel-autotune"]


def _tune_kernel1(torch, bench) -> tuple[list, list]:
    """Kernel 1's forward at every candidate warp count against the
    default launch (bit for bit) and the plain version; timed."""
    from repro_torch.kernels import rmsnorm as krms

    records, bad = [], []
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = bench.RMS_TOL[str(dtype)[6:]]
        for rows, d in ((8, 1024), (4096, 1024), (8, 6144)):
            x = bench.randn(rows, d, dtype=dtype)
            y = bench.randn(rows, d, dtype=dtype)
            g = 1.0 + 0.1 * bench.randn(d, dtype=torch.float32)
            base = krms.rmsnorm(x, g, eps=1e-6)
            s0, h0 = krms.add_rmsnorm(x, y, g, eps=1e-6)
            ref = krms.rmsnorm_ref(x, g, 1e-6)
            _, h_ref = krms.add_rmsnorm_ref(x, y, g, 1e-6)
            for entry, work in (("rmsnorm", krms.rmsnorm_work(x, g)),
                                ("add_rmsnorm",
                                 krms.add_rmsnorm_work(x, y, g))):
                bound, by = work_bound(work)
                for warps in krms.WARPS:
                    if entry == "rmsnorm":
                        out = krms.rmsnorm(x, g, eps=1e-6, warps=warps)
                        same = torch.equal(out, base)
                        ok, err = within(torch, out, ref, atol, rtol)
                        fn = lambda w=warps: krms.rmsnorm(  # noqa: E731
                            x, g, eps=1e-6, warps=w)
                    else:
                        s1, h1 = krms.add_rmsnorm(x, y, g, eps=1e-6,
                                                  warps=warps)
                        same = torch.equal(s1, s0) and torch.equal(h1, h0)
                        ok, err = within(torch, h1, h_ref, atol, rtol)
                        fn = lambda w=warps: krms.add_rmsnorm(  # noqa: E731
                            x, y, g, eps=1e-6, warps=w)
                    rec = dict(entry=entry, shape=f"rows={rows} d={d} "
                               f"{str(dtype)[6:]}", warps=warps,
                               prior=warps == krms.DEFAULT_WARPS, err=err,
                               ok=ok, bit_equal_default=same,
                               ms=time_ms(torch, fn, flush=bench.flush),
                               bound_ms=bound, bound_by=by)
                    records.append(rec)
                    log(f"[tune kernel1] {rec}")
                    if not (ok and same):
                        bad.append(f"{entry} {rec['shape']} warps={warps}")
    return records, bad


def _tune_attention(torch, bench, perm) -> tuple[list, list]:
    """Kernels 2 and 3 at every candidate plan of the main path's calls
    (``tuning.candidates_attention``): each against the plain version
    (phase 3's tolerances), kernel 3 bit-equal to kernel 2 at the same
    plan, two calls bit-identical; timed beside the bound (the modules'
    own count) and SDPA on the same inputs."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import tuning

    hq, hkv = TUNE_HEADS
    d, max_len, ps = 128, 1024, TUNE_PAGE
    rng = torch.Generator().manual_seed(1)
    decode_lens = torch.randint(1, max_len + 1, (8,), generator=rng).tolist()
    decode_lens[0], decode_lens[1] = 1, max_len
    cases = [("decode", 8, 1, decode_lens)]
    cases += [(f"verify{v}", 8, v, [max(n, v) for n in decode_lens])
              for v in (2, 4, 8)]
    cases += [("prefill", 1, 256, [700])]
    records, bad = [], []
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
        for name, b, sq, kv_lens in cases:
            q = bench.randn(b, hq, sq, d, dtype=dtype)
            kc = bench.randn(b, hkv, max_len, d, dtype=dtype)
            vc = bench.randn(b, hkv, max_len, d, dtype=dtype)
            lens = torch.tensor(kv_lens, dtype=torch.int32, device=bench.dev)
            ks, vs, pt = paged_stores(torch, kc, vc, lens, ps, perm)
            ref = kfa.attention_ref(q, kc, vc, lens)
            bound, by = work_bound(kfa.flash_attention_work(q, kc, vc, lens))
            mask = bench._attn_mask(b, sq, max_len, lens, None)[:, None]
            sdpa_ms = time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask, enable_gqa=True),
                flush=bench.flush)
            prior = kfa.attention_plan(b, hq, hkv, sq, dtype)
            for plan in tuning.candidates_attention(b, hq, hkv, sq, max_len,
                                                    dtype):
                out = kfa.flash_attention(q, kc, vc, lens, plan=plan)
                again = kfa.flash_attention(q, kc, vc, lens, plan=plan)
                paged = kfa.paged_flash_attention(q, ks, vs, pt, lens,
                                                  page_size=ps, plan=plan)
                torch.cuda.synchronize()
                ok, err = within(torch, out, ref, atol, rtol)
                same = torch.equal(paged, out) and torch.equal(out, again)
                value = plan.chunk if plan.path == "split" \
                    else plan.block_rows
                rec = dict(
                    shape=f"{name} B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                          f"Skv={max_len} D={d} {str(dtype)[6:]}",
                    path=plan.path, value=value,
                    prior=value == (prior.chunk if prior.path == "split"
                                    else prior.block_rows),
                    err=err, ok=ok, bit_equal_kernel3_and_2_calls=same,
                    tol=f"atol={atol} rtol={rtol}",
                    ms=time_ms(torch, lambda p=plan: kfa.flash_attention(
                        q, kc, vc, lens, plan=p), flush=bench.flush),
                    paged_ms=time_ms(
                        torch, lambda p=plan: kfa.paged_flash_attention(
                            q, ks, vs, pt, lens, page_size=ps, plan=p),
                        flush=bench.flush),
                    library_ms=sdpa_ms, bound_ms=bound, bound_by=by)
                records.append(rec)
                log(f"[tune attention] {rec}")
                if not (ok and same):
                    bad.append(f"{rec['shape']} {plan.path}={value}")
    return records, bad


def _tune_serve(torch, dev, cfg, params, prompts, store, *, paged):
    """Phase 5's requests served analytic and with a ``KernelTuner``
    over ``store`` (the acc calibrations' store, as the launcher's), in
    turns A B B A (each turn a new scheduler over its store, which
    serves eight of the requests before its window; the second tuned one
    reuses the first's winners), so the order of the runs cancels:
    tok/s and TTFT of each, the first tuned run's launches
    (counters reset around it) and searches; then, on that scheduler,
    the cost of one decode-loop iteration mid-run and the launch audit
    of the live step (and, contiguous, of the injected host copy).
    Returns {"analytic": first A, "tuned": first B, "runs": all four}."""
    from repro_torch.analysis import launch_audit
    from repro_torch.core.acc import AdaptiveCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.serve import ServeScheduler, percentile
    from repro_torch.serve.scheduler import RequestState
    from repro_torch.train.autotune import make_kernel_tuner

    kw = dict(n_slots=8, max_len=1024, dispatch_depth="auto", device=dev)
    if paged:
        kw.update(paged=True, speculate="auto")
    runs = []
    for turn, tuned in enumerate((False, True, True, False)):
        first = turn == 1
        # Both arms keep their calibrations in a store on disk (the
        # analytic arm's apart), so both pay the same writes.
        cache = CalibrationCache.persistent(
            store if tuned else store + "-analytic")
        tuner = make_kernel_tuner(cache) if tuned else None
        sched = ServeScheduler(
            cfg, params, executor=adaptive(SequentialExecutor(),
                                           AdaptiveCoreChunk(cache=cache)),
            kernel_tuner=tuner, **kw)
        t0 = time.perf_counter()
        sched.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        searched = tuner.searches if tuned else 0
        # Eight requests (8 tokens each) before the window, in both arms:
        # a tuned step's first dispatch over the full pool measures its
        # plans (the first tuned turn) and captures it anew out of the
        # window.
        for p in prompts[:8]:
            sched.submit(p, max_new_tokens=8)
        sched.run_until_idle()
        sched.clear_finished()
        torch.cuda.synchronize()
        before = tuner.searches if tuned else 0
        iters0, disp0 = sched.decode_loop_iters, sched.decode_dispatches
        host0, caps0 = sched.host_overhead_s, dict(sched.graphs.captures)
        gc.collect()
        krms.reset_counts()
        kfa.launches.reset()
        kfa.paged_launches.reset()
        t_start = time.monotonic()
        rids = [sched.submit(p, max_new_tokens=64) for p in prompts]
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        makespan = time.monotonic() - t_start
        launches = {"rmsnorm": krms.launches.count,
                    "flash_attention": kfa.launches.count,
                    "paged_flash_attention": kfa.paged_launches.count}
        gen = sum(len(results[r]) for r in rids)
        ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
                 for r in rids]
        run = {"tuned": tuned, "tok_s": gen / makespan,
               "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
               "makespan_s": makespan, "warmup_s": warm_s,
               "tokens": gen, "launches": launches,
               "decode_loop_iters": sched.decode_loop_iters - iters0,
               "decode_dispatches": sched.decode_dispatches - disp0,
               "host_overhead_s": sched.host_overhead_s - host0,
               "captures_before_window": caps0,
               "captures": dict(sched.graphs.captures)}
        if tuned:
            run.update(searches=tuner.searches, store_hits=tuner.cache_hits,
                       searches_during_warmup=searched,
                       searches_in_window=tuner.searches - before)
        if not first:
            cache.save()
        else:
            run["plans"] = [
                {"key": list(map(str, r.key[1:-1])), "prior": r.prior,
                 "winner": r.winner,
                 "prior_us": None if r.prior_seconds is None
                 else r.prior_seconds * 1e6,
                 "winner_us": None if r.winner_seconds is None
                 else r.winner_seconds * 1e6}
                for r in tuner.reports if r.measured]
            # The cost of one decode-loop iteration of the live step,
            # mid-run: every admitted request decoding, none prefilling.
            for p in prompts[:8]:
                sched.submit(p, max_new_tokens=256)
            for _ in range(200):
                states = [r.state for r in sched._active]
                if RequestState.DECODE in states and not sched._waiting \
                        and RequestState.PREFILL not in states:
                    break
                sched.tick()
            positions = list(sched.pool.positions)
            cost = sched.decode_cost_analysis()
            sched.run_until_idle()
            run["decode_cost"] = {k: v for k, v in cost.items()
                                  if k != "kernels"} | {
                "positions": positions,
                "bound_us": cost["bound_s"] * 1e6,
                "kernels": cost["kernels"]}
            cache.save()
            audits = {"live": launch_audit.audit_scheduler(sched)}
            if not paged:
                audits["injected host copy"] = launch_audit.audit_scheduler(
                    sched, inject_host_copy=True)
            run["audit"] = {k: a.to_dict() for k, a in audits.items()}
            for k, a in audits.items():
                log(f"[tune audit] {'paged' if paged else 'contiguous'} "
                    f"{k}: {launch_audit.format_report(a)}")
        runs.append(run)
        log(f"[tune serve] {'paged+spec' if paged else 'contiguous'} turn "
            f"{turn}: {json.dumps(run)}")
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    return {"analytic": runs[0], "tuned": runs[1], "runs": runs}


def _tune_pinned(torch, dev, cfg, params, prompts, store) -> dict:
    """Phase 5's requests over the contiguous pool with every online
    decision pinned (dispatch depth 8, no speculation, a static one-core
    chunk plan), analytic and tuned (the winners already in ``store``:
    no search) in turns A B B A, so the comparison holds no decision's
    spread.  Each arm serves eight of the requests (8 tokens each)
    before its timed window: the tuned step's first dispatch over the
    full pool captures it anew with its measured plans, and the analytic
    arm does the same work.  Then
    one ``forward_cached`` at L = 128, 16 and 1 each way: the host time
    of the call and its synced span (median of 20)."""
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.models import flags, lm
    from repro_torch.serve import ServeScheduler, percentile
    from repro_torch.train.autotune import make_kernel_tuner

    tuner = make_kernel_tuner(CalibrationCache.persistent(store))
    runs = []
    for tuned in (False, True, True, False):
        sched = ServeScheduler(cfg, params, n_slots=8, max_len=1024,
                               executor=adaptive(SequentialExecutor(),
                                                 StaticCoreChunk(cores=1)),
                               dispatch_depth=8,
                               kernel_tuner=tuner if tuned else None,
                               device=dev)
        sched.warmup()
        for p in prompts[:8]:
            sched.submit(p, max_new_tokens=8)
        sched.run_until_idle()
        sched.clear_finished()
        torch.cuda.synchronize()
        gc.collect()
        iters0 = sched.decode_loop_iters
        t0 = time.monotonic()
        rids = [sched.submit(p, max_new_tokens=64) for p in prompts]
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        makespan = time.monotonic() - t0
        ttfts = [sched.requests[r].first_token_at
                 - sched.requests[r].arrival for r in rids]
        runs.append({"tuned": tuned, "tok_s": sum(
            len(results[r]) for r in rids) / makespan,
            "makespan_s": makespan,
            "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
            "decode_loop_iters": sched.decode_loop_iters - iters0,
            "captures": dict(sched.graphs.captures)})
        del sched
    serve_searches = tuner.searches
    caches = lm.init_caches(cfg, 1, 1024, device=dev)
    gen = torch.Generator().manual_seed(14)
    forward = {}
    for length in (128, 16, 1):
        toks = torch.randint(0, cfg.vocab_size, (1, length),
                             generator=gen).to(dev)
        for name, t in (("analytic", None), ("tuned", tuner)):
            hs, spans = [], []
            with flags.kernel_tuner(t):
                for _ in range(25):
                    torch.cuda.synchronize()
                    t_0 = time.perf_counter()
                    lm.forward_cached(params, toks, caches, 0, cfg)
                    hs.append(time.perf_counter() - t_0)
                    torch.cuda.synchronize()
                    spans.append(time.perf_counter() - t_0)
            forward[f"L{length} {name}"] = {
                "host_ms": sorted(hs[5:])[10] * 1e3,
                "span_ms": sorted(spans[5:])[10] * 1e3}
    # The single-lane forwards take shapes the served runs never did
    # (B 1 at L 1): their searches are counted apart.
    out = {"runs": runs, "forward_cached": forward,
           "serve_searches": serve_searches,
           "forward_searches": tuner.searches - serve_searches}
    log(f"[tune pinned] {json.dumps(out)}")
    return out


def _tune_f32(torch, dev, cfg32, store) -> list:
    """f32 under measured plans: decode logits after a 300-token prefill
    of 8 lanes, tuned against analytic (within 2e-3); tuned paged tokens
    against tuned contiguous tokens (equal: kernels 2 and 3 take one
    plan for one call).  Returns the problems."""
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.models import flags, lm
    from repro_torch.serve import ServeScheduler
    from repro_torch.train.autotune import make_kernel_tuner

    problems = []
    p32 = lm.init_params(0, cfg32, device=dev)
    tuner = make_kernel_tuner(CalibrationCache.persistent(store))
    rng = torch.Generator().manual_seed(21)
    toks = torch.randint(0, cfg32.vocab_size, (8, 301), generator=rng).to(dev)
    logits = {}
    for name, t in (("analytic", None), ("tuned", tuner)):
        caches = lm.init_caches(cfg32, 8, 1024, device=dev)
        with flags.kernel_tuner(t):
            lm.forward_cached(p32, toks[:, :300], caches, 0, cfg32)
            logits[name], _ = lm.forward_cached(p32, toks[:, 300:], caches,
                                                300, cfg32)
    torch.cuda.synchronize()
    err = float((logits["tuned"] - logits["analytic"]).abs().max())
    decode = [r for r in tuner.reports
              if "split" in map(str, r.key)]
    log(f"[tune f32] decode logits tuned vs analytic: max |diff| {err:.3g} "
        f"(tol 2e-3); split plans measured (prior -> winner): "
        f"{[(r.prior, r.winner) for r in decode]}")
    if not (err <= 2e-3 and bool(torch.isfinite(logits["tuned"]).all())):
        problems.append(f"f32 tuned decode logits differ by {err}")
    prompts = [torch.randint(0, cfg32.vocab_size, (n,), generator=rng)
               for n in (64, 100, 150, 200, 250, 120, 80, 256)]
    tokens = {}
    for paged in (False, True):
        sched = ServeScheduler(cfg32, p32, n_slots=8, max_len=1024,
                               acc=StaticCoreChunk(cores=8),
                               dispatch_depth=4, paged=paged,
                               page_size=TUNE_PAGE, kernel_tuner=tuner,
                               device=dev)
        rids = [sched.submit(p, max_new_tokens=16) for p in prompts]
        res = sched.run_until_idle()
        tokens[paged] = [res[r] for r in rids]
        del sched
    log(f"[tune f32] tuned paged tokens == tuned contiguous tokens: "
        f"{tokens[True] == tokens[False]}; searches {tuner.searches}")
    if tokens[True] != tokens[False]:
        problems.append("f32 tuned paged tokens differ from contiguous")
    tuner.cache.save()
    return problems


def _tune_count_card_vs_cpu(torch, dev) -> list:
    """The reduced config's decode-iteration count on the card and on
    the CPU, f32 and bf16: the same ticks (fixed chunks, per-tick
    decode), the same flops and bytes, and in bf16 the same tensor-core
    share (> 0: the split the main path's bound rests on)."""
    from repro_torch.configs import get_config
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.models import lm
    from repro_torch.serve import ServeScheduler

    # Head dim 64: the smallest the rotary entry has a register layout
    # for in bf16 (the reduced config's 16 has none on the card).
    base = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               head_dim=64)
    keys = ("flops_per_device", "hbm_bytes_per_device", "tensor_flops",
            "other_flops", "kernels")
    problems = []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        p_cpu = lm.init_params(0, cfg, device="cpu")
        rng = torch.Generator().manual_seed(22)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
                   for n in (9, 17, 30, 12)]
        counts = {}
        for where in ("cpu", "cuda"):
            params = p_cpu if where == "cpu" else _to_device(p_cpu, dev)
            sched = ServeScheduler(cfg, params, n_slots=4, max_len=64,
                                   acc=StaticCoreChunk(cores=2),
                                   dispatch_depth=None, device=where)
            for p in prompts:
                sched.submit(p, max_new_tokens=8)
            for _ in range(4):
                sched.tick()
            counts[where] = sched.decode_cost_analysis()
        same = all(counts["cpu"][k] == counts["cuda"][k] for k in keys)
        log(f"[tune count] reduced qwen3-0.6b (head dim 64) {dtype} decode "
            f"iteration: cpu { {k: counts['cpu'][k] for k in keys[:4]} }, "
            f"card { {k: counts['cuda'][k] for k in keys[:4]} }; "
            f"equal: {same}")
        if not same:
            problems.append(f"the {dtype} decode-iteration count differs "
                            f"between the card and the CPU")
        if dtype == "bfloat16" and not counts["cuda"]["tensor_flops"] > 0:
            problems.append("the bf16 decode-iteration count has no "
                            "tensor-core flops")
    return problems


def _tune_train(store) -> tuple[dict, list]:
    """Three steps of 8 x 512 through ``launch/train.py
    --kernel-autotune`` at full width, in this process."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train as launch_train

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as ckpt:
        with contextlib.redirect_stdout(buf):
            launch_train.main(["--arch", "qwen3-0.6b", "--steps", "3",
                               "--batch", "8", "--seq", "512",
                               "--cal-cache-dir", store, "--ckpt", ckpt,
                               "--log-every", "1", "--kernel-autotune"])
    out = buf.getvalue()
    lines = out.splitlines()
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step")]
    tune = [ln for ln in lines if ln.startswith("kernel autotune:")]
    done = [ln for ln in lines if ln.startswith("done:")]
    rec = {"losses": losses, "autotune": tune, "done": done}
    log(f"[tune train] {json.dumps(rec)}")
    ok = len(losses) == 3 and all(math.isfinite(x) for x in losses) \
        and len(tune) == 1
    return rec, [] if ok else [f"train --kernel-autotune: {rec}"]


def _tune_subprocesses(stores: dict) -> list:
    """The serve CLI twice over each of two fresh stores (contiguous;
    paged with speculation at width 4): the first process measures, the
    second, on the same requests, searches nothing and reuses every
    winner; beside the first round the launch-audit CLI (clean: rc 0;
    the injected host copy: rc 1).  The decode plans are measured on the
    first process's live lanes, so the second runs the same shapes: a
    fixed speculation width, where ``auto`` could visit a width the
    first never did."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    serve = [sys.executable, "-m", "repro_torch.launch.serve", *TUNE_SERVE]
    cli = {"contiguous": serve + ["--cal-cache-dir", stores["cli"]],
           "paged": serve + ["--paged", "--speculate", "4",
                             "--cal-cache-dir", stores["cli paged"]]}
    audit = [sys.executable, "-m", "repro_torch.analysis.launch_audit",
             "--arch", "qwen3-0.6b"]
    rounds = [{"serve contiguous first": cli["contiguous"],
               "serve paged first": cli["paged"], "audit": audit,
               "audit injected": audit + ["--paged", "--inject-host-copy"]},
              {"serve contiguous second": cli["contiguous"],
               "serve paged second": cli["paged"]}]
    outs = {}
    for cmds in rounds:
        procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
                 for k, c in cmds.items()}
        try:
            for k, proc in procs.items():
                outs[k] = (proc.communicate(timeout=400)[0],
                           proc.returncode)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    problems = []
    for k, (text, rc) in outs.items():
        tail = [ln for ln in text.splitlines()
                if ln.startswith(("kernel autotune:", "generated",
                                  "launch-audit", "  VIOLATION"))]
        log(f"[tune cli] {k}: rc={rc}; {tail}")
        if k.startswith("serve"):
            want = "kernel autotune: 0 measured" if k.endswith("second") \
                else "kernel autotune: "
            if rc != 0 or not any(ln.startswith(want) for ln in tail):
                problems.append(f"{k} process: rc {rc}, {tail} "
                                f"{text[-1500:] if rc else ''}")
        elif rc != (1 if "injected" in k else 0) or not any(
                ln.startswith("launch-audit:") for ln in tail):
            problems.append(f"{k}: rc {rc} {text[-1500:]}")
    return problems


def _tune_phase(torch, dev):
    """Phase 14 (module docstring).  Returns ({kernel: records},
    {path: launches}) like the other phases."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    base = get_config("qwen3-0.6b")
    bench = KernelBench(torch, dev, seed=40,
                        kernels=("rmsnorm", "flash_attention"))
    k1, bad1 = _tune_kernel1(torch, bench)
    attn, bad2 = _tune_attention(torch, bench,
                                 torch.Generator().manual_seed(41))
    bench.close()
    if bad1 or bad2:
        fail(f"phase 14 kernel plans: kernel 1 not bit-equal to its "
             f"default launch or off its plain version: {bad1}; kernels "
             f"2/3 off tolerance, or not bit-equal to each other or over "
             f"two calls: {bad2}")
    problems = []
    tmp = tempfile.mkdtemp(prefix="tune-store-")
    stores = {k: os.path.join(tmp, k.replace(" ", "-")) for k in (
        "contiguous", "paged", "f32", "train", "cli", "cli paged")}
    try:
        params = lm.init_params(0, base, device=dev)
        rng = torch.Generator().manual_seed(3)
        lens = torch.randint(64, 513, (16,), generator=rng).tolist()
        prompts = [torch.randint(0, base.vocab_size, (n,), generator=rng)
                   for n in lens]
        serve = {}
        for pool in ("contiguous", "paged"):
            serve[pool] = _tune_serve(torch, dev, base, params, prompts,
                                      stores[pool], paged=pool == "paged")
            tuned = serve[pool]["tuned"]
            if tuned["searches"] <= 0:
                problems.append(f"{pool}: the tuned run searched nothing")
            live = tuned["audit"]["live"]
            if not live["ok"]:
                problems.append(f"{pool}: the live step's audit: {live}")
            inj = tuned["audit"].get("injected host copy")
            if inj is not None and inj["ok"]:
                problems.append("the injected host copy passed the audit")
            if not all(tuned["launches"][k] > 0 for k in (
                    "rmsnorm", "paged_flash_attention" if pool == "paged"
                    else "flash_attention")):
                problems.append(f"{pool}: the tuned run launched no kernel "
                                f"{tuned['launches']}")
        pinned = _tune_pinned(torch, dev, base, params, prompts,
                              stores["contiguous"])
        if pinned["serve_searches"]:
            problems.append(f"the pinned tuned runs searched "
                            f"{pinned['serve_searches']} times over a full "
                            f"store")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        census = decode_census(torch, dev)
        for pool in ("contiguous", "paged"):
            cost = serve[pool]["tuned"]["decode_cost"]
            log(f"[tune cost] {pool}: one decode-loop iteration "
                f"({cost['path']}, positions {cost['positions']}): flops "
                f"{cost['flops_per_device']:.4g} (tensor "
                f"{cost['tensor_flops']:.4g}), bytes "
                f"{cost['hbm_bytes_per_device']:.4g}, bound "
                f"{cost['bound_us']:.1f} us ({cost['bound_by']}); measured "
                f"step (decode census, positions 100-800, analytic plans): "
                f"device busy {census['device_busy_us_per_iteration']:.1f} "
                f"us, synced wall {census['synced_wall_us_per_iteration']:.1f}"
                f" us")
        cfg32 = dataclasses.replace(base, compute_dtype="float32")
        problems += _tune_f32(torch, dev, cfg32, stores["f32"])
        problems += _tune_count_card_vs_cpu(torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
        _, train_bad = _tune_train(stores["train"])
        problems += train_bad
        gc.collect()
        torch.cuda.empty_cache()
        problems += _tune_subprocesses(stores)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        fail("phase 14: " + "; ".join(problems))
    for pool in ("contiguous", "paged"):
        t = serve[pool]["tuned"]
        turns = " ".join(f"{'B' if r['tuned'] else 'A'} {r['tok_s']:.1f}"
                         for r in serve[pool]["runs"])
        ttft = " ".join(f"{r['ttft_p50_ms']:.1f}"
                        for r in serve[pool]["runs"])
        log(f"[tune] {pool}: tok/s A B B A {turns}; ttft p50 ms {ttft}; "
            f"searches {t['searches']} ({t['searches_during_warmup']} in "
            f"warmup, {t['searches_in_window']} in the window), then "
            f"{serve[pool]['runs'][2]['searches']}")
    log(f"[phase 14] {time.perf_counter() - t_phase:.1f}s")
    path_launches = {
        f"phase 14 qwen3-0.6b tuned {pool}": {
            k: v for k, v in serve[pool]["tuned"]["launches"].items() if v}
        for pool in ("contiguous", "paged")}
    return {"rmsnorm": k1, "flash_attention": attn}, path_launches


def tune_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.tune_main()"``: the
    build and phase 14 alone (measured kernel plans)."""
    _phase_main(14, _tune_phase)


def xlstm_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.xlstm_main()"``: the
    build and phase 12 alone (the xLSTM family)."""
    _phase_main(12, _xlstm_phase)


def vision_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.vision_main()"``: the
    build and phase 13 alone (the vision family)."""
    _phase_main(13, _vision_phase)


# Phase 15: multi-GPU on torch.distributed at world size 1 over NCCL (the
# one card this machine has; NCCL refuses two ranks on one card).  Serving
# on ``make_serve_mesh(1, 1)`` against the no-mesh scheduler, the mesh
# decode step's launch audit, the algorithms' mesh functions through
# kernels 4-7, one int8-compressed data-parallel step.

MESH_ARCH = "qwen3-0.6b"


def _phase5_prompts(torch, vocab: int) -> list:
    """Phase 5's 16 requests (the same generator calls)."""
    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(64, 513, (16,), generator=rng).tolist()
    return [torch.randint(0, vocab, (n,), generator=rng) for n in lens]


def _replay_ms(torch, runner, reps: int = 20):
    """Median device time of one replay of ``runner``'s captured step
    (CUDA events around each replay), None with nothing captured.  The
    step's budgets are spent, so a replay computes every lane and drops
    every write (``fused_body``'s ``keep``)."""
    cap = getattr(runner, "_capture", None)
    if cap is None:
        return None
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        cap.graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def _forward_host15(torch, dev, cfg, sched) -> dict:
    """Host time and synced span (ms, median of 20 after 5) of one eager
    ``forward_cached`` of the scheduler's weights on fresh contiguous
    caches at L = 128 and 1, under its tensor-parallel context (the
    prefill's path: a chunk runs eagerly)."""
    from repro_torch.models import flags, lm

    caches = lm.init_caches(cfg, 1, 1024, device=dev,
                            tp=sched.pool.part.plan)
    gen = torch.Generator().manual_seed(14)
    out = {}
    with flags.tensor_parallel(sched.tp):
        for length in (128, 1):
            toks = torch.randint(0, cfg.vocab_size, (1, length),
                                 generator=gen).to(dev)
            hs, spans = [], []
            for _ in range(25):
                torch.cuda.synchronize()
                t = time.perf_counter()
                lm.forward_cached(sched.params, toks, caches, 0, cfg)
                hs.append(time.perf_counter() - t)
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t)
            out[f"L{length}"] = {"host_ms": sorted(hs[5:])[10] * 1e3,
                                 "span_ms": sorted(spans[5:])[10] * 1e3}
        # Where an eager forward's host time goes: one more at L = 128,
        # profiled on the CPU side (self time of each op, top 6).
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            lm.forward_cached(sched.params, toks.new_zeros((1, 128)),
                              caches, 0, cfg)
            torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    out["L128_top_self_cpu_us"] = {
        e.key[:48]: [e.count, round(e.self_cpu_time_total, 1)]
        for e in ops[:6]}
    return out


def _nccl_probe15(torch, dev, mesh) -> dict:
    """One eager ``all_reduce`` over the model group at the decode
    step's residual shape (8 x 1024 bf16), profiled: the NCCL kernels it
    launches at world size 1 and its host time (median of 20)."""
    import torch.distributed as dist

    t = torch.ones(8, 1024, dtype=torch.bfloat16, device=dev)
    hs = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=mesh.groups["model"])
        hs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        dist.all_reduce(t, group=mesh.groups["model"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"nccl_kernels": sum(e.count for e in kernels
                                if "nccl" in e.key.lower()),
            "device_kernels": sum(e.count for e in kernels),
            "host_us": sorted(hs[5:])[10] * 1e6,
            "equal": bool((t == 1).all())}


def _mesh_serve15(torch, dev, cfg, params, prompts, mesh, *, paged):
    """One pinned serve run (phase 5's requests, the decisions of
    ``serve_pinned_main``) on ``mesh`` or none: tokens, tok/s, TTFT, the
    kernels' launches and the fused step's replay time."""
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.serve import ServeScheduler, percentile

    kw = dict(paged=True, page_size=16, prefill_interleave=1,
              speculate=2) if paged else {}
    sched = ServeScheduler(cfg, params, n_slots=8, max_len=1024,
                           executor=adaptive(SequentialExecutor(),
                                             StaticCoreChunk(cores=1)),
                           dispatch_depth=8, mesh=mesh, device=dev, **kw)
    sched.warmup()
    torch.cuda.synchronize()
    gc.collect()
    krms.reset_counts()
    for counter in (kfa.launches, kfa.paged_launches):
        counter.reset()
    t_start = time.monotonic()
    rids = [sched.submit(p, max_new_tokens=64) for p in prompts]
    results = sched.run_until_idle()
    torch.cuda.synchronize()
    makespan = time.monotonic() - t_start
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count,
                "paged_flash_attention": kfa.paged_launches.count}
    tokens = [results.get(r) for r in rids]
    ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
             for r in rids]
    n_tok = sum(len(t or ()) for t in tokens)
    run = {"tokens": tokens, "tok_s": n_tok / makespan,
           "forward_cached": _forward_host15(torch, dev, cfg, sched),
           "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
           "launches": {k: v for k, v in launches.items() if v},
           "step_ms": _replay_ms(torch, sched._fused_step().runner),
           "captures": dict(sched.graphs.captures),
           "replays": sched.graphs.replays}
    return run, sched


MESH_FRONTEND_REQUESTS, MESH_FRONTEND_NEW = 8, 32


def _mesh_frontend15(torch, dev, cfg, params, prompts, mesh):
    """Phase 5's first ``MESH_FRONTEND_REQUESTS`` prompts through the
    asyncio front end (``ServeFrontend``), every one submitted before
    the first tick, over a scheduler with the pinned decisions of
    ``_mesh_serve15`` (contiguous) on ``mesh`` or none; then the
    scheduler's ``decode_cost_analysis``.  The records' tokens in
    submission order, whether each stream gave its record's tokens, the
    makespan, the kernels' launches and the count."""
    import asyncio

    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.serve import ServeFrontend, ServeScheduler

    sched = ServeScheduler(cfg, params, n_slots=8, max_len=1024,
                           executor=adaptive(SequentialExecutor(),
                                             StaticCoreChunk(cores=1)),
                           dispatch_depth=8, mesh=mesh, device=dev)
    sched.warmup()
    torch.cuda.synchronize()
    krms.reset_counts()
    for counter in (kfa.launches, kfa.paged_launches):
        counter.reset()

    async def replay():
        async with ServeFrontend(sched, max_queue=64) as fe:
            streams = [await fe.submit(p, MESH_FRONTEND_NEW, wait=True)
                       for p in prompts[:MESH_FRONTEND_REQUESTS]]

            async def drain(stream):
                return [t async for t in stream]

            got = await asyncio.gather(*(drain(s) for s in streams))
            return [s.rid for s in streams], got

    t0 = time.monotonic()
    rids, streamed = asyncio.run(replay())
    torch.cuda.synchronize()
    makespan = time.monotonic() - t0
    tokens = [sched.requests[r].out for r in rids]
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count,
                "paged_flash_attention": kfa.paged_launches.count}
    cost = sched.decode_cost_analysis()
    return {"tokens": tokens, "streamed_equal": streamed == tokens,
            "makespan_s": makespan,
            "launches": {k: v for k, v in launches.items() if v},
            "cost": cost}


def _mesh_algorithms15(torch, dev, mexec) -> tuple[dict, list]:
    """The mesh branches of reduce, inclusive_scan, adjacent_difference
    and artificial_work (``*_on_mesh``, the code each entry runs on a
    mesh once acc picks more than one core, with the entry's own shard
    bodies) at 2^24 f32 on a one-rank sub-group: each through its kernel
    and bit-equal to the no-mesh kernel call; the 1-d kernels' launches
    in these calls.  At world size 1 the entries themselves never take
    these branches (a plan needs two cores to be parallel)."""
    import importlib

    from repro_torch.kernels import adjacent_difference as kad
    from repro_torch.kernels import artificial_work as kaw
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce_scan as krs

    x = torch.randn(2 ** 24, generator=torch.Generator(device=dev)
                    .manual_seed(15), device=dev)
    plain = {"reduce_sum": ops.reduce_sum(x),
             "inclusive_scan": ops.inclusive_scan(x),
             "adjacent_difference": ops.adjacent_difference(x),
             "artificial_work": ops.artificial_work(x, iters=256)}
    counters = {"reduce_sum": krs.reduce_launches,
                "inclusive_scan": krs.scan_launches,
                "adjacent_difference": kad.launches,
                "artificial_work": kaw.launches}
    for c in counters.values():
        c.reset()
    # The modules by name: the package's functions reduce and
    # adjacent_difference shadow their modules as its attributes.
    alg = {m: importlib.import_module(f"repro_torch.algorithms.{m}")
           for m in ("reduce", "scan", "adjacent_difference", "stencil")}
    got = {
        "reduce_sum": alg["reduce"].reduce_on_mesh(mexec, 1, x),
        "inclusive_scan": alg["scan"].inclusive_scan_on_mesh(mexec, 1, x),
        "adjacent_difference": alg["adjacent_difference"]
        .adjacent_difference_on_mesh(mexec, 1, x),
        "artificial_work": alg["stencil"].artificial_work_on_mesh(
            mexec, 1, x, iters=256)}
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    problems = []
    for name, ref in plain.items():
        out = got[name].reshape(ref.shape)
        if not torch.equal(out, ref):
            err = float((out.float() - ref.float()).abs().max())
            problems.append(f"mesh {name} differs from the no-mesh kernel "
                            f"call (max |err| {err:.3g})")
        if launches[name] <= 0:
            problems.append(f"mesh {name} launched no kernel")
    return launches, problems


def _mesh_dp15(torch, dev, mesh) -> tuple[dict, list]:
    """One int8-compressed data-parallel step of qwen3-0.6b at full width
    and 2 layers (f32 masters, bf16 compute): each quantisation group's
    synced gradient against the plain f32 mean (at world size 1, the
    gradient itself) within one int8 quantum of the group (half a
    quantum from each of the two stages), then the step itself."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.sharding import local_tree
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import grad_compress as gc8
    from repro_torch.train import train_loop

    cfg = dataclasses.replace(get_config(MESH_ARCH), n_layers=2)
    params = lm.init_params(0, cfg, device=dev, dtype=torch.float32,
                            draw_on_device=True)
    batch = make_batch(cfg, 2, 256, kind="train", seed=0, device=dev)
    group = mesh.groups["data"]
    flat, tparams = train_loop._trainable(params)
    loss = train_loop.make_loss_fn(cfg)(tparams, batch)
    grads = train_loop._grad(loss, flat)
    worst, problems = 0.0, []
    for idx in gc8._groups(cfg, params):
        g = torch.cat([grads[i].float().reshape(-1) for i in idx])
        q, scale = gc8._quantize(g, group)
        mean = gc8._int8_allreduce_mean(q, scale, group, 1)
        quantum = float(g.abs().max()) / 127 + 1e-12
        err = float((mean - g).abs().max())
        worst = max(worst, err / quantum)
        if err > 1.01 * quantum:
            problems.append(f"group {idx[0]}: |synced - mean| {err:.3g} > "
                            f"one quantum {quantum:.3g}")
    opt = adamw.init_state(params)
    ef = local_tree(gc8.init_error_feedback(params, 1), ("data",), mesh)
    before = float(tree.leaves(params)[0].float().sum())
    step = gc8.make_compressed_dp_train_step(cfg, AdamWConfig(lr=1e-3), mesh)
    t0 = time.perf_counter()
    params, opt, ef, metrics = step(params, opt, ef, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_loss = float(metrics["loss"])
    if not math.isfinite(step_loss) \
            or float(tree.leaves(params)[0].float().sum()) == before:
        problems.append(f"the compressed step did not train (loss "
                        f"{step_loss})")
    return {"loss": step_loss, "worst_err_over_quantum": worst,
            "groups": len(gc8._groups(cfg, params)),
            "step_s": step_s}, problems


def _mesh_phase(torch, dev):
    """Phase 15: the mesh paths at world size 1 over NCCL.  Returns ({},
    {path: launches})."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.analysis import launch_audit
    from repro_torch.configs import get_config
    from repro_torch.core.executor import MeshExecutor
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: unavailable"
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_distributed("cuda", init_method=f"file://{tmp}/rdv",
                                  rank=0, world_size=1, timeout_s=120)
        try:
            mesh = mesh_lib.make_serve_mesh(1, 1)
            log(f"[mesh] {card}: backend {dist.get_backend()}, world "
                f"{dist.get_world_size()}, mesh {mesh.shape}")
            cfg = get_config(MESH_ARCH)
            params = lm.init_params(0, cfg, device=dev, draw_on_device=True)
            prompts = _phase5_prompts(torch, cfg.vocab_size)
            path_launches, runs = {}, {}
            for pool in ("contiguous", "paged"):
                paged = pool == "paged"
                plain, s0 = _mesh_serve15(torch, dev, cfg, params, prompts,
                                          None, paged=paged)
                del s0
                on_mesh, sched = _mesh_serve15(torch, dev, cfg, params,
                                               prompts, mesh, paged=paged)
                audit = launch_audit.audit_scheduler(
                    sched, policy=launch_audit.AuditPolicy(
                        small_copy_max=64, mesh=True))
                del sched
                torch.cuda.empty_cache()
                same = on_mesh["tokens"] == plain["tokens"]
                full = all(t is not None and len(t) == 64
                           for t in on_mesh["tokens"])
                runs[pool] = {"mesh": on_mesh, "plain": plain}
                log(f"[mesh serve] {pool}: " + json.dumps({
                    "card": card, "tokens_bit_equal": same,
                    "mesh": {k: v for k, v in on_mesh.items()
                             if k != "tokens"},
                    "no_mesh": {k: v for k, v in plain.items()
                                if k != "tokens"}}))
                log(f"[mesh audit] {pool}: nccl kernels "
                    f"{audit.kernels.get('nccl', 0)} in one replay; "
                    + launch_audit.format_report(audit).replace("\n", " | "))
                if not same or not full:
                    problems.append(f"{pool}: mesh tokens differ from the "
                                    f"no-mesh scheduler's (or are short)")
                if not audit.ok:
                    problems.append(f"{pool}: launch audit of the mesh step: "
                                    f"{audit.violations}")
                if audit.graph_launches != 1:
                    problems.append(f"{pool}: the audited mesh step made "
                                    f"{audit.graph_launches} graph launches")
                need = ("rmsnorm", "paged_flash_attention") if paged \
                    else ("rmsnorm", "flash_attention")
                for k in need:
                    if not on_mesh["launches"].get(k):
                        problems.append(f"{pool}: the mesh run launched no "
                                        f"{k}")
                path_launches[f"phase 15 {MESH_ARCH} mesh 1x1 {pool}"] = \
                    on_mesh["launches"]
            fronts = {name: _mesh_frontend15(torch, dev, cfg, params,
                                             prompts, m)
                      for name, m in (("no_mesh", None), ("mesh", mesh))}
            a, b = fronts["mesh"], fronts["no_mesh"]
            ca, cb = dict(a["cost"]), dict(b["cost"])
            coll = ca.pop("collective_bytes")
            cb.pop("collective_bytes")
            rec = {"card": card, "requests": MESH_FRONTEND_REQUESTS,
                   "new_tokens": MESH_FRONTEND_NEW,
                   "tokens_bit_equal": a["tokens"] == b["tokens"],
                   "streamed_equal": a["streamed_equal"]
                   and b["streamed_equal"],
                   "makespan_s": {k: r["makespan_s"]
                                  for k, r in fronts.items()},
                   "launches": {k: r["launches"] for k, r in fronts.items()}}
            log("[mesh frontend] " + json.dumps(rec))
            full = all(len(t) == MESH_FRONTEND_NEW for t in a["tokens"])
            if not (rec["tokens_bit_equal"] and rec["streamed_equal"]
                    and full):
                problems.append("frontend: the mesh front end's tokens "
                                "differ from the no-mesh front end's (or "
                                "from its streams, or are short)")
            if not a["launches"].get("rmsnorm") \
                    or not a["launches"].get("flash_attention"):
                problems.append(f"frontend: the mesh run launched "
                                f"{a['launches']}")
            path_launches[f"phase 15 {MESH_ARCH} mesh 1x1 frontend"] = \
                a["launches"]
            same_cost = ca == cb
            log("[mesh cost] " + json.dumps({
                "card": card, "equal_to_no_mesh": same_cost,
                "collective_bytes": coll["bytes"],
                "collective_calls": coll["counts"],
                "flops_per_device": ca["flops_per_device"],
                "hbm_bytes_per_device": ca["hbm_bytes_per_device"],
                "bound_s": ca["bound_s"], "n_devices": ca["n_devices"],
                "path": ca["path"]}))
            if not same_cost or coll["bytes"]["total"] != 0:
                problems.append("decode_cost_analysis on the 1x1 mesh is "
                                "not the no-mesh count with no collective "
                                "bytes")
            del params
            torch.cuda.empty_cache()
            probe = _nccl_probe15(torch, dev, mesh)
            log(f"[mesh nccl] {card}: one eager all_reduce over the model "
                f"group, 8 x 1024 bf16: " + json.dumps(probe))
            if not probe["equal"]:
                problems.append("a one-rank all_reduce changed its input")
            amesh = mesh_lib.make_mesh((1,), ("data",))
            alg_launches, alg_problems = _mesh_algorithms15(
                torch, dev, MeshExecutor(amesh))
            problems += alg_problems
            path_launches["phase 15 mesh algorithms 2^24"] = alg_launches
            log(f"[mesh algorithms] n=2^24 f32, one-rank sub-group: "
                f"bit-equal to the no-mesh kernel calls: "
                f"{not alg_problems}; launches {alg_launches}")
            dp, dp_problems = _mesh_dp15(torch, dev, amesh)
            problems += dp_problems
            log(f"[mesh dp] {card}: " + json.dumps(dp))
        finally:
            dist.destroy_process_group()
    log(f"[phase 15] {time.perf_counter() - t_phase:.1f}s")
    if problems:
        fail("phase 15: " + "; ".join(problems))
    return {}, path_launches


def mesh_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.mesh_main()"``: the
    build and phase 15 alone (multi-GPU at world size 1 over NCCL)."""
    _phase_main(15, _mesh_phase)


# Phase 16: the FSDP × TP training step (``train/sharded.py``) at world
# size 1 over NCCL against the unsharded step, and the dry run.
FSDP_ARCH = "qwen3-0.6b"
FSDP_BATCH, FSDP_SEQ, FSDP_ACCUM = 4, 512, 2
FSDP_MOE_ARCH = "mixtral-8x22b"
FSDP_MOE_BATCH, FSDP_MOE_SEQ = 2, 256


def _card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: unavailable"


def _same_tree(torch, a, b) -> tuple[bool, float]:
    """(every leaf bit-equal, the largest difference relative to the
    leaf's largest magnitude)."""
    from repro_torch import tree

    equal, worst = True, 0.0
    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True):
        if not torch.equal(x, y):
            equal = False
            d = float((x.float() - y.float()).abs().max())
            worst = max(worst, d / max(float(y.float().abs().max()), 1e-30))
    return equal, worst


def _fsdp_steps16(torch, dev, cfg, params, opt_cfg, mesh, batch, *,
                  accum: int, steps: int, sharded: bool,
                  warmup: bool = True, split_at_one: bool = False,
                  **levers) -> dict:
    """``steps`` steps of the sharded (on ``mesh``; ``split_at_one`` and
    ``levers``, ``seq_shard`` / ``moe_ff2d``: its arguments) or the
    unsharded step from a copy of ``params``: losses, norms, step ms,
    kernel 1's forward and backward launches and the collective calls per
    step, the final parameters.  With ``warmup``, one untimed step on
    another copy first (the first call's library and communicator
    set-up)."""
    if warmup:
        _fsdp_steps16(torch, dev, cfg, params, opt_cfg, mesh, batch,
                      accum=accum, steps=1, sharded=sharded, warmup=False,
                      split_at_one=split_at_one, **levers)
        gc.collect()
        torch.cuda.empty_cache()
    from repro_torch import collectives, tree
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    from repro_torch.train import sharded as tsharded

    p = tree.map_leaves(lambda t: t.clone(), params)
    opt = adamw.init_state(p, opt_cfg)
    if sharded:
        p, opt = tsharded.shard_train_state(
            p, opt, mesh, cfg=cfg, moe_ff2d=levers.get("moe_ff2d", False))
        batch = tsharded.shard_batch(batch, mesh, accum)
        step = tsharded.make_sharded_train_step(cfg, opt_cfg, mesh,
                                                accum=accum,
                                                split_at_one=split_at_one,
                                                **levers)
    else:
        step = make_train_step(cfg, opt_cfg, accum=accum)
    calls: list = []
    out = {"loss": [], "grad_norm": [], "ms": [], "fwd": [], "bwd": [],
           "collectives": []}
    collectives.collective_sinks.append(lambda *c: calls.append(c))
    try:
        for _ in range(steps):
            krms.reset_counts()
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, m = step(p, opt, batch)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["loss"].append(m["loss"].clone())
            out["grad_norm"].append(m["grad_norm"].clone())
            out["fwd"].append(krms.launches.count)
            out["bwd"].append(krms.bwd_launches.count)
            out["collectives"].append(len(calls))
    finally:
        collectives.collective_sinks.clear()
    out["params"] = p
    return out


def _fsdp_compare16(torch, name, a, b, problems) -> dict:
    """The sharded run ``a`` against the unsharded ``b``: bit for bit."""
    loss = all(torch.equal(x, y) for x, y in zip(a["loss"], b["loss"],
                                                 strict=True))
    norm = all(torch.equal(x, y) for x, y in zip(a["grad_norm"],
                                                 b["grad_norm"],
                                                 strict=True))
    same, worst = _same_tree(torch, a["params"], b["params"])
    if not (loss and norm and same):
        problems.append(f"{name}: sharded != unsharded at world size 1 "
                        f"(loss {loss}, norm {norm}, params {same}, worst "
                        f"relative {worst:.3g})")
    for k in ("fwd", "bwd"):
        if not all(a[k]):
            problems.append(f"{name}: a sharded step launched no kernel 1 "
                            f"{'forward' if k == 'fwd' else 'backward'}")
    return {"loss_bit_equal": loss, "grad_norm_bit_equal": norm,
            "params_bit_equal": same, "worst_rel": worst,
            "loss": [float(x) for x in a["loss"]],
            "grad_norm": [float(x) for x in a["grad_norm"]],
            "sharded_ms": [round(x, 3) for x in a["ms"]],
            "unsharded_ms": [round(x, 3) for x in b["ms"]],
            "kernel1_fwd_per_step": a["fwd"], "kernel1_bwd_per_step": a["bwd"],
            "collectives_per_step": a["collectives"]}


def _fsdp_phase(torch, dev):
    """Phase 16: the FSDP × TP step at world size 1 over NCCL against the
    unsharded step, bit for bit (qwen3-0.6b at full width and depth, two
    steps of accum 2; mixtral-8x22b at full width, one pattern group, one
    step under global dispatch and one under ``moe_dispatch_groups(2)``),
    and ``launch/dryrun.py`` for qwen3-0.6b train_4k on the single-pod
    mesh.  Returns ({}, {path: launches})."""
    import statistics
    import tempfile

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import flags, lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import sharded as tsharded

    t_phase = time.perf_counter()
    card = _card_line()
    problems: list = []
    path_launches: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # The dry run is a count on meta tensors on the host: it runs
        # beside the card's work.
        dry = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             FSDP_ARCH, "--shape", "train_4k", "--mesh", "single", "--out",
             os.path.join(tmp, "dryrun")], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            mesh_lib.init_distributed("cuda", init_method=f"file://{tmp}/rdv",
                                      rank=0, world_size=1, timeout_s=120)
            try:
                mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
                # [fsdp train]: qwen3-0.6b, f32 masters and moments.
                cfg = get_config(FSDP_ARCH)
                params = lm.init_params(0, cfg, device=dev,
                                        dtype=torch.float32,
                                        draw_on_device=True)
                batch = make_batch(cfg, FSDP_BATCH, FSDP_SEQ, seed=0,
                                   device=dev)
                opt_cfg = AdamWConfig(lr=1e-4)
                plain = _fsdp_steps16(torch, dev, cfg, params, opt_cfg, mesh,
                                      batch, accum=FSDP_ACCUM, steps=2,
                                      sharded=False)
                krms.reset_counts()
                shard = _fsdp_steps16(torch, dev, cfg, params, opt_cfg, mesh,
                                      batch, accum=FSDP_ACCUM, steps=2,
                                      sharded=True)
                path_launches[f"phase 16 {FSDP_ARCH} fsdp 1x1 train"] = {
                    "rmsnorm": sum(shard["fwd"]),
                    "rmsnorm_backward": sum(shard["bwd"])}
                rec = _fsdp_compare16(torch, "fsdp train", shard, plain,
                                      problems)
                rec.update(card=card, arch=FSDP_ARCH,
                           batch=[FSDP_BATCH, FSDP_SEQ], accum=FSDP_ACCUM,
                           sharded_median_ms=statistics.median(shard["ms"]),
                           unsharded_median_ms=statistics.median(
                               plain["ms"]))
                log("[fsdp train] " + json.dumps(rec))
                del params, plain, shard, batch
                gc.collect()
                torch.cuda.empty_cache()
                # [fsdp moe]: mixtral-8x22b, one pattern group, bf16
                # parameters and moments.
                mcfg = dataclasses.replace(
                    get_config(FSDP_MOE_ARCH),
                    n_layers=len(get_config(FSDP_MOE_ARCH).block_pattern),
                    param_dtype="bfloat16")
                mparams = lm.init_params(0, mcfg, device=dev,
                                         dtype=torch.bfloat16,
                                         draw_on_device=True)
                n = sum(t.numel() for t in tree.leaves(mparams))
                reckoned = {"params_bytes": 2 * n, "moments_bytes": 4 * n,
                            "per_copy_bytes": 6 * n,
                            "grads_bytes": 2 * n,
                            "resident_bytes": 2 * n + 2 * (6 * n)
                            + 2 * n}
                mbatch = make_batch(mcfg, FSDP_MOE_BATCH, FSDP_MOE_SEQ,
                                    seed=1, device=dev)
                mopt = AdamWConfig(lr=1e-4, moment_dtype="bfloat16")
                torch.cuda.reset_peak_memory_stats()
                for groups in (None, 2):
                    with flags.moe_dispatch_groups(groups):
                        plain = _fsdp_steps16(torch, dev, mcfg, mparams,
                                              mopt, mesh, mbatch, accum=1,
                                              steps=1, sharded=False)
                        shard = _fsdp_steps16(torch, dev, mcfg, mparams,
                                              mopt, mesh, mbatch, accum=1,
                                              steps=1, sharded=True)
                    name = "global" if groups is None else f"groups{groups}"
                    rec = _fsdp_compare16(torch, f"fsdp moe {name}", shard,
                                          plain, problems)
                    rec.update(card=card, arch=FSDP_MOE_ARCH,
                               layers=mcfg.n_layers, dispatch=name,
                               batch=[FSDP_MOE_BATCH, FSDP_MOE_SEQ],
                               params=n, reckoned=reckoned,
                               max_memory_allocated=
                               torch.cuda.max_memory_allocated())
                    log("[fsdp moe] " + json.dumps(rec))
                    del shard
                    torch.cuda.empty_cache()
                    if groups is None:
                        # Phase 18's [ff2d train] on this state: the
                        # weight-stationary experts on the size-1 split
                        # path against the same unsharded step.
                        ff2d = _fsdp_steps16(torch, dev, mcfg, mparams, mopt,
                                             mesh, mbatch, accum=1, steps=1,
                                             sharded=True, warmup=False,
                                             split_at_one=True,
                                             moe_ff2d=True)
                        rec = _fsdp_compare16(torch, "ff2d train", ff2d,
                                              plain, problems)
                        rec.update(card=card, arch=FSDP_MOE_ARCH,
                                   layers=mcfg.n_layers,
                                   batch=[FSDP_MOE_BATCH, FSDP_MOE_SEQ],
                                   max_memory_allocated=
                                   torch.cuda.max_memory_allocated())
                        log("[ff2d train] " + json.dumps(rec))
                        path_launches[f"phase 18 {FSDP_MOE_ARCH} ff2d 1x1 "
                                      f"train"] = {
                            "rmsnorm": sum(ff2d["fwd"]),
                            "rmsnorm_backward": sum(ff2d["bwd"])}
                        del ff2d
                    del plain
                    torch.cuda.empty_cache()
                del mparams, mbatch
                gc.collect()
                torch.cuda.empty_cache()
            finally:
                dist.destroy_process_group()
        finally:
            out, err = dry.communicate(timeout=600)
    rows = [line for line in out.splitlines() if line.startswith(
        ("OK", "FAIL", "SKIP"))]
    log(f"[dryrun] {card}: exit {dry.returncode}; " + " | ".join(rows))
    if dry.returncode != 0 or not any(r.startswith("OK") for r in rows):
        problems.append(f"the dry run failed (exit {dry.returncode}): "
                        f"{err[-2000:]}")
    log(f"[phase 16] {time.perf_counter() - t_phase:.1f}s")
    if problems:
        fail("phase 16: " + "; ".join(problems))
    return {}, path_launches


def fsdp_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.fsdp_main()"``: the
    build and phase 16 alone (the FSDP × TP step at world size 1 over
    NCCL, and the dry run)."""
    _phase_main(16, _fsdp_phase)


# Phase 17: tensor parallelism of the recurrent and cross-attention
# blocks and the sequence-split decode at world size 1 over NCCL, and
# kernel 2's softmax statistics.
TP_SERVE_ARCHS = ("zamba2-1.2b", "xlstm-350m")
# 32-token prompts (64 before phase 18 came): the recurrent archs
# prefill token by token, and the cut pays for phase 18.
TP_PROMPTS, TP_PROMPT_LEN, TP_NEW = 4, 32, 16
TP_TRAIN = (("zamba2-1.2b", None), ("xlstm-350m", None),
            ("llama-3.2-vision-11b", 5))     # (arch, layers: a pattern group)
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 2, 128
TP_FAMILY = {"attn": "attn", "shared_attn": "attn", "mamba2": "mamba",
             "mlstm": "mlstm", "slstm": "slstm", "cross_attn": "xattn"}
# danube's sequence-split decode: a window of 64 rows (the engine's own
# option; danube's 4096 would take 4096 steps to wrap), so that the
# 96 steps write past the ring's end.
SEQ_ARCH, SEQ_PROMPT, SEQ_NEW, SEQ_MAX = "h2o-danube-1.8b", 64, 32, 512
SEQ_WINDOW = 64


def _tp_serve17(torch, dev, cfg, params, prompts, mesh, *, paged,
                step_reps: int = 0, **sched_kw):
    """One serve run with every decision pinned (one core, depth 4, the
    paged pool's page size 16 unless ``sched_kw`` gives one, chunks of at
    most 64) on ``mesh`` or none (``sched_kw``: more of the scheduler's
    keywords): the tokens, tok/s and the kernels' launches; with
    ``step_reps``, the median ms of that many replays of the fused
    step's graph (``step_ms``)."""
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.serve import ServeScheduler

    kw = dict(paged=True, page_size=sched_kw.pop("page_size", 16)) \
        if paged else {}
    sched = ServeScheduler(cfg, params, n_slots=TP_PROMPTS,
                           max_len=max(len(p) for p in prompts) + TP_NEW + 1,
                           executor=adaptive(SequentialExecutor(),
                                             StaticCoreChunk(cores=1)),
                           dispatch_depth=4, chunk_buckets=(64,), mesh=mesh,
                           device=dev, **kw, **sched_kw)
    sched.warmup()
    torch.cuda.synchronize()
    krms.reset_counts()
    for counter in (kfa.launches, kfa.paged_launches):
        counter.reset()
    t0 = time.monotonic()
    rids = [sched.submit(p, max_new_tokens=TP_NEW) for p in prompts]
    results = sched.run_until_idle()
    torch.cuda.synchronize()
    took = time.monotonic() - t0
    tokens = [results.get(r) for r in rids]
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count,
                "paged_flash_attention": kfa.paged_launches.count}
    extra = {"step_ms": _replay_ms(torch, sched._fused_step().runner,
                                   reps=step_reps)} if step_reps else {}
    return {"tokens": tokens,
            "tok_s": sum(len(t or ()) for t in tokens) / took, **extra,
            "tp": None if sched.tp is None else {
                k: v for k, v in dataclasses.asdict(
                    dataclasses.replace(sched.tp, group=None)).items()
                if k != "group"},
            "launches": {k: v for k, v in launches.items() if v}}


def _flex_lse17(torch, q, k, v, lens):
    """The library call that computes kernel 2 with statistics:
    ``flex_attention`` (compiled, as PyTorch documents it) with ``lens``
    as a block mask built here, outside the timed call, and the rows'
    log-sum-exp out.  Returns a call giving (o, lse)."""
    import inspect

    from torch.nn.attention import flex_attention as fa

    b, _, sq, _ = q.shape
    skv = k.shape[2]

    def visible(bi, h, qi, kv):
        return kv < lens[bi]

    mask = fa.create_block_mask(visible, b, None, sq, skv, device=q.device)
    flex = torch.compile(fa.flex_attention, dynamic=False)
    if "return_aux" in inspect.signature(fa.flex_attention).parameters:
        aux = fa.AuxRequest(lse=True)

        def call():
            o, out = flex(q, k, v, block_mask=mask, enable_gqa=True,
                          return_aux=aux)
            return o, out.lse
        return call
    return lambda: flex(q, k, v, block_mask=mask, enable_gqa=True,
                        return_lse=True)


def _lse_cases17(torch, bench) -> tuple[list, list]:
    """Kernel 2 with its rows' log-sum-exp out at the main run's decode
    shape, danube's ring (one lane full, one partial) and the
    sequence-split decode's (``_seq_decode17``: batch 1, the ring of
    ``SEQ_WINDOW`` rows, a length from its run): the output bit-equal to
    the call without statistics, the statistics within 1e-5 of the plain
    version's, both calls timed with L2 flushed beside the plain version
    and ``flex_attention`` (``_flex_lse17``); then the merge of the cache
    cut into 2 and 4 blocks (a short lane leaves the later blocks empty),
    each block through kernel 2 with statistics, merged by the mesh
    path's ``merge_blocks``, against kernel 2 over the whole cache."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.attention import merge_blocks

    records, problems = [], []
    gen = torch.Generator().manual_seed(17)
    main_lens = torch.randint(1, 1025, (8,), generator=gen).tolist()
    main_lens[0], main_lens[1] = 1, 1024
    ring_lens = [4096, int(torch.randint(1, 4097, (1,), generator=gen))]
    seq_lens = [int(torch.randint(1, SEQ_WINDOW + 1, (1,), generator=gen))]
    # The sequence-split decode's shape first: the ``kernels`` line's.
    cases = (("seq decode", 1, 32, 8, SEQ_WINDOW, 80, seq_lens),
             ("decode", 8, 16, 8, 1024, 128, main_lens),
             ("danube ring", 2, 32, 8, 4096, 80, ring_lens))
    for name, b, hq, hkv, skv, d, kv_lens in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = bench.randn(b, hq, 1, d, dtype=dtype)
            k = bench.randn(b, hkv, skv, d, dtype=dtype)
            v = bench.randn(b, hkv, skv, d, dtype=dtype)
            lens = torch.tensor(kv_lens, dtype=torch.int32, device=bench.dev)
            o, lse = kfa.flash_attention(q, k, v, lens, return_lse=True)
            o0 = kfa.flash_attention(q, k, v, lens)
            ref, ref_lse = kfa.attention_ref(q, k, v, lens, return_lse=True)
            library = _flex_lse17(torch, q, k, v, lens)
            lib_o, lib_lse = library()
            torch.cuda.synchronize()
            same = torch.equal(o, o0)
            lse_err = float((lse - ref_lse).abs().max())
            atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 \
                else (1e-2, 1e-2)
            ok_o, err = within(torch, o, ref, atol, rtol)
            bound, by = work_bound(kfa.flash_attention_work(
                q, k, v, lens, return_lse=True))
            tag = f"{name} B={b} Hq={hq} Hkv={hkv} Sq=1 Skv={skv} D={d} " \
                  f"kv={kv_lens if b < 8 else '1-1024'} {str(dtype)[6:]}"
            rec = dict(
                shape=tag, path=kfa.attention_plan(b, hq, hkv, 1, dtype).path,
                err=err, lse_err=lse_err, ok=ok_o and lse_err <= 1e-5 and same,
                bit_equal_without_lse=same,
                tol=f"o atol={atol} rtol={rtol}; lse 1e-5",
                ms=time_ms(torch, lambda: kfa.flash_attention(
                    q, k, v, lens, return_lse=True), flush=bench.flush),
                without_lse_ms=time_ms(torch, lambda: kfa.flash_attention(
                    q, k, v, lens), flush=bench.flush),
                plain_ms=time_ms(torch, lambda: kfa.attention_ref(
                    q, k, v, lens, return_lse=True), flush=bench.flush),
                library_ms=time_ms(torch, library, flush=bench.flush),
                library="torch.compile(flex_attention) with a block mask "
                        "of the lengths, enable_gqa, the lse out",
                library_err=float((lib_o.float() - ref.float()).abs().max()),
                library_lse_err=float((lib_lse.float() - ref_lse).abs().max()),
                bound_ms=bound, bound_by=by)
            log(f"[kernel flash_attention_lse] {json.dumps(rec)}")
            records.append(rec)
            if not rec["ok"]:
                problems.append(f"lse {tag}: o bit-equal {same}, o err "
                                f"{err:.3g}, lse err {lse_err:.3g}")
            for blocks in (2, 4):
                blk = skv // blocks
                outs, lses = [], []
                for i in range(blocks):
                    local = (lens - i * blk).clamp(0, blk).to(torch.int32)
                    ob, lb = kfa.flash_attention(
                        q, k[:, :, i * blk:(i + 1) * blk].contiguous(),
                        v[:, :, i * blk:(i + 1) * blk].contiguous(), local,
                        return_lse=True)
                    outs.append(ob)
                    lses.append(lb)
                got, got_lse = merge_blocks(torch.stack(outs),
                                            torch.stack(lses))
                # f32 1e-5; bf16 2^-7 of the largest output magnitude: each
                # block's output, the merged one and the whole cache's are
                # rounded to bf16 once each.
                tol = 1e-5 if dtype == torch.float32 \
                    else 2.0 ** -7 * float(o.abs().max())
                m_err = float((got.float() - o.float()).abs().max())
                ml_err = float((got_lse - lse).abs().max())
                empty = sum(int((lens - i * blk <= 0).sum())
                            for i in range(blocks))
                log(f"[merge] {tag} in {blocks} blocks ({empty} empty lane "
                    f"blocks): max |merged - whole| {m_err:.3g} (tol "
                    f"{tol:.3g}), lse {ml_err:.3g} (tol 1e-5)")
                if m_err > tol or ml_err > 1e-5:
                    problems.append(f"merge {tag} {blocks} blocks: {m_err:.3g}"
                                    f", lse {ml_err:.3g}")
            del q, k, v
    return records, problems


def _seq_decode17(torch, dev, card, problems) -> dict:
    """danube at full width and depth, batch 1, one token a step through
    ``ServeEngine``'s lock-step path on ``make_serve_mesh(1, 1)`` with
    ``cache_seq_model`` (the ring's rows on 'model', the new row written
    at ``pos % SEQ_WINDOW``, past the ring's end after ``SEQ_WINDOW``
    steps; kernel 2 with its statistics, the one-rank gather and
    ``merge_blocks``) against the same tokens with no mesh through
    ``lm.forward_cached`` at per-lane positions (kernel 2 over the ring
    in its row order, as the split path reads it; the lock-step no-mesh
    path attends a wrapped ring in position order instead): every step's
    logits bit-equal (the merge of one block is the block), the launches
    of the statistics' calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    cfg = get_config(SEQ_ARCH)
    params = lm.init_params(0, cfg, device=dev, draw_on_device=True)
    prompt = torch.randint(0, cfg.vocab_size, (1, SEQ_PROMPT),
                           generator=torch.Generator().manual_seed(17))
    eng = ServeEngine(cfg, params, batch=1, max_len=SEQ_MAX,
                      window=SEQ_WINDOW, mesh=mesh_lib.make_serve_mesh(1, 1),
                      cache_seq_model=True, device=dev)
    caches = lm.init_caches(cfg, 1, SEQ_MAX, window=SEQ_WINDOW, device=dev)

    def per_lane(tok, t):
        with torch.no_grad():
            return lm.forward_cached(params, tok.to(dev), caches,
                                     torch.tensor([t], device=dev), cfg,
                                     window=SEQ_WINDOW)[0]

    runs = {}
    for name, step in (("seq over model 1x1", lambda tok, t: eng.decode(tok)),
                       ("no mesh, per lane", per_lane)):
        kfa.lse_launches.reset()
        logits = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(SEQ_PROMPT):
            logits.append(step(prompt[:, t:t + 1], t))
        for t in range(SEQ_PROMPT, SEQ_PROMPT + SEQ_NEW):
            logits.append(step(logits[-1].argmax(-1), t))
        torch.cuda.synchronize()
        runs[name] = {"logits": torch.cat(logits, 1), "ms_per_step":
                      (time.perf_counter() - t0) * 1e3 / len(logits),
                      "lse_launches": kfa.lse_launches.count}
    a, b = runs["seq over model 1x1"], runs["no mesh, per lane"]
    same = torch.equal(a["logits"], b["logits"])
    rec = {"card": card, "arch": SEQ_ARCH, "steps": SEQ_PROMPT + SEQ_NEW,
           "window": SEQ_WINDOW, "ring_rows": eng.caches[0]["k"].shape[2],
           "bit_equal": same,
           "seq_blocks": None if eng.seq is None else eng.seq.size,
           "lse_launches": a["lse_launches"],
           "no_mesh_lse_launches": b["lse_launches"],
           "finite": bool(torch.isfinite(a["logits"]).all()),
           "ms_per_step": {k: r["ms_per_step"] for k, r in runs.items()}}
    log("[seq decode] " + json.dumps(rec))
    want = (SEQ_PROMPT + SEQ_NEW) * cfg.n_layers
    if not (same and rec["finite"]) or rec["seq_blocks"] != 1 \
            or rec["ring_rows"] != SEQ_WINDOW \
            or SEQ_WINDOW >= rec["steps"] \
            or a["lse_launches"] != want or b["lse_launches"]:
        problems.append(f"sequence-split decode: {rec} (kernel 2 with "
                        f"statistics {want} times expected)")
    del params, eng, caches
    return rec


def _tp_phase(torch, dev):
    """Phase 17: zamba2 and xlstm served on ``make_serve_mesh(1, 1)``
    against no mesh; kernel 2's statistics and the block merge; the
    sharded train step of zamba2, xlstm and llama-vision (every block
    family on its tensor-parallel path, at size 1) against the unsharded
    one; the sequence-split decode.  Returns ({"flash_attention_
    lse": records}, {path: launches})."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import sharded as tsharded

    t_phase = time.perf_counter()
    card = _card_line()
    problems, path_launches = [], {}
    bench = KernelBench(torch, dev, seed=17, kernels=())
    records, lse_problems = _lse_cases17(torch, bench)
    bench.close()
    problems += lse_problems
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_distributed("cuda", init_method=f"file://{tmp}/rdv",
                                  rank=0, world_size=1, timeout_s=120)
        try:
            mesh = mesh_lib.make_serve_mesh(1, 1)
            for arch in TP_SERVE_ARCHS:
                cfg = get_config(arch)
                params = lm.init_params(0, cfg, device=dev,
                                        draw_on_device=True)
                gen = torch.Generator().manual_seed(17)
                prompts = [torch.randint(0, cfg.vocab_size, (TP_PROMPT_LEN,),
                                         generator=gen)
                           for _ in range(TP_PROMPTS)]
                for paged in (False, True):
                    pool = "paged" if paged else "contiguous"
                    plain = _tp_serve17(torch, dev, cfg, params, prompts,
                                        None, paged=paged)
                    on_mesh = _tp_serve17(torch, dev, cfg, params, prompts,
                                          mesh, paged=paged)
                    same = on_mesh["tokens"] == plain["tokens"]
                    full = all(t is not None and len(t) == TP_NEW
                               for t in on_mesh["tokens"])
                    log(f"[tp serve] {arch} {pool}: " + json.dumps({
                        "card": card, "tokens_bit_equal": same,
                        "mesh": {k: v for k, v in on_mesh.items()
                                 if k != "tokens"},
                        "no_mesh_tok_s": plain["tok_s"]}))
                    if not (same and full):
                        problems.append(f"{arch} {pool}: mesh tokens differ "
                                        f"from the no-mesh scheduler's")
                    need = ["rmsnorm"]
                    if "shared_attn" in cfg.layer_kinds():
                        need.append("paged_flash_attention" if paged
                                    else "flash_attention")
                    for k in need:
                        if not on_mesh["launches"].get(k):
                            problems.append(f"{arch} {pool}: the mesh run "
                                            f"launched no {k}")
                    path_launches[f"phase 17 {arch} mesh 1x1 {pool}"] = \
                        on_mesh["launches"]
                del params
                gc.collect()
                torch.cuda.empty_cache()
            tmesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
            for arch, layers in TP_TRAIN:
                base = get_config(arch)
                cfg = dataclasses.replace(
                    base, n_layers=layers or len(base.block_pattern))
                params = lm.init_params(0, cfg, device=dev,
                                        dtype=torch.float32,
                                        draw_on_device=True)
                batch = make_batch(cfg, TP_TRAIN_BATCH, TP_TRAIN_SEQ, seed=0,
                                   device=dev)
                opt_cfg = AdamWConfig(lr=1e-4)
                plain = _fsdp_steps16(torch, dev, cfg, params, opt_cfg, tmesh,
                                      batch, accum=1, steps=1, sharded=False,
                                      warmup=False)
                shard = _fsdp_steps16(torch, dev, cfg, params, opt_cfg, tmesh,
                                      batch, accum=1, steps=1, sharded=True,
                                      warmup=False, split_at_one=True)
                rec = _fsdp_compare16(torch, f"tp train {arch}", shard, plain,
                                      problems)
                # The step's tensor-parallel context (size 1, asked for):
                # each family of the arch on its split path.
                tp = tsharded.contexts(cfg, tmesh, None, split_at_one=True)[0]
                split = {f: tp is not None and getattr(tp, f)
                         for k, f in TP_FAMILY.items()
                         if k in cfg.layer_kinds()}
                if tp is None or not all(split.values()):
                    problems.append(f"tp train {arch}: a block family off "
                                    f"its split path: {split}")
                rec.update(card=card, arch=arch, layers=cfg.n_layers,
                           batch=[TP_TRAIN_BATCH, TP_TRAIN_SEQ],
                           tp_size=None if tp is None else tp.size,
                           split=split,
                           sharded_ms=shard["ms"], unsharded_ms=plain["ms"])
                log("[tp train] " + json.dumps(rec))
                path_launches[f"phase 17 {arch} train 1x1"] = {
                    "rmsnorm": sum(shard["fwd"]),
                    "rmsnorm_backward": sum(shard["bwd"])}
                del params, plain, shard, batch
                gc.collect()
                torch.cuda.empty_cache()
            seq = _seq_decode17(torch, dev, card, problems)
            path_launches[f"phase 17 {SEQ_ARCH} seq over model 1x1"] = {
                "flash_attention_lse": seq["lse_launches"]}
        finally:
            dist.destroy_process_group()
    log(f"[phase 17] {time.perf_counter() - t_phase:.1f}s")
    if problems:
        fail("phase 17: " + "; ".join(problems))
    return {"flash_attention_lse": records}, path_launches


def tp_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.tp_main()"``: the build
    and phase 17 alone (tensor parallelism of the recurrent and
    cross-attention blocks, the sequence-split decode and kernel 2's
    softmax statistics at world size 1 over NCCL)."""
    _phase_main(17, _tp_phase)


# Phase 18: the attention rules over 'model', sequence parallelism and
# the weight-stationary experts at world size 1 over NCCL.
SP_ARCH, SP_STEPS = "qwen3-0.6b", 3
HEAD_DIM_ARCH, HEAD_DIM_PROMPT_LEN = "musicgen-medium", 64
# The paged "head_dim" run's page size: 9 pages of 9 rows are the
# contiguous run's 64 + 16 + 1 rows, so both attend views of one shape.
HEAD_DIM_PAGE = 9


def _head_dim_engine18(torch, dev, cfg, params, prompts, mesh):
    """``ServeEngine``'s lock-step path over ``prompts`` (B, L): the
    chunked prefill, then ``TP_NEW`` decode steps of the greedy tokens;
    on ``mesh`` with the "head_dim" rule forced, else with no mesh
    (kernel 2).  Every step's last logits, the tokens and the decode
    steps' synced ms."""
    from repro_torch.serve import ServeEngine

    kw = dict(mesh=mesh, force_attn="head_dim") if mesh is not None else {}
    eng = ServeEngine(cfg, params, batch=prompts.shape[0],
                      max_len=prompts.shape[1] + TP_NEW + 1, device=dev, **kw)
    logits = [eng.prefill(prompts.to(dev), chunk=prompts.shape[1])[:, -1]]
    tokens, ms = [], []
    for _ in range(TP_NEW):
        tok = logits[-1].argmax(-1)[:, None]
        tokens.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits.append(eng.decode(tok)[:, -1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rule = None if mesh is None else eng._lockstep()[1].attn
    return {"logits": torch.stack(logits).float(),
            "tokens": torch.cat(tokens, 1), "ms": ms, "rule": rule}


def _levers_phase(torch, dev):
    """Phase 18 (its [ff2d train] runs inside phase 16, on its state):
    [sp train] and [head_dim serve] at world size 1 over NCCL; the
    "kv_shared" rule needs m / Hkv > 1 ranks of 'model', which one card
    cannot give.  Returns ({}, {path: launches})."""
    import statistics
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    card = _card_line()
    problems, path_launches = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_distributed("cuda", init_method=f"file://{tmp}/rdv",
                                  rank=0, world_size=1, timeout_s=120)
        try:
            # [sp train]: Megatron-SP on the size-1 split path.
            tmesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
            cfg = get_config(SP_ARCH)
            params = lm.init_params(0, cfg, device=dev, dtype=torch.float32,
                                    draw_on_device=True)
            batch = make_batch(cfg, TP_TRAIN_BATCH, TP_TRAIN_SEQ, seed=0,
                               device=dev)
            opt_cfg = AdamWConfig(lr=1e-4)
            plain = _fsdp_steps16(torch, dev, cfg, params, opt_cfg, tmesh,
                                  batch, accum=1, steps=SP_STEPS,
                                  sharded=False)
            shard = _fsdp_steps16(torch, dev, cfg, params, opt_cfg, tmesh,
                                  batch, accum=1, steps=SP_STEPS,
                                  sharded=True, split_at_one=True,
                                  seq_shard=True)
            rec = _fsdp_compare16(torch, "sp train", shard, plain, problems)
            rec.update(card=card, arch=SP_ARCH,
                       batch=[TP_TRAIN_BATCH, TP_TRAIN_SEQ],
                       sharded_median_ms=statistics.median(shard["ms"]),
                       unsharded_median_ms=statistics.median(plain["ms"]))
            log("[sp train] " + json.dumps(rec))
            path_launches[f"phase 18 {SP_ARCH} sp 1x1 train"] = {
                "rmsnorm": sum(shard["fwd"]),
                "rmsnorm_backward": sum(shard["bwd"])}
            del params, plain, shard, batch
            gc.collect()
            torch.cuda.empty_cache()

            # [head_dim serve]: musicgen with its heads' dims split over
            # a one-rank 'model' axis, against kernel 2's path.
            mesh = mesh_lib.make_serve_mesh(1, 1)
            base = get_config(HEAD_DIM_ARCH)
            gen = torch.Generator().manual_seed(18)
            prompts = torch.randint(0, base.vocab_size,
                                    (TP_PROMPTS, HEAD_DIM_PROMPT_LEN),
                                    generator=gen)
            cfg32 = dataclasses.replace(base, compute_dtype="float32")
            p32 = lm.init_params(0, cfg32, device=dev, draw_on_device=True)
            serve = {}
            for name, m, kw in (("kernel 2", None, {}),
                                ("head_dim 1x1", mesh,
                                 {"force_attn": "head_dim", "step_reps": 5}),
                                ("head_dim 1x1 paged", mesh,
                                 {"force_attn": "head_dim", "step_reps": 5,
                                  "paged": True,
                                  "page_size": HEAD_DIM_PAGE})):
                kw.setdefault("paged", False)
                serve[name] = _tp_serve17(torch, dev, cfg32, p32,
                                          list(prompts), m, **kw)
            lock = {name: _head_dim_engine18(torch, dev, cfg32, p32,
                                             prompts, m)
                    for name, m in (("kernel 2", None),
                                    ("head_dim 1x1", mesh))}
            del p32
            gc.collect()
            torch.cuda.empty_cache()
            params = lm.init_params(0, base, device=dev, draw_on_device=True)
            bf16 = {name: _head_dim_engine18(torch, dev, base, params,
                                             prompts, m)
                    for name, m in (("head_dim 1x1", mesh),
                                    ("kernel 2", None))}
            del params
            a, b = lock["head_dim 1x1"], lock["kernel 2"]
            err = float((a["logits"] - b["logits"]).abs().max())
            rec = {"card": card, "arch": HEAD_DIM_ARCH,
                   "prompts": [TP_PROMPTS, HEAD_DIM_PROMPT_LEN],
                   "new": TP_NEW,
                   "rule": a["rule"],
                   "f32_scheduler_tokens_equal":
                       serve["head_dim 1x1"]["tokens"]
                       == serve["kernel 2"]["tokens"],
                   "f32_paged_tokens_equal_contiguous":
                       serve["head_dim 1x1 paged"]["tokens"]
                       == serve["head_dim 1x1"]["tokens"],
                   "f32_step_ms": {
                       k: serve[k]["step_ms"]
                       for k in ("head_dim 1x1", "head_dim 1x1 paged")},
                   "page_size": HEAD_DIM_PAGE,
                   "f32_scheduler_launches": {
                       k: r["launches"] for k, r in serve.items()},
                   "f32_lockstep_max_abs_logit_err": err,
                   "f32_lockstep_tokens_equal": torch.equal(a["tokens"],
                                                            b["tokens"]),
                   "finite": bool(torch.isfinite(a["logits"]).all()),
                   "bf16_ms_per_decode_step": {
                       k: statistics.median(r["ms"])
                       for k, r in bf16.items()},
                   "bf16_tokens_equal": torch.equal(
                       bf16["head_dim 1x1"]["tokens"],
                       bf16["kernel 2"]["tokens"])}
            log("[head_dim serve] " + json.dumps(rec))
            mesh_run = serve["head_dim 1x1"]
            if not (rec["f32_scheduler_tokens_equal"]
                    and all(t is not None and len(t) == TP_NEW
                            for t in mesh_run["tokens"])
                    and err <= 2e-3 and rec["f32_lockstep_tokens_equal"]
                    and rec["finite"] and a["rule"] == "head_dim"):
                problems.append(f"head_dim serve: {rec}")
            if mesh_run["launches"].get("flash_attention") \
                    or not mesh_run["launches"].get("rmsnorm"):
                problems.append(f"head_dim serve launched "
                                f"{mesh_run['launches']}: kernel 1 and no "
                                f"kernel 2 expected")
            path_launches[f"phase 18 {HEAD_DIM_ARCH} head_dim 1x1 "
                          f"contiguous"] = mesh_run["launches"]
            paged_run = serve["head_dim 1x1 paged"]
            if not (rec["f32_paged_tokens_equal_contiguous"]
                    and all(t is not None and len(t) == TP_NEW
                            for t in paged_run["tokens"])):
                problems.append("head_dim serve: the paged pool's tokens "
                                "differ from the contiguous pool's")
            if paged_run["launches"].get("flash_attention") \
                    or paged_run["launches"].get("paged_flash_attention") \
                    or not paged_run["launches"].get("rmsnorm"):
                problems.append(f"head_dim paged serve launched "
                                f"{paged_run['launches']}: kernel 1 and "
                                f"neither kernel 2 nor 3 expected")
            path_launches[f"phase 18 {HEAD_DIM_ARCH} head_dim 1x1 "
                          f"paged"] = paged_run["launches"]
        finally:
            dist.destroy_process_group()
    log(f"[phase 18] {time.perf_counter() - t_phase:.1f}s")
    if problems:
        fail("phase 18: " + "; ".join(problems))
    return {}, path_launches


def levers_main() -> None:
    """``python3 -c "import chip_smoke; chip_smoke.levers_main()"``: the
    build and phase 18 alone ([sp train], [head_dim serve]; its [ff2d
    train] runs with phase 16, ``fsdp_main()``)."""
    _phase_main(18, _levers_phase)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


if __name__ == "__main__":
    main()
