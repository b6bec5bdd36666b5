"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device   — the card's name and power limit, the torch and CUDA
              versions; requires compute capability >= (9, 0).
2. build    — compiles the port's CUDA kernels from src/repro_torch.
3. kernels  — each kernel against its plain PyTorch version on the card
              at the serve path's shapes, in bf16 and f32, with times of
              the kernel, the plain version, one PyTorch library call
              (a yardstick only) and the least time the card could take;
              each attention record names the schedule
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
              16 requests, 8 slots, dispatch depth "auto"; the kernels'
              launch counters are reset before and read after this run.
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
              lines).  The measured block plan (``KernelTuner``) for two
              of them.  Then adjacent_difference,
              reduce, inclusive_scan, exclusive_scan, artificial_work and
              transform at n = 2^24 and 2^26 under seq, static par and
              acc par (8 workers), each held against the plain function,
              with the acc decisions printed; the 1-d kernels' launch
              counters are reset before and read after this run.
7. paged    — qwen3-0.6b at full width, bf16, served from the paged
              pool with page size, depth and speculation "auto" (16
              shared-prefix requests from the port's load generator; the
              launch counters are reset before and read after this run,
              and every shape kernel 3 ran at is noted).  Then kernel 3
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


def within(torch, out, ref, atol, rtol) -> tuple[bool, float]:
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, float(diff.max())


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
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
        f"(nvcc wall {build.build_seconds})")

    # --------------------------------------------------------- 3. kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    records = {"rmsnorm": [], "flash_attention": []}

    def rms_case(rows, d, dtype):
        x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        g_lib = g.to(dtype)
        out = krms.rmsnorm(x, g, eps=1e-6)
        ref = krms.rmsnorm_ref(x, g, eps=1e-6)
        torch.cuda.synchronize()
        # f32: the sums run in another order; bf16: one rounding step.
        atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
        ok, err = within(torch, out, ref, atol, rtol)
        item = x.element_size()
        byts = 2 * rows * d * item + 4 * d
        ops = 4 * rows * d
        bound = max(byts / HBM_BYTES_PER_S, ops / PEAK_F32) * 1e3
        rec = dict(
            shape=f"rows={rows} d={d} {str(dtype)[6:]}", err=err, ok=ok,
            tol=f"atol={atol} rtol={rtol}",
            ms=time_ms(torch, lambda: krms.rmsnorm(x, g, eps=1e-6),
                       flush=flush),
            plain_ms=time_ms(torch, lambda: krms.rmsnorm_ref(x, g, 1e-6),
                             flush=flush),
            library_ms=time_ms(torch, lambda: torch.nn.functional.rms_norm(
                x, (d,), g_lib, 1e-6), flush=flush),
            bound_ms=bound,
            bound_by="bytes" if byts / HBM_BYTES_PER_S
            >= ops / PEAK_F32 else "operations")
        records["rmsnorm"].append(rec)
        log(f"[kernel rmsnorm] {rec}")

    for dtype in (torch.bfloat16, torch.float32):
        rms_case(8, 1024, dtype)          # decode pre-norms, 8 lanes
        rms_case(8 * 16, 128, dtype)      # decode q-norm: 8 lanes x 16 heads
        rms_case(4096, 1024, dtype)       # a long prefill's pre-norm

    def attn_case(name, b, hq, hkv, sq, skv, d, kv_lens, window, dtype):
        q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, hkv, skv, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, hkv, skv, d, generator=gen, device=dev).to(dtype)
        lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        out = kfa.flash_attention(q, k, v, lens, causal=True, window=window)
        ref = kfa.attention_ref(q, k, v, lens, causal=True, window=window)
        torch.cuda.synchronize()
        # f32: exp and sums in another order; bf16: one output rounding.
        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
        ok, err = within(torch, out, ref, atol, rtol)
        # Work this data needs: visible keys per query row.
        kj = torch.arange(skv, device=dev)
        lens_l = lens.long()
        qi = lens_l[:, None] - sq + torch.arange(sq, device=dev)[None]
        mask = (kj[None, None] < lens_l[:, None, None]) \
            & (qi[:, :, None] >= kj[None, None])
        if window is not None:
            mask &= (qi[:, :, None] - kj[None, None]) < window
        visible = int(mask.sum()) * hq
        keys_read = int(mask.any(dim=1).sum()) * hkv
        item = q.element_size()
        byts = (2 * q.numel() + 2 * keys_read * d) * item + 4 * b
        ops = 4 * d * visible
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        bound = max(byts / HBM_BYTES_PER_S, ops / peak) * 1e3
        attn_mask = mask[:, None]
        rec = dict(
            shape=f"{name} B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} "
                  f"D={d} window={window} {str(dtype)[6:]}",
            path=kfa.attention_plan(b, hq, hkv, sq, dtype).path,
            err=err, ok=ok, tol=f"atol={atol} rtol={rtol}",
            ms=time_ms(torch, lambda: kfa.flash_attention(
                q, k, v, lens, causal=True, window=window), flush=flush),
            plain_ms=time_ms(torch, lambda: kfa.attention_ref(
                q, k, v, lens, causal=True, window=window), flush=flush),
            library_ms=time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, enable_gqa=True),
                flush=flush),
            bound_ms=bound,
            bound_by="bytes" if byts / HBM_BYTES_PER_S >= ops / peak
            else "operations")
        records["flash_attention"].append(rec)
        log(f"[kernel flash_attention] {rec}")

    lens_rng = torch.Generator().manual_seed(1)
    decode_lens = torch.randint(1, 1025, (8,), generator=lens_rng).tolist()
    decode_lens[0], decode_lens[1] = 1, 1024
    for dtype in (torch.bfloat16, torch.float32):
        attn_case("decode", 8, 16, 8, 1, 1024, 128, decode_lens, None, dtype)
        attn_case("prefill", 1, 16, 8, 256, 1024, 128, [700], None, dtype)
        attn_case("window", 1, 16, 8, 256, 1024, 128, [700], 128, dtype)
    bad = [r["shape"] for rs in records.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    del scratch
    sweep_problems = edge_sweep(torch, kfa, dev, seed=10)
    if sweep_problems:
        fail("kernel 2 edge sweep: " + "; ".join(sweep_problems))

    # ----------------------------------------------------------- 4. model
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
    krms.launches.reset()
    kfa.launches.reset()
    t_start = time.monotonic()
    rids = [sched.submit(p, max_new_tokens=64) for p in prompts]
    results = sched.run_until_idle()
    torch.cuda.synchronize()
    makespan = time.monotonic() - t_start
    launches = {"rmsnorm": krms.launches.count,
                "flash_attention": kfa.launches.count}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    gen_tokens = sum(len(results.get(r, [])) for r in rids)
    ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
             for r in rids]
    depths = [d.decision.chunk for d in
              sched.decision_model().trace.entries("serve_dispatch_depth")]
    log(f"[serve] {len(rids)} requests, prompts {min(lens)}-{max(lens)}, "
        f"{gen_tokens} tokens in {makespan:.3f}s = "
        f"{gen_tokens / makespan:.1f} tok/s; decode {sched.decode_tokens} "
        f"tokens in {sched.decode_dispatches} dispatches; ttft p50="
        f"{percentile(ttfts, 50) * 1e3:.1f}ms p99="
        f"{percentile(ttfts, 99) * 1e3:.1f}ms; peak memory {peak_mb:.0f} "
        f"MiB; launches {launches}")
    log(f"[serve] serve_dispatch_depth decisions: {depths}")
    problems = []
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
    with torch.profiler.profile(activities=activities) as prof:
        t_win = time.perf_counter()
        sched.run_until_idle()
        torch.cuda.synchronize()
        t_win = time.perf_counter() - t_win
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
        + "; top kernels (ms): "
        + ", ".join(f"{e.key[:40]}={e.self_device_time_total / 1e3:.1f}"
                    for e in top))

    del sched, params, caches, logits
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 6. algorithms
    algo_records, algo_launches = _algorithms_phase(torch, dev)
    records.update(algo_records)
    launches.update(algo_launches)

    # ----------------------------------------------------------- 7. paged
    paged_records, paged_launches = _paged_phase(torch, dev, base)
    records.update(paged_records)
    launches.update(paged_launches)

    srcs = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:19"),
            "flash_attention": (
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
                "src/repro/kernels/artificial_work.py:22")}
    kernels = []
    for name, recs in records.items():
        # Serve kernels: the decode shape in bf16, the serve path's own.
        # 1-d kernels: n = 2^24 in f32, the paper's largest size.
        head = recs[0] if name in ("rmsnorm", "flash_attention",
                                   "paged_flash_attention") else next(
            r for r in recs if r["shape"] == f"n={KERNEL_SIZES_1D[1]} float32")
        kernels.append({
            "name": name, "route": "cuda", "source": srcs[name][0],
            "replaces": srcs[name][1], "launches": launches[name],
            "max_abs_err": head["err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"]}
            | ({"library_note": head["library_note"]}
               if "library_note" in head else {}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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


def edge_sweep(torch, kfa, dev, seed, page_sizes=()):
    """Kernels 2 and 3 at the schedules' edges.  For each (Hq, Hkv) of
    EDGE_HEADS, dtype and Sq of EDGE_SQ, one call whose lanes sit at every
    kv length of EDGE_KV that is at least Sq (queries are end-aligned);
    and kernel 2 on the tile path with sliding windows.  Kernel 2 is held
    against its plain version (phase 3's tolerances) and two calls must
    give the same bits.  With ``page_sizes``, kernel 3 over the same K/V
    at each page size is held against its plain version, bit for bit
    against kernel 2, and two calls must give the same bits.  Logs one
    record per case, naming the path ``attention_plan`` chose, and returns
    the problems found."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.Generator().manual_seed(seed + 1)
    kernel = "paged_flash_attention" if page_sizes else "flash_attention"
    problems = []
    n_cases = 0
    cases = [(hq, hkv, sq, None) for hq, hkv in EDGE_HEADS for sq in EDGE_SQ]
    if not page_sizes:
        cases += [(16, 8, sq, w) for sq, w in EDGE_WINDOWS]
    for dtype in (torch.bfloat16, torch.float32):
        # f32: exp and sums in another order; bf16: P and the output
        # rounded to bf16.
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        for hq, hkv, sq, window in cases:
            lens_l = [kv for kv in EDGE_KV if kv >= sq]
            b, d, skv = len(lens_l), 128, max(EDGE_KV)
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
                case=f"B={b} Hq={hq} Hkv={hkv} Sq={sq} kv={lens_l[0]}.."
                     f"{lens_l[-1]} window={window} {str(dtype)[6:]}",
                path=kfa.attention_plan(b, hq, hkv, sq, dtype).path,
                kernel2_err=err, kernel2_ok=ok,
                kernel2_deterministic=torch.equal(out, again))
            for ps in page_sizes:
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
            bad += [f"ps{ps} {k}" for ps in page_sizes
                    for k, v in rec[f"ps{ps}"].items()
                    if k != "err" and not v]
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
                if name in ("reduce_sum", "inclusive_scan"):
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

    gen = torch.Generator(device=dev).manual_seed(5)
    perm_gen = torch.Generator().manual_seed(6)
    scratch = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    records = {"paged_flash_attention": []}
    bit_bad = []

    def paged_case(name, b, hq, hkv, sq, kv_lens, d, ps, dtype,
                   max_len=1024):
        skv = -(-max_len // ps) * ps
        q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dtype)
        kc = torch.randn(b, hkv, skv, d, generator=gen, device=dev).to(dtype)
        vc = torch.randn(b, hkv, skv, d, generator=gen, device=dev).to(dtype)
        lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        ks, vs, pt = paged_stores(torch, kc, vc, lens, ps, perm_gen)
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
            bit_bad.append(f"{name} ps={ps} {dtype}")
        kj = torch.arange(skv, device=dev)
        lens_l = lens.long()
        qi = lens_l[:, None] - sq + torch.arange(sq, device=dev)[None]
        mask = (kj[None, None] < lens_l[:, None, None]) \
            & (qi[:, :, None] >= kj[None, None])
        visible = int(mask.sum()) * hq
        keys_read = int(mask.any(dim=1).sum()) * hkv
        item = q.element_size()
        pages_read = int(((lens_l + ps - 1) // ps).sum())
        byts = (2 * q.numel() + 2 * keys_read * d) * item + 4 * b \
            + 4 * pages_read
        ops = 4 * d * visible
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        bound = max(byts / HBM_BYTES_PER_S, ops / peak) * 1e3
        kg = kfa.gather_pages(ks, pt, ps).contiguous()
        vg = kfa.gather_pages(vs, pt, ps).contiguous()
        attn_mask = mask[:, None]
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
            bound_ms=bound,
            bound_by="bytes" if byts / HBM_BYTES_PER_S >= ops / peak
            else "operations")
        records["paged_flash_attention"].append(rec)
        log(f"[kernel paged_flash_attention] {rec}")
        del q, kc, vc, ks, vs, kg, vg

    def decisions(model, kind):
        seen: dict = {}
        for e in model.trace.entries(kind):
            k = (e.decision.chunk if kind != "serve_admission"
                 else e.decision.cores, e.decision.provenance)
            seen[k] = seen.get(k, 0) + 1
        return ", ".join(f"{v}x{n}({p})" for (v, p), n in seen.items()) \
            or "none"

    # Paged serving at full width: the main path of this slice.  It runs
    # first, so the kernel checks below follow the page size "auto" picked
    # and every shape kernel 3 ran at here.
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
    # The shapes of the run: a spy between the wrapper and the built
    # function notes (B, Sq, page size, dtype) of every launch; it reads
    # only host arguments, so the run neither syncs nor launches more.
    shapes: dict = {}
    built = kfa._paged_fn

    def spy():
        fn = built()

        def launch(*args):
            key = (args[7], args[10], args[12], args[17])
            shapes[key] = shapes.get(key, 0) + 1
            return fn(*args)
        return launch

    gc.collect()                     # as in phase 5
    torch.cuda.reset_peak_memory_stats()
    for counter in (krms.launches, kfa.launches, kfa.paged_launches):
        counter.reset()
    kfa._paged_fn = spy
    try:
        t_start = time.monotonic()
        rids = [sched.submit(p, max_new_tokens=64) for _, p in mat]
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        makespan = time.monotonic() - t_start
        launches = {"rmsnorm": krms.launches.count,
                    "flash_attention": kfa.launches.count,
                    "paged_flash_attention": kfa.paged_launches.count}
    finally:
        kfa._paged_fn = built
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
    problems = []
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
        problems.append("the shape spy and the launch counter disagree")
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
            paged_case("decode", 8, 16, 8, 1, decode_lens, 128, ps, dtype)
            for sq in widths:
                paged_case(f"verify{sq}", 8, 16, 8, sq,
                           [max(n, sq) for n in decode_lens], 128, ps, dtype)
            paged_case("prefill", 1, 16, 8, 256, [700], 128, ps, dtype)
            checked.update((b, sq, ps, kfa._DTYPES[dtype])
                           for b, sq in [(8, 1), (1, 256)]
                           + [(8, w) for w in widths])
    for b, sq, ps, dt in sorted(set(shapes) - checked):
        dtype = next(k for k, v in kfa._DTYPES.items() if v == dt)
        if b == 1:      # a prefill chunk, end-aligned after 100 keys
            paged_case("main-prefill", 1, 16, 8, sq, [min(sq + 100, 1024)],
                       128, ps, dtype)
        else:
            paged_case(f"main-Sq{sq}", b, 16, 8, sq,
                       [max(n, sq) for n in decode_lens], 128, ps, dtype)
    bad = [r["shape"] for r in records["paged_flash_attention"]
           if not r["ok"]]
    if bad or bit_bad:
        fail(f"paged_flash_attention disagrees with its plain version: "
             f"{bad}; differs from kernel 2 over the same K/V or between "
             f"two calls: {bit_bad}")
    sweep_problems = edge_sweep(torch, kfa, dev, seed=11,
                                page_sizes=tuple(dict.fromkeys((main_ps, 16))))
    if sweep_problems:
        fail("kernel 3 edge sweep: " + "; ".join(sweep_problems))
    del scratch
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
    for counter in (krms.launches, kfa.launches, kfa.paged_launches):
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


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


if __name__ == "__main__":
    main()
