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
4. model    — qwen3-0.6b at full width, f32, one 64-token prompt through
              forward_cached on the card and on the CPU, same weights.
5. serve    — the ServeScheduler at full width, bf16, random weights:
              16 requests, 8 slots, dispatch depth "auto"; the kernels'
              launch counters are reset before and read after this run.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_BF16 = 989e12             # dense tensor-core bf16, data sheet
PEAK_F32 = 67e12               # f32 outside the tensor cores, data sheet


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
    top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[serve] profiled window (8 requests, 128-token prompts, 16 new "
        f"tokens): wall {t_win * 1e3:.1f}ms, device busy "
        f"{busy_us / 1e3:.1f}ms = "
        + (f"{busy_us / 1e6 / t_win:.3f} of the wall, idle share "
           f"{1 - busy_us / 1e6 / t_win:.3f}" if busy_us > 0
           else "not measured (no device time in the trace)")
        + "; top kernels (ms): "
        + ", ".join(f"{e.key[:40]}={e.self_device_time_total / 1e3:.1f}"
                    for e in top))

    srcs = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:19"),
            "flash_attention": (
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:93")}
    kernels = []
    for name, recs in records.items():
        head = recs[0]    # the decode shape in bf16: the serve path's own
        kernels.append({
            "name": name, "route": "cuda", "source": srcs[name][0],
            "replaces": srcs[name][1], "launches": launches[name],
            "max_abs_err": max(r["err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


if __name__ == "__main__":
    main()
