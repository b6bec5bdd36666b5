"""Serving entry point: the continuous-batching scheduler under a request load.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --reduced --device cpu --requests 5 --slots 2

Requests (seeded random prompts of jittered lengths, random weights from
``--seed``) go through the ``ServeScheduler``: admission into cache
slots, acc-decided prefill chunking per tick, fused decode.  Reports
throughput and latency percentiles.  Runs on the CUDA card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config
from ..core.acc import AdaptiveCoreChunk
from ..core.adaptive import adaptive
from ..core.calibration import CalibrationCache
from ..core.executor import SequentialExecutor
from ..device import resolve_device
from ..models import lm
from ..serve import ServeScheduler, percentile


def parse_depth(text: str):
    depth = text.strip().lower()
    if depth in ("off", "none", "0"):
        return None
    return depth if depth == "auto" else int(depth)


def prompts(n: int, prompt_len: int, vocab: int, seed: int) -> list:
    """``n`` seeded prompts; lengths jittered so requests join and leave
    the batch at different ticks."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(n, prompt_len))
    return [toks[i, :max(prompt_len - (i % 3) * (prompt_len // 4), 1)]
            for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--dispatch-depth", default="auto",
                    help="fused decode tokens per dispatch: 'auto' "
                         "(serve_dispatch_depth decision, default), an "
                         "integer, or 'off' (per-tick decode)")
    ap.add_argument("--no-cal-cache", action="store_true",
                    help="do not persist T0/t_iter calibrations to disk")
    ap.add_argument("--explain-decisions", action="store_true",
                    help="dump the ExecutionModel decision trace")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(args.seed, cfg, device=device)
    cache = CalibrationCache() if args.no_cal_cache \
        else CalibrationCache.persistent()
    acc = AdaptiveCoreChunk(cache=cache)
    executor = adaptive(SequentialExecutor(), acc)
    max_len = args.prompt_len + args.new_tokens + 1
    sched = ServeScheduler(cfg, params, n_slots=args.slots, max_len=max_len,
                           executor=executor,
                           dispatch_depth=parse_depth(args.dispatch_depth),
                           device=device)
    sched.warmup()

    t_start = time.monotonic()
    rids = [sched.submit(p, max_new_tokens=args.new_tokens)
            for p in prompts(args.requests, args.prompt_len,
                             cfg.vocab_size, args.seed)]
    outs = sched.run_until_idle()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t_start

    lats = [sched.requests[r].finished_at - sched.requests[r].arrival
            for r in rids]
    ttfts = [sched.requests[r].first_token_at - sched.requests[r].arrival
             for r in rids]
    gen = sum(len(outs[r]) for r in rids)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"arch={cfg.name} device={where} requests={args.requests} "
          f"slots={sched.pool.n_slots} ticks={len(sched.trace)} "
          f"dispatch-depth={args.dispatch_depth} "
          f"({sched.decode_dispatches} decode dispatches, "
          f"{sched.host_roundtrips} host round-trips)")
    print(f"generated {gen} tokens in {dt:.2f}s ({gen / dt:.1f} tok/s) | "
          f"latency p50={percentile(lats, 50) * 1e3:.0f}ms "
          f"p95={percentile(lats, 95) * 1e3:.0f}ms | "
          f"ttft p50={percentile(ttfts, 50) * 1e3:.0f}ms")
    print("sample:", outs[rids[0]])
    if args.explain_decisions:
        model = sched.decision_model()
        if model is not None:
            print(model.explain())
    if not args.no_cal_cache:
        cache.save()
        print(f"calibration cache: {cache.path} ({len(cache)} entries)")


if __name__ == "__main__":
    main()
