"""Serving entry point: the continuous-batching scheduler under a request load.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --reduced --device cpu --requests 5 --slots 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --reduced --device cpu --paged --speculate auto --frontend

Requests (seeded random prompts of jittered lengths, random weights from
``--seed``) go through the ``ServeScheduler``: admission into cache
slots, acc-decided prefill chunking per tick, fused decode.  Reports
throughput and latency percentiles.  ``--paged`` serves from the paged
pool with prefix reuse (every attention through the paged kernel),
``--speculate`` turns on self-speculative decoding, and ``--frontend``
replays a seeded open-loop trace through the asyncio ``ServeFrontend``
with streaming, deadlines and adaptive admission, leading its report
with SLO-goodput.  Runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import asyncio
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
from ..serve import (ServeFrontend, ServeScheduler, SLOModel,
                     heavy_tailed_trace, materialize, percentile)


def parse_depth(text: str):
    depth = text.strip().lower()
    if depth in ("off", "none", "0"):
        return None
    return depth if depth == "auto" else int(depth)


def parse_auto(text: str, off_ok: bool = False):
    """'auto', an int, or (with ``off_ok``) 'off' -> None."""
    value = text.strip().lower()
    if off_ok and value in ("off", "none", "0"):
        return None
    return value if value == "auto" else int(value)


def prompts(n: int, prompt_len: int, vocab: int, seed: int) -> list:
    """``n`` seeded prompts; lengths jittered so requests join and leave
    the batch at different ticks."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(n, prompt_len))
    return [toks[i, :max(prompt_len - (i % 3) * (prompt_len // 4), 1)]
            for i in range(n)]


def serve_frontend(sched: ServeScheduler, args) -> None:
    """Async front-end replay: a seeded heavy-tailed open-loop trace with
    streaming consumers and per-request SLO deadlines — the mode whose
    headline is goodput, not throughput."""
    trace = heavy_tailed_trace(
        args.requests, rate_rps=args.rate_rps,
        max_prompt=max(args.prompt_len, 8), max_new=args.new_tokens,
        seed=args.seed, slo=SLOModel())
    mat = materialize(trace, sched.cfg.vocab_size, seed=args.seed)
    frontend = ServeFrontend(sched, max_queue=args.max_queue)

    async def replay():
        async with frontend:
            t0 = time.monotonic()

            async def one(tr, prompt):
                delay = tr.arrival_s - (time.monotonic() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                deadline = None if tr.deadline_s is None \
                    else t0 + tr.deadline_s
                stream = await frontend.submit(prompt, tr.new_tokens,
                                               deadline=deadline, wait=True)
                async for _tok in stream:
                    pass

            await asyncio.gather(*(one(tr, p) for tr, p in mat))
            return time.monotonic() - t0

    makespan = asyncio.run(replay())
    stats = frontend.stats()
    recs = list(frontend.records.values())
    ttfts = [r.first_token_at - r.submitted_at for r in recs
             if r.first_token_at is not None]
    goodput = stats["goodput_tokens"] / makespan if makespan else 0.0
    eligible = max(stats["submitted"] - stats["cancelled"], 1)
    print(f"arch={sched.cfg.name} frontend requests={args.requests} "
          f"slots={sched.pool.n_slots} admission={sched.admission} "
          f"ticks={len(sched.trace)}")
    print(f"SLO-goodput {goodput:.1f} tok/s over {makespan:.2f}s | "
          f"completed {stats['completed']} "
          f"(in-SLO {stats['completed_in_slo']}) shed {stats['shed']} "
          f"rejected {stats['rejected']} | "
          f"miss rate {stats['missed'] / eligible:.1%} | "
          f"ttft p50={percentile(ttfts, 50) * 1e3:.0f}ms "
          f"p99={percentile(ttfts, 99) * 1e3:.0f}ms")


def print_paged_stats(sched: ServeScheduler) -> None:
    if sched._spec:
        st = sched.spec_stats()
        print(f"speculate: depth={st['depth']} verifies={st['verifies']} "
              f"emitted={st['emitted']} | "
              f"{st['tokens_per_verify']:.2f} tok/verify "
              f"(acceptance {st['acceptance_rate']:.1%})")
    if not sched.paged:
        return
    st = sched.pool.prefix_stats()
    print(f"paged: page_size={st['page_size']} pages "
          f"{st['pages_in_use']}/{st['n_pages']} | prefix hits "
          f"{st['prefix_hits']}/{st['prefix_lookups']} avoided "
          f"{st['prefill_tokens_avoided']} tok | cow {st['cow_copies']} | "
          f"prefill stall {sched.prefill_stall_s * 1e3:.0f}ms")


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
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool: fixed-size pages behind page "
                         "tables, copy-on-write prefix reuse and prefill "
                         "interleaved into fused decode; every attention "
                         "through the paged kernel.  Needs a fused "
                         "--dispatch-depth")
    ap.add_argument("--page-size", default="auto",
                    help="tokens per KV page: 'auto' (serve_page_size "
                         "decision, default) or an integer")
    ap.add_argument("--prefill-interleave", default="auto",
                    help="max prefill chunk-ops per fused decode tick: "
                         "'auto' (serve_prefill_interleave decision, "
                         "default) or an integer")
    ap.add_argument("--speculate", default="off",
                    help="self-speculative decoding in the fused loop: "
                         "'auto' (serve_spec_depth decision), an integer "
                         "draft window, or 'off' (default); the tokens "
                         "are greedy decoding's")
    ap.add_argument("--frontend", action="store_true",
                    help="serve through the asyncio ServeFrontend: seeded "
                         "open-loop trace, streaming consumers, SLO "
                         "deadlines; reports SLO-goodput")
    ap.add_argument("--admission", choices=("greedy", "adaptive"),
                    default=None,
                    help="admission width policy (default: adaptive with "
                         "--frontend, greedy otherwise)")
    ap.add_argument("--rate-rps", type=float, default=40.0,
                    help="--frontend arrival rate (requests/s)")
    ap.add_argument("--max-queue", type=int, default=128,
                    help="--frontend bounded admission queue")
    ap.add_argument("--no-cal-cache", action="store_true",
                    help="do not persist T0/t_iter calibrations to disk")
    ap.add_argument("--explain-decisions", action="store_true",
                    help="dump the ExecutionModel decision trace")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts and "
                         "the --frontend trace")
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
    admission = args.admission or \
        ("adaptive" if args.frontend else "greedy")
    sched = ServeScheduler(cfg, params, n_slots=args.slots, max_len=max_len,
                           executor=executor,
                           dispatch_depth=parse_depth(args.dispatch_depth),
                           admission=admission, paged=args.paged,
                           page_size=parse_auto(args.page_size),
                           prefill_interleave=parse_auto(
                               args.prefill_interleave),
                           speculate=parse_auto(args.speculate, off_ok=True),
                           device=device)
    sched.warmup()
    if args.frontend:
        serve_frontend(sched, args)
        print_paged_stats(sched)
        finish(sched, cache, args)
        return

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
    print_paged_stats(sched)
    finish(sched, cache, args)


def finish(sched: ServeScheduler, cache: CalibrationCache, args) -> None:
    if args.explain_decisions:
        model = sched.decision_model()
        if model is not None:
            print(model.explain())
    if not args.no_cal_cache:
        cache.save()
        print(f"calibration cache: {cache.path} ({len(cache)} entries)")


if __name__ == "__main__":
    main()
