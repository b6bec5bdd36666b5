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
with SLO-goodput.  A cross-attention arch (llama-3.2-vision-11b) serves
through ``ServeEngine``'s lock-step batch path instead
(``serve_cross_attention``), with the batch's frontend features.  Runs
on the CUDA card unless ``--device cpu``.
``--kernel-autotune`` measures kernel 1's warps and kernels 2 and 3's
attention plans (``kernels/autotune.KernelTuner``, over the same store as
the acc calibrations) and prints the reference's ``kernel autotune: N
measured searches, M persisted winners reused``; a second process over
the same ``--cal-cache-dir`` searches nothing.
Calibrations persist under ``--cal-cache-dir`` unless ``--no-cal-cache``;
``--strict`` turns on strict mode (``core/strict.py``), and
``--print-launch-profile`` prints the serving process's environment as
shell ``export`` lines and exits:

    eval "$(PYTHONPATH=src python -m repro_torch.launch.serve --print-launch-profile)"

``--mesh DATA,MODEL`` serves on a mesh of ranks (``launch/mesh.py``):
``DATA`` data-parallel replicas of ``MODEL``-way tensor parallelism, one
process per rank under ``torchrun`` (NCCL on the cards, gloo with
``--device cpu``); ``--slots`` rounds up to a multiple of the replicas,
and only rank 0 prints.  Every arch the scheduler serves takes any model
extent: each block splits its heads or channels over 'model' where they
divide and runs whole where they do not (``launch/sharding.tp_plan``;
zamba2's Mamba2 heads, xlstm's mLSTM heads and sLSTM channels too).
``--speculate`` and ``--paged`` take any mesh.  ``--frontend`` replays
the same trace on every rank, rank 0 deciding which arrivals each tick
takes (``serve/frontend.py``), and a cross-attention arch runs the
lock-step batch on every rank's tensor-parallel block:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen3-0.6b --reduced --device cpu --mesh 2,2 --no-cal-cache
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
from ..core import strict
from ..core.calibration import CalibrationCache
from ..core.executor import SequentialExecutor
from ..core.model import ExecutionModel
from ..data import make_batch
from ..device import resolve_device
from ..models import lm
from ..serve import (ServeEngine, ServeFrontend, ServeScheduler, SLOModel,
                     heavy_tailed_trace, materialize, percentile)
from ..train.autotune import make_kernel_tuner


# The serving process's environment: (variable, value, why).  CUDA and
# PyTorch settings only; the JAX package's profile tunes XLA instead.
LAUNCH_PROFILE = (
    ("CUDA_MODULE_LOADING", "LAZY",
     "load each kernel at its first launch: the fused and paged paths "
     "use a few of the libraries' kernels, so start-up and context "
     "memory stay small"),
    ("CUBLAS_WORKSPACE_CONFIG", ":4096:8",
     "a fixed cuBLAS workspace: the decode graphs' GEMMs capture with the "
     "same workspace every time, and repeated runs give the same bits"),
    ("NVIDIA_TF32_OVERRIDE", "0",
     "keep float32 GEMMs in full float32 whatever a library defaults to: "
     "the f32 identity checks (contiguous == paged == speculative) need it"),
    ("CUDA_LAUNCH_BLOCKING", "0",
     "launches stay asynchronous: a debugging value of 1 would make every "
     "launch a host sync and undo the one-launch-per-step decode graphs"),
    ("OMP_NUM_THREADS", "1",
     "the scheduler's host work is one Python thread; more OpenMP threads "
     "only contend with the executor's workers for the host's cores"),
)


def print_launch_profile() -> None:
    for var, value, why in LAUNCH_PROFILE:
        print(f"export {var}={value}  # {why}")


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


def serve_cross_attention(cfg, params, args, executor,
                          device: torch.device,
                          tuner=None, mesh=None) -> torch.Tensor:
    """A cross-attention (VLM) arch carries per-request frontend features
    the scheduler does not model: ``--requests`` rows of ``--prompt-len``
    tokens and their features (``make_batch``, seed ``--seed``) go
    through the engine's lock-step batch path (with the measured kernel
    plans of ``tuner``, if given; on ``mesh`` every rank runs the whole
    batch on its tensor-parallel blocks, and only mesh rank 0 prints).
    Returns the tokens (B, new tokens)."""
    batch = make_batch(cfg, args.requests, args.prompt_len, kind="prefill",
                       seed=args.seed, device=device)
    engine = ServeEngine(cfg, params, batch=args.requests,
                         max_len=args.prompt_len + args.new_tokens + 1,
                         executor=executor, kernel_tuner=tuner,
                         mesh=mesh, device=device)
    t0 = time.monotonic()
    out = engine.generate(batch["tokens"], args.new_tokens,
                          frontend_feats=batch["frontend_feats"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    gen = int(out.shape[0] * out.shape[1])
    if not _leads(mesh):
        return out
    print(f"arch={cfg.name} (cross-attention: lock-step batch path) "
          f"requests={args.requests}")
    print(f"generated {gen} tokens in {dt:.2f}s ({gen / dt:.1f} tok/s)")
    print("sample:", out[0].tolist())
    return out


def _leads(mesh) -> bool:
    """Whether this process prints: off a mesh, or mesh rank 0."""
    return mesh is None or mesh.rank == mesh.leader


def serve_frontend(sched: ServeScheduler, args) -> ServeFrontend:
    """Async front-end replay: a seeded heavy-tailed open-loop trace with
    streaming consumers and per-request SLO deadlines — the mode whose
    headline is goodput, not throughput.  On a mesh every rank replays
    the same trace (its front end follows rank 0's arrivals) and only
    mesh rank 0 prints.  Returns the front end (its ``records``)."""
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
    if not _leads(sched.mesh):
        return frontend
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
    return frontend


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
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
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
    ap.add_argument("--cal-cache-dir", default=None,
                    help="calibration cache directory (default: "
                         "$REPRO_CAL_CACHE_DIR or ~/.cache/repro-torch-acc)")
    ap.add_argument("--kernel-autotune", action="store_true",
                    help="measured kernel plans (kernel 1's warps, the "
                         "attention kernels' split chunk or schedule), "
                         "searched once and kept in the calibration store")
    ap.add_argument("--strict", action="store_true",
                    help="strict mode (as REPRO_STRICT=1): a cache pool "
                         "read while a dispatch updates it raises, and the "
                         "serve tick raises on any implicit device->host "
                         "synchronisation")
    ap.add_argument("--print-launch-profile", action="store_true",
                    help="print the serving environment as shell export "
                         "lines and exit")
    ap.add_argument("--explain-decisions", action="store_true",
                    help="dump the ExecutionModel decision trace")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--mesh", default="off",
                    help="mesh-sharded serving under torchrun: "
                         "'DATA,MODEL' ranks (e.g. '2,2': 2 data-parallel "
                         "replicas x 2-way tensor parallel), or 'off' "
                         "(one device).  Slots round up to a multiple of "
                         "the replica count; the active lanes become a "
                         "serve_mesh_batch decision")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts and "
                         "the --frontend trace")
    args = ap.parse_args(argv)
    if args.strict:
        strict.enable()
    if args.print_launch_profile:
        print_launch_profile()
        return
    if args.arch is None:
        ap.error("--arch is required (unless --print-launch-profile)")

    device = resolve_device(args.device)
    mesh, n_slots, lead = None, args.slots, True
    if args.mesh.strip().lower() not in ("off", "none", ""):
        mesh, n_slots, lead = _serve_mesh(args, device)
        if mesh is None:            # this rank is outside the mesh
            _leave_mesh()
            return
        device = mesh.device
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(args.seed, cfg, device=device)
    cache = CalibrationCache() if args.no_cal_cache \
        else CalibrationCache.persistent(args.cal_cache_dir)
    acc = AdaptiveCoreChunk(cache=cache)
    executor = adaptive(SequentialExecutor(), acc)
    tuner = make_kernel_tuner(cache) if args.kernel_autotune else None
    if "cross_attn" in cfg.layer_kinds():
        serve_cross_attention(cfg, params, args, executor, device, tuner,
                              mesh=mesh)
        if lead:
            finish(None, cache, args, tuner)
        if mesh is not None:
            _leave_mesh()
        return
    max_len = args.prompt_len + args.new_tokens + 1
    admission = args.admission or \
        ("adaptive" if args.frontend else "greedy")
    sched = ServeScheduler(cfg, params, n_slots=n_slots, max_len=max_len,
                           executor=executor,
                           dispatch_depth=parse_depth(args.dispatch_depth),
                           admission=admission, paged=args.paged,
                           page_size=parse_auto(args.page_size),
                           prefill_interleave=parse_auto(
                               args.prefill_interleave),
                           speculate=parse_auto(args.speculate, off_ok=True),
                           kernel_tuner=tuner, mesh=mesh, device=device)
    sched.warmup()
    if args.frontend:
        serve_frontend(sched, args)
        if lead:
            print_paged_stats(sched)
            finish(sched, cache, args, tuner)
        if mesh is not None:
            _leave_mesh()
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
    if mesh is not None and not lead:
        _leave_mesh()
        return
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
    finish(sched, cache, args, tuner)
    if mesh is not None:
        _leave_mesh()


def _serve_mesh(args, device):
    """(mesh or None outside it, slots rounded up to the replicas,
    whether this rank prints): the job's process group from torchrun's
    environment, then the (data, model) serving mesh."""
    from .mesh import init_distributed, make_serve_mesh, n_data_replicas

    import torch.distributed as dist

    init_distributed(device)
    data, model_par = (int(x) for x in args.mesh.split(","))
    mesh = make_serve_mesh(data, model_par)
    lead = dist.get_rank() == 0
    if not mesh.contains:
        return None, args.slots, False
    reps = n_data_replicas(mesh)
    n_slots = args.slots
    if n_slots % reps:          # slot dim must split into replica groups
        n_slots = -(-n_slots // reps) * reps
        if lead:
            print(f"mesh: rounding --slots {args.slots} up to {n_slots} "
                  f"({reps} data replicas)")
    if lead:
        print(f"mesh {data}x{model_par} over {mesh.size} of "
              f"{dist.get_world_size()} {dist.get_backend()} ranks | "
              f"{reps} replicas x {n_slots // reps} slots")
    return mesh, n_slots, lead


def _leave_mesh() -> None:
    """Leave the job's process group (a local act: a rank outside the
    mesh leaves at once, the others when they are done)."""
    import torch.distributed as dist

    dist.destroy_process_group()


def finish(sched: ServeScheduler | None, cache: CalibrationCache,
           args, tuner=None) -> None:
    if tuner is not None:
        print(f"kernel autotune: {tuner.searches} measured searches, "
              f"{tuner.cache_hits} persisted winners reused")
    if args.explain_decisions:
        model = ExecutionModel.of(cache) if sched is None \
            else sched.decision_model()
        if model is not None:
            print(model.explain())
    if not args.no_cal_cache:
        cache.save()
        print(f"calibration cache: {cache.path} ({len(cache)} entries)")


if __name__ == "__main__":
    main()
