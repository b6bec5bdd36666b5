"""Request-level continuous-batching scheduler driven by the acc model
(the counterpart of ``repro.serve.scheduler``).

The paper's executor answers "how many cores, what chunk size?" for a
parallel loop from measured ``T0`` / ``t_iter``.  Re-read for serving,
the same decision is "how many requests advance this tick, what prefill
chunk?": the workload is the set of queued tokens (remaining prefill
plus one decode token per running request), and the Overhead-Law
decision over its ``WorkloadProfile`` yields the batching width and the
prefill chunk (snapped to a small bucket set).  With ``dispatch_depth``
set, decode runs through the fused loop (serve/decode_loop.py): up to
``k`` tokens per dispatch, the host one dispatch ahead of the card and
the emitted tokens drained later; ``k`` is an ExecutionModel decision
(``serve_dispatch_depth``) from the measured host overhead per tick and
the measured device time per token.

Ported from the JAX scheduler: admission (greedy, EDF, shedding,
cancellation), the per-tick decision, bucketed chunked prefill, both
decode paths, the depth decision and the drain.  Every timed thunk
synchronises the card (``device_sync``) where the reference called
``block_until_ready``; the drain's readiness probe is one CUDA event
recorded after each fused dispatch, and its tokens come back in one copy.

Not ported yet (ROADMAP.md): the paged pool, speculative decoding, mesh
serving, adaptive admission (the front end's mode) and measured kernel
blocks (``kernel_tuner``).  Passing any of them raises
``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import itertools
import time
from typing import Any, Callable, Sequence

import torch

from ..configs.base import ArchConfig
from ..core import overhead_law, strict
from ..core.acc import AdaptiveCoreChunk
from ..core.executor import Chunk, SequentialExecutor
from ..core.feedback import tag_workload
from ..core.future import Future, when_all
from ..core.model import DecisionKey, ExecutionModel, decision_overhead_s
from ..core.properties import params_of
from ..device import resolve_device
from ..models import lm
from ..train.autotune import serve_profiles
from .decode_loop import (DEFAULT_MAX_DEPTH, device_sync,
                          make_fused_decode_step, make_lane_step, to_host)
from .kv_cache import SlotKVCachePool, host_to_device

DEFAULT_CHUNK_BUCKETS = (8, 16, 32, 64, 128, 256)


class PromptTooLongError(ValueError):
    """A submitted prompt does not fit a cache slot."""

    def __init__(self, prompt_len: int, max_len: int):
        self.prompt_len = prompt_len
        self.max_len = max_len
        super().__init__(
            f"prompt of {prompt_len} tokens does not fit a "
            f"max_len={max_len} slot")


def percentile(xs, p: float) -> float:
    """Latency-report percentile; NaN on empty."""
    import numpy as np

    return float(np.percentile(np.asarray(xs), p)) if len(xs) else \
        float("nan")


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"    # caller withdrew the request mid-flight
    SHED = "shed"              # deadline expired before prefill: dropped


# States a request never leaves (its slot, if any, is back in the pool).
TERMINAL_STATES = (RequestState.DONE, RequestState.CANCELLED,
                   RequestState.SHED)


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle bookkeeping."""

    rid: int
    tokens: torch.Tensor            # (S,) long prompt, on the host
    max_new_tokens: int
    arrival: float
    deadline: float | None = None
    state: RequestState = RequestState.WAITING
    slot: int | None = None
    prefilled: int = 0              # prompt tokens already in the cache
    out: list[int] = dataclasses.field(default_factory=list)
    # Tokens dispatched to the card but not yet drained to ``out``.
    pending_out: int = 0
    first_token_at: float | None = None
    finished_at: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def remaining_prefill(self) -> int:
        return self.prompt_len - self.prefilled


@dataclasses.dataclass(frozen=True)
class TickRecord:
    """What one scheduler tick did (the determinism tests compare these)."""

    tick: int
    admitted: tuple[int, ...]
    prefill_ops: tuple[tuple[int, int], ...]   # (rid, tokens advanced)
    decoded: tuple[int, ...]
    finished: tuple[int, ...]
    queued_tokens: int
    n_cores: int
    chunk: int
    depth: int = 0       # fused dispatch depth (0: per-tick decode path)
    deadline_misses: int = 0
    queue_depth: int = 0
    dispatched_tokens: int = 0
    spec_depth: int = 0  # speculation is not ported: always 0


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md: {item})")


class ServeScheduler:
    """Continuous batching over a slot pool, acc-decided per tick."""

    def __init__(self, cfg: ArchConfig, params, *, n_slots: int,
                 max_len: int, window: int | None = None,
                 executor=None, acc: AdaptiveCoreChunk | None = None,
                 chunk_buckets: Sequence[int] = DEFAULT_CHUNK_BUCKETS,
                 clock: Callable[[], float] = time.monotonic,
                 kernel_tuner=None,
                 dispatch_depth: int | str | None = None,
                 max_dispatch_depth: int = DEFAULT_MAX_DEPTH,
                 pipeline: int = 2, sync_every: int = 8,
                 admission: str = "greedy",
                 shed_expired: bool = False, mesh=None,
                 paged: bool = False, page_size: int | str = "auto",
                 prefill_interleave: int | str = "auto",
                 speculate: int | str | None = None,
                 max_spec_depth: int = 8,
                 spec_history: int = 64,
                 device: str | torch.device = "cuda"):
        if paged:
            raise _not_ported("the paged KV pool", "next slice, paged pool "
                              "+ paged_flash_attention + speculation")
        if speculate is not None:
            raise _not_ported("speculative decoding", "next slice, paged "
                              "pool + paged_flash_attention + speculation")
        if mesh is not None:
            raise _not_ported("mesh-sharded serving", "multi-GPU")
        if kernel_tuner is not None:
            raise _not_ported("measured kernel blocks (kernel_tuner)",
                              "tooling")
        if admission == "adaptive":
            raise _not_ported("adaptive admission", "serve front end")
        if admission != "greedy":
            raise ValueError(
                f"admission must be 'greedy' or 'adaptive', "
                f"got {admission!r}")
        lm.check_ported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.window = window if window is not None else cfg.attn_window
        if self.window is not None and self.window <= 0:
            self.window = None
        self.max_len = max_len
        self.executor = executor if executor is not None \
            else SequentialExecutor()
        self.acc = acc or params_of(self.executor) or AdaptiveCoreChunk()
        self.clock = clock
        self.chunk_buckets = tuple(sorted(set(int(b) for b in chunk_buckets
                                              if b > 0))) or (max_len,)
        # Padding prefill chunks to a bucket is sound only when every
        # layer masks by position (no window, attention blocks only).
        self._pad_ok = self.window is None
        self.prefill_profile, self.decode_profile = serve_profiles(cfg)
        # Workload keys carry the model's shape, not just its name.
        sig = (cfg.name, cfg.d_model, cfg.n_layers)
        self.prefill_key = ("serve_prefill",) + sig
        self.decode_key = ("serve_decode",) + sig
        self.pool = SlotKVCachePool(cfg, n_slots, max_len,
                                    window=self.window, device=self.device)
        self.tick_key = DecisionKey("serve_tick", sig)
        if isinstance(dispatch_depth, str):
            if dispatch_depth != "auto":
                raise ValueError(
                    f"dispatch_depth must be None, an int, or 'auto'; "
                    f"got {dispatch_depth!r}")
        elif dispatch_depth is not None:
            dispatch_depth = max(int(dispatch_depth), 1)
        self.dispatch_depth = dispatch_depth
        self._fused = dispatch_depth is not None
        self.max_dispatch_depth = max(int(max_dispatch_depth), 1)
        self.pipeline = max(int(pipeline), 1)
        self.sync_every = max(int(sync_every), 1)
        self.depth_key = DecisionKey("serve_dispatch_depth", sig)
        self.shed_expired = bool(shed_expired)
        self.deadline_misses = 0    # sheds + late finishes
        self.shed = 0               # expired before prefill, dropped
        self.cancelled = 0          # withdrawn by the caller mid-flight
        self._tick_misses = 0
        self._queue_depth = 0
        # Timing keys for the depth decision's two inputs (both refined
        # online): seconds of host work per tick, seconds of device
        # work per fused-decoded token.
        self.host_tick_key = ("serve_host_tick",) + sig
        self.fused_key = ("serve_decode_fused",) + sig
        self._fused_fn = None
        self._warm_fused = False
        self._dev_toks: torch.Tensor | None = None
        self._tok_overrides: dict[int, int] = {}
        # In-flight fused dispatches: (out_buf, ready_event, lanes).
        self._inflight: collections.deque = collections.deque()
        self.decode_dispatches = 0
        self.decode_tokens = 0
        self.decode_loop_iters = 0
        self.host_roundtrips = 0
        self.host_overhead_s = 0.0
        self._blocked_s = 0.0
        self._rid = itertools.count()
        self._waiting: list[Request] = []
        self._active: list[Request] = []
        self.requests: dict[int, Request] = {}
        self.trace: list[TickRecord] = []
        self._tick = 0
        self._lanes = make_lane_step(cfg, window=self.window)
        # Shapes that have run once: a cold call pays cuBLAS and kernel
        # set-up, which must never be recorded as t_iter.
        self._warm_prefill: set[int] = set()
        self._warm_decode = False

    # ------------------------------------------------------------------ API
    def submit(self, tokens, max_new_tokens: int = 16, *,
               deadline: float | None = None,
               arrival: float | None = None) -> int:
        """Enqueue a request; returns its id.  ``tokens`` is a 1-D prompt
        (list, numpy array or tensor); it is kept on the host."""
        tokens = torch.as_tensor(tokens).to("cpu", torch.long).reshape(-1)
        if tokens.shape[0] == 0:
            raise ValueError("empty prompt")
        if tokens.shape[0] >= self.max_len:
            raise PromptTooLongError(int(tokens.shape[0]), self.max_len)
        rid = next(self._rid)
        req = Request(rid=rid, tokens=tokens,
                      max_new_tokens=max(int(max_new_tokens), 1),
                      arrival=self.clock() if arrival is None else arrival,
                      deadline=deadline)
        self.requests[rid] = req
        self._waiting.append(req)
        return rid

    @property
    def pending(self) -> int:
        """Requests not yet finished (waiting + running)."""
        return len(self._waiting) + len(self._active)

    def cancel(self, rid: int) -> bool:
        """Withdraw a request mid-flight; its slot goes straight back to
        the free list and undrained tokens are dropped at drain time."""
        req = self.requests.get(rid)
        if req is None or req.state in TERMINAL_STATES:
            return False
        if req.state is RequestState.WAITING:
            self._waiting.remove(req)
        else:
            self._active.remove(req)
            if req.slot is not None:
                self._tok_overrides.pop(req.slot, None)
                self.pool.release(req.slot)
                req.slot = None
        req.state = RequestState.CANCELLED
        req.finished_at = self.clock()
        self.cancelled += 1
        return True

    def decision_model(self) -> ExecutionModel | None:
        """The ExecutionModel behind this scheduler's decisions (None when
        the params object carries no calibration cache)."""
        cache = getattr(self.acc, "cache", None)
        return ExecutionModel.of(cache) if cache is not None else None

    def results(self) -> dict[int, list[int]]:
        self.flush()
        return {rid: list(r.out) for rid, r in self.requests.items()
                if r.state is RequestState.DONE}

    def clear_finished(self) -> None:
        """Drop completed requests and the tick trace."""
        self.flush()
        self.requests = {rid: r for rid, r in self.requests.items()
                         if r.state not in TERMINAL_STATES}
        self.trace.clear()

    def run_until_idle(self, max_ticks: int = 100_000) -> dict[int, list[int]]:
        for _ in range(max_ticks):
            if not self.pending:
                return self.results()
            self.tick()
        raise RuntimeError(f"scheduler did not drain in {max_ticks} ticks")

    def warmup(self) -> None:
        """Run every shape the steady-state tick touches once (the decode
        step, the prefill buckets, the kernels' first build and launch)
        into free slot 0, so the first timed tick measures compute."""
        if self.pool.free_slots() != self.pool.n_slots:
            raise RuntimeError("warmup must precede admission")
        zeros = torch.zeros(self.pool.n_slots, dtype=torch.long,
                            device=self.device)
        if self._fused:
            new_caches, _out, toks = self._fused_step()(
                self.params, self.pool.caches, zeros,
                self.pool.positions_array(), [1] + [0] * (
                    self.pool.n_slots - 1))
            self.pool.mark_donated("fused decode warmup")
            device_sync(self.device)
            self.pool.adopt(new_caches)
            self._dev_toks = toks
            self._warm_fused = True
        else:
            self._lanes(self.params, self.pool.caches, zeros,
                        self.pool.positions_array())
            device_sync(self.device)
            self._warm_decode = True
        if self._pad_ok:
            for b in self.chunk_buckets:
                if b < self.max_len:
                    row = self.pool.read_slot(0)
                    lm.forward_cached(
                        self.params, torch.zeros((1, b), dtype=torch.long,
                                                 device=self.device),
                        row, 0, self.cfg, window=self.window,
                        logit_index=b - 1)
                    self.pool.write_slot(0, row)
                    self._warm_prefill.add(b)
            device_sync(self.device)

    # ----------------------------------------------------------------- tick
    def tick(self) -> TickRecord:
        """One scheduler round: admit → decide → prefill chunks → decode.

        The wall-clock of everything that is not a device wait is
        accumulated as ``host_overhead_s`` — the per-dispatch T0 the
        fused path amortises — and, on clean fused decode-only ticks,
        folded into the calibration store (``serve_host_tick``).  Under
        strict mode any implicit device→host sync in the round raises.
        """
        with strict.hot_dispatch_guard():
            t_start = time.perf_counter()
            self._blocked_s = 0.0
            self._tick_misses = 0
            was_warm = self._warm_fused
            rec = self._tick_fused() if self._fused else self._tick_legacy()
            host_s = max(
                time.perf_counter() - t_start - self._blocked_s, 0.0)
            self.host_overhead_s += host_s
            if self._fused and was_warm and rec.decoded \
                    and not rec.prefill_ops:
                model = self.decision_model()
                if model is not None:
                    model.observe(self.host_tick_key, 1, host_s)
            return rec

    def _tick_legacy(self) -> TickRecord:
        """Per-tick decode: one device round-trip per decoded token."""
        admitted = self._admit()
        queued, cores, chunk = self._decide()
        prefill_ops, pf_finished = self._run_prefill(cores, chunk)
        decoded, dec_finished = self._run_decode()
        finished = pf_finished + dec_finished
        self._active = [r for r in self._active
                        if r.state is not RequestState.DONE]
        rec = TickRecord(
            tick=self._tick, admitted=tuple(admitted),
            prefill_ops=tuple(prefill_ops), decoded=tuple(decoded),
            finished=tuple(finished), queued_tokens=queued,
            n_cores=cores, chunk=chunk,
            deadline_misses=self._tick_misses,
            queue_depth=self._queue_depth)
        self.trace.append(rec)
        self._tick += 1
        return rec

    def _tick_fused(self) -> TickRecord:
        """Fused decode: harvest finished dispatches, admit, prefill, then
        dispatch the next fused decode without waiting for it."""
        self._drain(drop_to=self.pipeline - 1, harvest=True)
        admitted = self._admit()
        pf_pending = any(r.state is RequestState.PREFILL
                         for r in self._active)
        n_dec = sum(1 for r in self._active
                    if r.state is RequestState.DECODE)
        if pf_pending:
            queued, cores, chunk = self._decide()
            prefill_ops, pf_finished = self._run_prefill(cores, chunk)
        else:
            queued = n_dec
            cores, chunk = 0, 0
            prefill_ops, pf_finished = [], []
        decoded, dec_finished, depth, disp_toks = self._dispatch_decode()
        finished = pf_finished + dec_finished
        self._active = [r for r in self._active
                        if r.state is not RequestState.DONE]
        if not self._active and not self._waiting:
            self.flush()
        rec = TickRecord(
            tick=self._tick, admitted=tuple(admitted),
            prefill_ops=tuple(prefill_ops), decoded=tuple(decoded),
            finished=tuple(finished), queued_tokens=queued,
            n_cores=cores, chunk=chunk, depth=depth,
            deadline_misses=self._tick_misses,
            queue_depth=self._queue_depth,
            dispatched_tokens=disp_toks)
        self.trace.append(rec)
        self._tick += 1
        return rec

    def _admit(self) -> list[int]:
        """Earliest-deadline-first admission into free slots; FIFO among
        requests without deadlines.  With ``shed_expired``, a waiting
        request whose deadline has passed is shed before prefill."""
        if self.shed_expired and self._waiting:
            now = self.clock()
            kept = []
            for req in self._waiting:
                if req.deadline is not None and now > req.deadline:
                    req.state = RequestState.SHED
                    req.finished_at = now
                    self.shed += 1
                    self.deadline_misses += 1
                    self._tick_misses += 1
                else:
                    kept.append(req)
            self._waiting = kept
        self._waiting.sort(key=lambda r: (
            r.deadline if r.deadline is not None else float("inf"),
            r.arrival, r.rid))
        admitted = []
        while self._waiting and self.pool.free_slots():
            req = self._waiting.pop(0)
            req.slot = self.pool.acquire(req.rid)
            req.state = RequestState.PREFILL
            self._active.append(req)
            admitted.append(req.rid)
        self._queue_depth = len(self._waiting)
        return admitted

    def _decide(self) -> tuple[int, int, int]:
        """(queued tokens, batch width, prefill chunk) for this tick,
        through the customization points (see the reference)."""
        pf_tokens = sum(r.remaining_prefill for r in self._active
                        if r.state is RequestState.PREFILL)
        dec_tokens = sum(1 for r in self._active
                         if r.state is RequestState.DECODE)
        queued = pf_tokens + dec_tokens
        if queued <= 0:
            return 0, 0, 0
        t_pf = self.acc.measure_iteration(
            self.executor, self.prefill_profile, max(pf_tokens, 1),
            key=self.prefill_key)
        t_dec = self.acc.measure_iteration(
            self.executor, self.decode_profile, max(dec_tokens, 1),
            key=self.decode_key)
        t_iter = (pf_tokens * t_pf + dec_tokens * t_dec) / queued
        if hasattr(self.acc, "decide"):
            d = self.acc.decide(self.executor, t_iter, queued,
                                key=self.tick_key,
                                evidence=(self.prefill_key,
                                          self.decode_key))
            cores, chunk = d.n_cores, d.chunk_elems
        else:
            cores = self.acc.processing_units_count(self.executor, t_iter,
                                                    queued)
            chunk = self.acc.get_chunk_size(self.executor, t_iter, cores,
                                            queued)
        return queued, max(cores, 1), max(chunk, 1)

    # -- prefill -------------------------------------------------------------
    def _bucket(self, step: int) -> int:
        """Smallest bucket >= step; steps above the largest are clamped."""
        for b in self.chunk_buckets:
            if b >= step:
                return b
        return self.chunk_buckets[-1]

    def _segment(self, req: Request, chunk: int) -> int:
        """Next prefill piece: the decided chunk, clamped to the remaining
        prompt and the largest bucket."""
        return min(max(chunk, 1), req.remaining_prefill,
                   self.chunk_buckets[-1])

    def _run_prefill(self, cores: int, chunk: int):
        ready = [r for r in self._active if r.state is RequestState.PREFILL]
        if not ready or chunk <= 0:
            return [], []
        width = min(max(cores, 1), len(ready))
        ops = []
        for req in ready[:width]:
            step = self._segment(req, chunk)
            padded = self._bucket(step) if self._pad_ok else step
            if padded > self.max_len - req.prefilled:
                padded = step    # no room to pad: exact-size chunk
            ops.append((req, step, padded))

        pool, params, cfg, dev = self.pool, self.params, self.cfg, self.device

        def run_chunk(chunk: Chunk):
            req, step, padded = ops[chunk.start]
            piece = torch.zeros(padded, dtype=torch.long)
            piece[:step] = req.tokens[req.prefilled:req.prefilled + step]
            row = pool.read_slot(req.slot)
            logits, _ = lm.forward_cached(
                params, piece.to(dev, non_blocking=True)[None], row,
                req.prefilled, cfg, window=self.window,
                logit_index=step - 1)
            # Synchronise inside the thunk: the executor times this call
            # for the feedback loop.
            device_sync(dev)
            return logits, row

        if all(padded in self._warm_prefill for _, _, padded in ops):
            tag_workload(run_chunk, self.prefill_key)
        t_dev = time.perf_counter()
        futs = self.executor.bulk_async_execute(
            run_chunk, [Chunk(i, step) for i, (_, step, _) in enumerate(ops)])
        outs = when_all(futs).result()
        self._blocked_s += time.perf_counter() - t_dev
        self.host_roundtrips += 1
        self._warm_prefill.update(padded for _, _, padded in ops)

        prefill_ops, finished = [], []
        for (req, step, _), (logits, new_row) in zip(ops, outs, strict=True):
            self.pool.write_slot(req.slot, new_row)
            req.prefilled += step
            self.pool.positions[req.slot] = req.prefilled
            prefill_ops.append((req.rid, step))
            if req.remaining_prefill == 0:
                # First-token sync: the host needs this token to route
                # the request into decode.
                tok = to_host(torch.argmax(logits[0, 0])).tolist()
                req.out.append(tok)
                req.first_token_at = self.clock()
                req.state = RequestState.DECODE
                if len(req.out) >= req.max_new_tokens:
                    self._finish(req)
                    finished.append(req.rid)
                elif self._fused:
                    self._tok_overrides[req.slot] = tok
        return prefill_ops, finished

    # -- decode (per-tick path) ---------------------------------------------
    def _run_decode(self):
        decs = [r for r in self._active if r.state is RequestState.DECODE]
        if not decs:
            return [], []
        n = self.pool.n_slots
        toks = [0] * n
        for r in decs:
            toks[r.slot] = r.out[-1]
        active = sorted(r.slot for r in decs)
        pool, params, dev = self.pool, self.params, self.device
        toks_a = host_to_device(toks, torch.long, dev)
        poss_a = pool.positions_array()
        rows = None if len(active) == n \
            else host_to_device(active, torch.long, dev)

        def run_decode(_):
            next_toks = self._lanes(params, pool.caches, toks_a, poss_a,
                                    rows)
            device_sync(dev)
            return next_toks

        if self._warm_decode:
            tag_workload(run_decode, self.decode_key, elems=len(decs))
        t_dev = time.perf_counter()
        fut = self.executor.then_execute(run_decode, Future.ready(None))
        self._warm_decode = True
        next_toks = to_host(fut.result()).tolist()
        self._blocked_s += time.perf_counter() - t_dev
        self.decode_dispatches += 1
        self.decode_tokens += len(decs)
        self.decode_loop_iters += 1
        self.host_roundtrips += 2   # sync + copy

        decoded, finished = [], []
        for r in decs:
            self.pool.positions[r.slot] += 1
            r.out.append(next_toks[r.slot])
            decoded.append(r.rid)
            if len(r.out) >= r.max_new_tokens \
                    or self.pool.positions[r.slot] >= self.max_len:
                self._finish(r)
                finished.append(r.rid)
        return decoded, finished

    # -- decode (fused path) -------------------------------------------------
    def _fused_step(self):
        if self._fused_fn is None:
            self._fused_fn = make_fused_decode_step(
                self.cfg, window=self.window,
                max_depth=self.max_dispatch_depth)
        return self._fused_fn

    def _decode_toks(self) -> torch.Tensor:
        """The device-resident last-token carry, with host-known updates
        (prefill-emitted first tokens) spliced in."""
        if self._dev_toks is None:
            self._dev_toks = torch.zeros(self.pool.n_slots, dtype=torch.long,
                                         device=self.device)
        if self._tok_overrides:
            n = self.pool.n_slots
            mask = [False] * n
            vals = [0] * n
            for slot, tok in self._tok_overrides.items():
                mask[slot] = True
                vals[slot] = tok
            self._dev_toks = torch.where(
                host_to_device(mask, torch.bool, self.device),
                host_to_device(vals, torch.long, self.device),
                self._dev_toks)
            self._tok_overrides.clear()
        return self._dev_toks

    def _decide_depth(self, decs) -> int:
        """Tokens per dispatch for this tick — the ``serve_dispatch_depth``
        decision (fixed depths are traced as such)."""
        model = self.decision_model()
        if self.dispatch_depth != "auto":
            depth = min(self.dispatch_depth, self.max_dispatch_depth)
            if model is not None:
                model.note(self.depth_key, policy="fixed-depth",
                           cores=1, chunk=depth,
                           inputs=(("fixed", True),))
            return depth
        if model is None:     # static params object: no store to consult
            return min(8, self.max_dispatch_depth)
        evidence = [self.host_tick_key, self.fused_key]
        inputs: tuple = ()
        host = model.smoothed_t_iter(self.host_tick_key)
        if host is None:
            t0 = self.acc.calibrate_t0(self.executor)
            host = t0 + 4.0 * decision_overhead_s()
            inputs = (("seeded", True),)
        dev = model.smoothed_t_iter(self.fused_key)
        if dev is None:
            dev = self.acc.measure_iteration(
                self.executor, self.decode_profile, max(len(decs), 1),
                key=self.decode_key)
            evidence.append(self.decode_key)
        decision = model.dispatch_depth(
            self.depth_key, host_overhead_s=host, device_step_s=dev,
            max_depth=self.max_dispatch_depth,
            eff=getattr(self.acc, "efficiency",
                        overhead_law.DEFAULT_EFFICIENCY),
            evidence=tuple(evidence), inputs=inputs)
        return decision.chunk

    def _dispatch_decode(self):
        """Dispatch one fused decode step (no sync): every DECODE slot
        advances by up to the decided depth, clamped to its remaining
        budget and cache room; the tokens land later via ``_drain``."""
        decs = [r for r in self._active if r.state is RequestState.DECODE]
        if not decs:
            return [], [], 0, 0
        depth = self._decide_depth(decs)
        steps = [0] * self.pool.n_slots
        lanes = []
        for r in decs:
            budget = min(r.max_new_tokens - len(r.out) - r.pending_out,
                         self.max_len - self.pool.positions[r.slot])
            take = max(min(depth, budget), 0)
            steps[r.slot] = take
            lanes.append((r, r.slot, take))
        toks_a = self._decode_toks()
        poss_a = self.pool.positions_array()
        fused = self._fused_step()
        # Periodic synced dispatch: the only honest wall-clock of the
        # device step is one with an empty pipeline around it.
        timed = self._warm_fused and \
            self.decode_dispatches % self.sync_every == 0
        if timed:
            self._drain(drop_to=0)
        t_dev = time.perf_counter()
        new_caches, out_buf, final_toks = fused(
            self.params, self.pool.caches, toks_a, poss_a, steps)
        self.pool.mark_donated("fused decode dispatch")
        total = sum(take for _, _, take in lanes)
        if timed:
            device_sync(self.device)
            dt = time.perf_counter() - t_dev
            self._blocked_s += dt
            self.host_roundtrips += 1
            model = self.decision_model()
            if model is not None and total > 0:
                model.observe(self.fused_key, total, dt)
        self._warm_fused = True
        self.pool.adopt(new_caches)
        self._dev_toks = final_toks
        self.decode_dispatches += 1
        self.decode_tokens += total
        self.decode_loop_iters += max((take for _, _, take in lanes),
                                      default=0)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._inflight.append((out_buf, ready, lanes))

        decoded, finished = [], []
        for r, slot, take in lanes:
            self.pool.advance(slot, take)
            r.pending_out += take
            decoded.append(r.rid)
            if len(r.out) + r.pending_out >= r.max_new_tokens \
                    or self.pool.positions[slot] >= self.max_len:
                self._finish(r)
                finished.append(r.rid)
        return decoded, finished, depth, total

    def _drain(self, drop_to: int | None = None,
               harvest: bool = False) -> None:
        """Land emitted tokens from finished fused dispatches.

        ``drop_to=N`` blocks until at most ``N`` dispatches remain in
        flight; ``harvest`` additionally pops any dispatch whose event
        has completed, without blocking.  One copy per dispatch."""
        while self._inflight:
            must = drop_to is not None and len(self._inflight) > drop_to
            if not must:
                if not harvest:
                    break
                ready = self._inflight[0][1]
                if ready is not None and not ready.query():
                    break
            out_buf, _, lanes = self._inflight.popleft()
            t_dev = time.perf_counter()
            toks = to_host(out_buf).tolist()
            if must:
                self._blocked_s += time.perf_counter() - t_dev
            self.host_roundtrips += 1
            for req, slot, take in lanes:
                req.pending_out -= take
                if req.state is RequestState.CANCELLED:
                    continue
                req.out.extend(toks[j][slot] for j in range(take))
                if req.state is RequestState.DONE \
                        and req.pending_out <= 0 \
                        and req.finished_at is None:
                    req.out = req.out[:req.max_new_tokens]
                    self._stamp_finished(req)

    def flush(self) -> None:
        """Block until every in-flight fused dispatch has drained."""
        self._drain(drop_to=0)

    def _finish(self, req: Request) -> None:
        req.state = RequestState.DONE
        self.pool.release(req.slot)
        if req.pending_out <= 0:
            req.out = req.out[:req.max_new_tokens]
            self._stamp_finished(req)

    def _stamp_finished(self, req: Request) -> None:
        req.finished_at = self.clock()
        if req.deadline is not None and req.finished_at > req.deadline:
            self.deadline_misses += 1
            self._tick_misses += 1
