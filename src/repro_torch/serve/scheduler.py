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
the measured device time per token.  On the card every decode step —
fused, speculative, or the per-tick path's single step — is one replay
of a CUDA graph (serve/graphs.py), captured in ``warmup``.

With ``paged=True`` the KV lives in a ``PagedKVCachePool``: the page
size is a ``serve_page_size`` decision at construction, a prompt whose
prefix is cached maps its pages read-only and prefills only past them,
every write range is made exclusively writable (copy-on-write) before a
prefill wave or a dispatch, and the prefill chunk-ops of a tick that
also decodes are capped by a ``serve_prefill_interleave`` decision.
Every attention then runs through the paged kernel (under the
"head_dim" split over 'model', through the page table in plain ops).
With ``speculate`` decode drafts from each lane's history and verifies
``d`` tokens per round (``serve_spec_depth``, refined from the
acceptance the drains observe).  With ``admission="adaptive"`` the
number of requests admitted per tick is a ``serve_admission`` decision
(the front end's mode).
Under a sliding window (h2o-danube-1.8b) the slot pool's caches are
rings (``models/attention.py``): a prefill chunk never crosses the
ring's end and is never padded, and the paged pool and speculation
refuse the window, as the reference's do.

Ported from the JAX scheduler: admission (greedy, adaptive, EDF,
shedding, cancellation), the per-tick decision, bucketed chunked
prefill, both decode paths, the paged pool and prefix reuse,
speculation, the depth, page-size, interleave, spec-depth and admission
decisions and the drain.  Every timed thunk synchronises the card
(``device_sync``) where the reference called ``block_until_ready``; the
drain's readiness probe is one CUDA event recorded after each fused
dispatch, and its tokens come back in one copy.

A ``kernel_tuner`` (``kernels/autotune.KernelTuner``) applies around
every tick (``models.flags.kernel_tuner``): kernel 1's warps and
kernels 2 and 3's attention plans are then measured on the served
calls themselves, resolved before each graph capture and held in the
tuner's store.  ``warmup`` measures the prefill buckets; a decode step
keeps its analytic plans until its first dispatch over a full pool,
which measures them on those lanes and captures the step anew.
``decode_cost_analysis`` counts one decode-loop iteration of the live
step (``analysis/roofline.py``).

With ``mesh`` (``launch.mesh.make_serve_mesh(data, model)``) every rank
of the mesh runs this scheduler (SPMD) on the same requests: the weights
are its tensor-parallel block (``launch/sharding.serve_param_specs``,
the forward under ``models.flags.tensor_parallel``), the pool holds its
replica's slot group (``pool.lanes``) and each dispatch runs those lanes
only; the emitted tokens are all-gathered over 'data' after every
dispatch, a prefill wave's first tokens all-reduced, and a paged
replica's new K/V rows exchanged (``PagedKVCachePool.exchange_rows``),
so every rank's request state stays the same.  Every decision that
reads a timing or the clock is taken on mesh rank 0 and broadcast
(``_agree``), and every rank's trace records it; a mesh run also decides
``serve_mesh_batch``, the active-lane cap (``_decide_mesh_batch``).
Prefill chunk-ops run in order (their collectives must meet).  Under
speculation each replica runs the verify rounds its own lanes need; a
lane still emits exactly its budget, so the host bookkeeping needs no
read, and the history ring and the rounds, verifies and tokens are
gathered over 'data' with the tokens (``_gather_stats``).  The
attention blocks lie over 'model' by the serving plan's rule
(``sharding.tp_plan``, cached: "split", "kv_shared", "head_dim" or
"whole"; ``force_attn`` names one for tests), in either pool.
``decode_cost_analysis`` counts this rank's step and its collectives.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import itertools
import time
from typing import Any, Callable, Sequence

import torch

from ..collectives import all_gather_into, all_reduce
from ..configs.base import ArchConfig
from ..core import overhead_law, strict
from ..core.acc import AdaptiveCoreChunk
from ..core.executor import Chunk, SequentialExecutor
from ..core.feedback import tag_workload
from ..core.future import Future, when_all
from ..core.model import (DEFAULT_SPEC_ACCEPT, DecisionKey, ExecutionModel,
                          decision_overhead_s, hardware_key)
from ..core.properties import params_of
from ..device import resolve_device
from ..kernels import build
from ..models import flags, lm
from ..train.autotune import serve_profiles
from .decode_loop import (DEFAULT_MAX_DEPTH, DEFAULT_SPEC_HISTORY,
                          SPEC_DEPTH_CANDIDATES, _check_spec_arch,
                          device_sync, make_fused_decode_step,
                          make_paged_decode_step, make_paged_spec_decode_step,
                          make_spec_decode_step, to_host)
from .graphs import DecodeGraphs, StepState
from .kv_cache import (PagedKVCachePool, SlotKVCachePool, host_to_device,
                       refuse_cross_attention, serve_mesh_replicas)

DEFAULT_PAGE_CANDIDATES = (8, 16, 32, 64)

DEFAULT_CHUNK_BUCKETS = (8, 16, 32, 64, 128, 256)

# Under ``speculate="auto"``, depth 1 would be absorbing: no spec
# dispatches run, so the acceptance EMA could never move.  Every this-many
# dispatches while parked at depth 1, one window runs at width 2 as an
# exploration probe (token-identical like any spec step).
SPEC_PROBE_EVERY = 16


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
    # The prompt as a tuple of ints: the paged pool's prefix-cache key
    # and the speculation history's seed (set when either is on).
    host_tokens: tuple | None = None

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
    # Tokens this tick's dispatch carried (under speculation a round
    # emits a variable count, so it is recorded, not inferred), and the
    # speculation width it ran with (0: speculation off).
    dispatched_tokens: int = 0
    spec_depth: int = 0


class ServeScheduler:
    """Continuous batching over a slot or page pool, acc-decided per
    tick."""

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
                 spec_history: int = DEFAULT_SPEC_HISTORY,
                 device: str | torch.device = "cuda",
                 force_attn: str | None = None):
        refuse_cross_attention(cfg, "ServeScheduler")
        if admission not in ("greedy", "adaptive"):
            raise ValueError(
                f"admission must be 'greedy' or 'adaptive', "
                f"got {admission!r}")
        lm.check_ported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        # Mesh-sharded serving: this rank's tensor-parallel weights, its
        # replica's slot group in the pool (see the module docstring).
        self.mesh = mesh
        self.n_replicas = 1
        self.mesh_desc = None
        self.tp = None
        if mesh is not None:
            from ..launch import sharding

            self.n_replicas = serve_mesh_replicas(mesh, n_slots)
            self.mesh_desc = "x".join(
                str(mesh.shape[a]) for a in mesh.axis_names)
            self.tp = sharding.tensor_parallel(cfg, mesh, cached=True,
                                               force_attn=force_attn)
            self.params = sharding.local_tree(
                params, sharding.serve_param_specs(
                    cfg, params, mesh, force_attn=force_attn), mesh)
        self.slots_per_replica = n_slots // self.n_replicas
        self.kernel_tuner = kernel_tuner
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
        # layer masks by position: a recurrent state would absorb the pad
        # tokens, and under a window the pad rows would land in the ring.
        # Those archs run exact-size chunks.
        self._pad_ok = self.window is None and \
            set(cfg.layer_kinds()) <= {"attn", "shared_attn"}
        self.prefill_profile, self.decode_profile = serve_profiles(cfg)
        # Workload keys carry the model's shape, not just its name.
        sig = (cfg.name, cfg.d_model, cfg.n_layers)
        self.prefill_key = ("serve_prefill",) + sig
        self.decode_key = ("serve_decode",) + sig
        # Paged pool: the page size is decided at construction
        # (``serve_page_size``) and re-decided on timed syncs as the run
        # observes page-management and prefill costs (the refined choice
        # drives the next pool over this store); the prefill/decode
        # interleave (``serve_prefill_interleave``) is decided per tick.
        self.paged = bool(paged)
        self.page_size_key = DecisionKey("serve_page_size", sig)
        self.interleave_key = DecisionKey("serve_prefill_interleave", sig)
        self.page_mgmt_key = ("serve_page_mgmt",) + sig
        if isinstance(prefill_interleave, str):
            if prefill_interleave != "auto":
                raise ValueError(
                    f"prefill_interleave must be an int or 'auto'; "
                    f"got {prefill_interleave!r}")
        else:
            prefill_interleave = max(int(prefill_interleave), 1)
        self.prefill_interleave = prefill_interleave
        # Seconds the tick blocked on prefill chunks while decode lanes
        # were active with no fused dispatch in flight to hide behind —
        # the stall the interleave decision minimises.
        self.prefill_stall_s = 0.0
        self._last_depth = 0
        self._page_size_auto = self.paged and page_size == "auto"
        if self.paged:
            if dispatch_depth is None:
                raise ValueError(
                    "paged serving requires the fused decode path: "
                    "pass dispatch_depth (an int or 'auto')")
            if isinstance(page_size, str):
                if page_size != "auto":
                    raise ValueError(
                        f"page_size must be an int or 'auto'; "
                        f"got {page_size!r}")
                ps = self._agree(self._decide_page_size)
            else:
                ps = max(int(page_size), 1)
                model = self.decision_model()
                if model is not None:
                    model.note(self.page_size_key,
                               policy="fixed-page-size", cores=1,
                               chunk=ps, inputs=(("fixed", True),))
            self.pool: Any = PagedKVCachePool(
                cfg, n_slots, max_len, window=self.window, page_size=ps,
                mesh=mesh, device=self.device, force_attn=force_attn)
        else:
            self.pool = SlotKVCachePool(cfg, n_slots, max_len,
                                        window=self.window, mesh=mesh,
                                        device=self.device,
                                        force_attn=force_attn)
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
        # Self-speculative decoding: ``speculate`` is None (off), an int
        # (fixed draft window) or "auto" (``serve_spec_depth``: analytic
        # prior, refined from the acceptance the drains observe, backing
        # off to depth 1 when acceptance collapses).  It rides the fused
        # path; rollback is position bookkeeping only under
        # position-masked attention (``_check_spec_arch``).
        if isinstance(speculate, str):
            if speculate != "auto":
                raise ValueError(
                    f"speculate must be None, an int, or 'auto'; "
                    f"got {speculate!r}")
        elif speculate is not None:
            speculate = max(int(speculate), 1)
        self.speculate = speculate
        self._spec = speculate is not None
        if self._spec:
            if dispatch_depth is None:
                raise ValueError(
                    "speculative decoding rides the fused decode path: "
                    "pass dispatch_depth (an int or 'auto')")
            _check_spec_arch(cfg, self.window)
        self.max_spec_depth = max(int(max_spec_depth), 1)
        self.spec_history = max(int(spec_history), 8)
        self.spec_depth_key = DecisionKey("serve_spec_depth", sig)
        # Acceptance EMA: each drained spec dispatch contributes the
        # acceptance rate recovered at its own width (elems = verifies,
        # "seconds" = accept x verifies, so the per-element ratio is the
        # acceptance itself); plus seconds per speculative round and the
        # clean width-1 seconds per iteration, whose ratio prices the
        # verify width online.
        self.spec_accept_key = ("serve_spec_accept",) + sig
        self.spec_step_key = ("serve_spec_step",) + sig
        self.fused_iter_key = ("serve_fused_iter",) + sig
        self._spec_fns: dict[int, Any] = {}
        self._dev_hist: torch.Tensor | None = None
        self._hist_overrides: dict[int, list[int]] = {}
        self.spec_verifies = 0      # per-lane verify events drained
        self.spec_emitted = 0       # tokens emitted by speculative steps
        self.spec_rounds = 0        # speculative loop rounds drained
        self._spec_depth = 1
        # Admission: "greedy" fills every free slot; "adaptive" makes the
        # width a ``serve_admission`` decision (the front end's mode).
        self.admission = admission
        self.admit_key = DecisionKey("serve_admission", sig)
        # Mesh-aware batch width (``serve_mesh_batch``): the key's
        # hardware field carries the mesh shape, so a width chosen on a
        # (4, 2) mesh never backs a (2, 4) run on the same silicon.
        self.mesh_key = None if mesh is None else DecisionKey(
            "serve_mesh_batch", sig,
            hardware=f"{hardware_key()}|mesh={self.mesh_desc}")
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
        # Fused-step variants ("fused" or ("spec", d)) that have run once:
        # the timed sync never records a cold call.
        self._warm_steps: set = set()
        # Decode steps that run under the kernel tuner (_dispatch_tuner).
        self._tuned_steps: set = set()
        self._dev_toks: torch.Tensor | None = None
        self._tok_overrides: dict[int, int] = {}
        # In-flight fused dispatches: (out_buf, stats, spec width,
        # ready_event, lanes).
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
        # The decode steps' CUDA graphs (capture stream, pool, scratch),
        # captured in ``warmup`` where it runs.
        self.graphs = DecodeGraphs()
        # Shapes that have run once: a cold call pays cuBLAS and kernel
        # set-up, which must never be recorded as t_iter.
        self._warm_prefill: set[int] = set()
        self._warm_decode = False
        if self._spec:
            self._spec_depth = self._agree(self._decide_spec_depth)

    # ----------------------------------------------------------------- mesh
    def _agree(self, decide: Callable[[], Any]) -> Any:
        """``decide()`` off a mesh; on one, taken on mesh rank 0 and
        broadcast with the trace entries it recorded (``Mesh.agree``):
        decisions read timings and the clock, which differ per rank."""
        if self.mesh is None:
            return decide()
        return self.mesh.agree(decide, self.decision_model())

    def _gather_lanes(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every replica's lanes of ``t`` (this rank's along ``dim``), in
        slot order: an ``all_gather`` over 'data' on a mesh."""
        if self.mesh is None:
            return t
        local = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.n_replicas * local.shape[0],)
                          + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        all_gather_into(out, local, group=self.mesh.groups["data"])
        return out.movedim(0, dim).contiguous()

    def _gather_stats(self, stats: torch.Tensor) -> torch.Tensor:
        """A speculative dispatch's (rounds, verifies, emitted) over every
        replica: each replica ran its own rounds on its own lanes, so the
        loop rounds are the most any ran and the verifies and tokens
        their sums, on the device (the drain reads them with the
        tokens)."""
        if self.mesh is None or self.n_replicas == 1:
            return stats
        each = self._gather_lanes(stats[None])
        return torch.stack([each[:, 0].amax(), each[:, 1].sum(),
                            each[:, 2].sum()])

    def _exchange(self, writes) -> None:
        """A paged mesh pool's exchange of the rows each replica wrote:
        ``writes`` (slot, lo, hi) for every slot written, on every rank."""
        if not self.paged or self.mesh is None or self.n_replicas == 1:
            return
        rows: list[list[int]] = [[] for _ in range(self.n_replicas)]
        for slot, lo, hi in writes:
            rows[slot // self.slots_per_replica] += \
                self.pool.slot_rows(slot, lo, hi)
        self.pool.exchange_rows(rows)

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
        if self._spec or self.paged:
            # Prefix-cache key / speculation history seed.
            req.host_tokens = tuple(tokens.tolist())
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
                # A first token (or history seed) the prefill produced for
                # this slot must not reach the next dispatch's carry: the
                # slot may belong to someone else by then.
                self._tok_overrides.pop(req.slot, None)
                self._hist_overrides.pop(req.slot, None)
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
        step, each speculative width it may pick, the prefill buckets,
        the kernels' first build and launch) into free slot 0, so the
        first timed tick measures compute; on the card this captures
        every decode graph.  Slot 0's rows (its scratch pages, when
        paged) take the garbage; masking hides it.

        With a kernel tuner the prefill buckets resolve their measured
        plans here (a first chunk at position 0 is exactly such a call),
        but the decode steps run the analytic plans, the tuner put aside:
        their lanes hold no request.  A decode step's plans are measured
        on its first dispatch over a full pool (``_dispatch_tuner``)."""
        if self.pool.free_slots() != self.pool.n_slots:
            raise RuntimeError("warmup must precede admission")
        with flags.tensor_parallel(self.tp):
            self._warmup()

    def _warmup(self) -> None:
        tuner = self.kernel_tuner or flags.KERNEL_TUNER
        lanes = self.pool.lanes
        n = lanes.stop - lanes.start
        zeros = torch.zeros(n, dtype=torch.long, device=self.device)
        one = [1] + [0] * (n - 1)
        pt = (self.pool.page_table_array()[lanes],) if self.paged else ()
        with flags.kernel_tuner(None):
            if self._fused:
                new_caches, _out, toks = self._fused_step()(
                    self.params, self.pool.caches, *pt, zeros,
                    self.pool.positions_array()[lanes], one)
                self.pool.mark_donated("fused decode warmup")
                device_sync(self.device)
                self.pool.adopt(new_caches)
                self._dev_toks = self._gather_lanes(toks)
                self._warm_steps.add("fused")
                if self._spec:
                    # Every width a re-decision can land on: a mid-run switch
                    # must never pay a first launch inside a timed window.
                    cap = min(self.max_spec_depth, self.max_dispatch_depth)
                    if self.speculate == "auto":
                        widths = [c for c in SPEC_DEPTH_CANDIDATES
                                  if 2 <= c <= cap]
                    else:
                        widths = [self._spec_depth] \
                            if self._spec_depth >= 2 else []
                    for d in widths:
                        self._hist_overrides[0] = [0]
                        new_caches, hist, _out, toks, _st, _reads = \
                            self._spec_step(d)(
                                self.params, self.pool.caches, *pt,
                                self._decode_hist()[lanes],
                                self._decode_toks()[lanes],
                                self.pool.positions_array()[lanes], one)
                        self.pool.mark_donated("fused decode warmup")
                        device_sync(self.device)
                        self.pool.adopt(new_caches)
                        self._dev_toks = self._gather_lanes(toks)
                        self._dev_hist = self._gather_lanes(hist)
                        self._warm_steps.add(("spec", d))
                self._warm_fused = True
            else:
                self._fused_step()(self.params, self.pool.caches, zeros,
                                   self.pool.positions_array()[lanes], one)
                device_sync(self.device)
                self._warm_decode = True
        with flags.kernel_tuner(tuner):
            if self._pad_ok:
                for b in self.chunk_buckets:
                    if b < self.max_len:
                        self._prefill_forward(
                            lanes.start, torch.zeros((1, b), dtype=torch.long,
                                                     device=self.device),
                            0, b - 1, pt[0][:1] if pt else None)
                        self._warm_prefill.add(b)
                device_sync(self.device)

    def _prefill_forward(self, slot: int, piece: torch.Tensor, pos: int,
                         last: int, page_table: torch.Tensor | None):
        """One prefill chunk into ``slot``: its rows written in place
        (through views into the slot pool, or through the slot's page
        table into the paged stores, with the slot's state rows); returns
        the logits at ``last``."""
        if page_table is None:
            row = self.pool.read_slot(slot)
            logits, _ = lm.forward_cached(
                self.params, piece, row, pos, self.cfg, window=self.window,
                logit_index=last)
            self.pool.write_slot(slot, row)
        else:
            logits, _ = lm.forward_cached(
                self.params, piece, self.pool.slot_caches(slot), pos,
                self.cfg, logit_index=last, page_table=page_table,
                page_size=self.pool.page_size)
        return logits

    # ----------------------------------------------------------------- tick
    def tick(self) -> TickRecord:
        """One scheduler round: admit → decide → prefill chunks → decode.

        The wall-clock of everything that is not a device wait is
        accumulated as ``host_overhead_s`` — the per-dispatch T0 the
        fused path amortises — and, on clean fused decode-only ticks,
        folded into the calibration store (``serve_host_tick``); a tick
        that captured a graph (a step's first dispatch under a kernel
        tuner, which also measures its plans) is not a clean one.  Under
        strict mode any implicit device→host sync in the round raises.
        """
        with strict.hot_dispatch_guard(), \
                flags.kernel_tuner(self.kernel_tuner or flags.KERNEL_TUNER), \
                flags.tensor_parallel(self.tp):
            t_start = time.perf_counter()
            self._blocked_s = 0.0
            self._tick_misses = 0
            was_warm = self._warm_fused
            captures = self.graphs.captures.total()
            rec = self._tick_fused() if self._fused else self._tick_legacy()
            host_s = max(
                time.perf_counter() - t_start - self._blocked_s, 0.0)
            self.host_overhead_s += host_s
            if self._fused and was_warm and rec.decoded \
                    and not rec.prefill_ops \
                    and self.graphs.captures.total() == captures:
                model = self.decision_model()
                if model is not None:
                    model.observe(self.host_tick_key, 1, host_s)
            return rec

    def _tick_legacy(self) -> TickRecord:
        """Per-tick decode: one device round-trip per decoded token."""
        admitted = self._admit()
        queued, cores, chunk = self._agree(self._decide)
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
            queued, cores, chunk = self._agree(self._decide)
            if self.paged and n_dec:
                # Chunked-prefill interleave: cap this tick's prefill
                # chunk-ops to what fits the window the in-flight fused
                # decode keeps the card busy (``serve_prefill_interleave``).
                cores = min(cores, self._agree(
                    lambda: self._decide_interleave(chunk)))
            pre_blocked = self._blocked_s
            prefill_ops, pf_finished = self._run_prefill(cores, chunk)
            if n_dec and not self._inflight:
                # Decode lanes sat idle while these chunks ran: nothing
                # was in flight to hide the prefill behind.
                self.prefill_stall_s += max(
                    self._blocked_s - pre_blocked, 0.0)
        else:
            queued = n_dec
            cores, chunk = 0, 0
            prefill_ops, pf_finished = [], []
        decoded, dec_finished, depth, disp_toks, spec_d = \
            self._dispatch_decode()
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
            dispatched_tokens=disp_toks, spec_depth=spec_d)
        self.trace.append(rec)
        self._tick += 1
        return rec

    def _admit(self) -> list[int]:
        """Earliest-deadline-first admission into free slots; FIFO among
        requests without deadlines.  With ``shed_expired``, a waiting
        request whose deadline has passed is shed before prefill.  With
        ``admission="adaptive"`` the number of slots filled this tick is
        a ``serve_admission`` decision, not "all of them"; a paged pool
        maps any cached prefix of the prompt into the slot."""
        if self.shed_expired and self._waiting:
            # Which requests expired reads the clock: one answer for the
            # whole mesh.
            now, expired = self._agree(lambda: (self.clock(), {
                r.rid for r in self._waiting
                if r.deadline is not None and self.clock() > r.deadline}))
            kept = []
            for req in self._waiting:
                if req.rid in expired:
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
        width = self._agree(self._decide_admission)
        lane_cap = self._agree(self._decide_mesh_batch)
        admitted = []
        while self._waiting and self.pool.free_slots() \
                and (width is None or len(admitted) < width) \
                and (lane_cap is None or len(self._active) < lane_cap):
            req = self._waiting.pop(0)
            if self.paged and req.host_tokens is not None:
                # Map any cached prefix of the prompt read-only into the
                # slot's page table; prefill resumes past it.
                req.slot, reused = self.pool.acquire_with_prefix(
                    req.rid, req.host_tokens)
                req.prefilled = reused
            else:
                req.slot = self.pool.acquire(req.rid)
            req.state = RequestState.PREFILL
            self._active.append(req)
            admitted.append(req.rid)
        self._queue_depth = len(self._waiting)
        return admitted

    def _decide_admission(self) -> int | None:
        """Admission width for this tick (``serve_admission``), or None
        for greedy fill-every-slot.  The measured host tick time is the
        T0 every admission round pays, one queued request's prefill bill
        the t_iter and the queue depth the element count; the width
        opens to every free slot when the head-of-queue deadline slack is
        inside two admission rounds."""
        if self.admission != "adaptive" or not self._waiting:
            return None
        free = self.pool.free_slots()
        if free == 0:
            return None
        model = self.decision_model()
        if model is None:       # static params object: no store, greedy
            return None
        host = model.smoothed_t_iter(self.host_tick_key)
        inputs: tuple = ()
        if host is None:
            host = self.acc.calibrate_t0(self.executor) \
                + 4.0 * decision_overhead_s()
            inputs = (("seeded", True),)
        head = self._waiting[0]
        t_pf = self.acc.measure_iteration(
            self.executor, self.prefill_profile,
            max(head.remaining_prefill, 1), key=self.prefill_key)
        req_cost = t_pf * max(head.remaining_prefill, 1)
        slack = None if head.deadline is None \
            else head.deadline - self.clock()
        decision = model.admission_width(
            self.admit_key, queue_depth=len(self._waiting),
            free_slots=free, host_tick_s=host, request_cost_s=req_cost,
            slack_s=slack, max_width=self.pool.n_slots,
            eff=getattr(self.acc, "efficiency",
                        overhead_law.DEFAULT_EFFICIENCY),
            evidence=(self.host_tick_key, self.prefill_key),
            inputs=inputs)
        return decision.cores

    def _decide_mesh_batch(self) -> int | None:
        """Global active-lane cap for a mesh-sharded pool (decision kind
        ``serve_mesh_batch``), or None off a mesh, with an empty queue or
        a params object with no store.  The engine amortises the measured
        per-dispatch host overhead (``serve_host_tick``) against the
        measured fused device step (``serve_decode_fused``) over the
        per-replica demand; the cap is ``width * n_replicas``.  Consulted
        only when there is something to admit."""
        if self.mesh is None or not self._waiting:
            return None
        model = self.decision_model()
        if model is None:       # static params object: every slot
            return None
        demand = len(self._waiting) + len(self._active)
        evidence = [self.host_tick_key, self.fused_key]
        inputs: tuple = (("mesh", self.mesh_desc),)
        host = model.smoothed_t_iter(self.host_tick_key)
        if host is None:
            host = self.acc.calibrate_t0(self.executor) \
                + 4.0 * decision_overhead_s()
            inputs += (("seeded", True),)
        dev = model.smoothed_t_iter(self.fused_key)
        if dev is None:
            dev = self.acc.measure_iteration(
                self.executor, self.decode_profile, max(demand, 1),
                key=self.decode_key)
            evidence.append(self.decode_key)
        decision = model.mesh_batch(
            self.mesh_key, demand=demand, n_replicas=self.n_replicas,
            slots_per_replica=self.slots_per_replica,
            host_tick_s=host, device_step_s=dev,
            eff=getattr(self.acc, "efficiency",
                        overhead_law.DEFAULT_EFFICIENCY),
            evidence=tuple(evidence), inputs=inputs)
        return decision.batch_width

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
        prompt and the largest bucket, never crossing a ring-buffer (SWA)
        window boundary."""
        step = min(max(chunk, 1), req.remaining_prefill,
                   self.chunk_buckets[-1])
        if self.window is not None:
            pos = self.pool.positions[req.slot]
            step = min(step, self.window - pos % self.window)
        return step

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

        pt = None
        if self.paged:
            # Page management is the ``serve_page_size`` decision's T0:
            # allocate / copy-on-write the pages this wave will write
            # (the padded rows too: they must not land in a shared
            # prefix page), timed and fed back (``serve_page_mgmt``).
            t_pg = time.perf_counter()
            for req, _, padded in ops:
                self.pool.ensure_writable(
                    req.slot, req.prefilled, req.prefilled + padded)
            model = self.decision_model()
            if model is not None:
                model.observe(self.page_mgmt_key, len(ops),
                              max(time.perf_counter() - t_pg, 0.0))
            pt = self.pool.page_table_array()
        dev = self.device
        if self.mesh is not None:
            return self._mesh_prefill(ops, pt)

        def run_chunk(chunk: Chunk):
            req, step, padded = ops[chunk.start]
            piece = torch.zeros(padded, dtype=torch.long)
            piece[:step] = req.tokens[req.prefilled:req.prefilled + step]
            logits = self._prefill_forward(
                req.slot, piece.to(dev, non_blocking=True)[None],
                req.prefilled, step - 1,
                None if pt is None else pt[req.slot:req.slot + 1])
            # Synchronise inside the thunk: the executor times this call
            # for the feedback loop.
            device_sync(dev)
            return logits

        if all(padded in self._warm_prefill for _, _, padded in ops):
            tag_workload(run_chunk, self.prefill_key)
        t_dev = time.perf_counter()
        futs = self.executor.bulk_async_execute(
            run_chunk, [Chunk(i, step) for i, (_, step, _) in enumerate(ops)])
        outs = when_all(futs).result()
        self._blocked_s += time.perf_counter() - t_dev
        self.host_roundtrips += 1
        self._warm_prefill.update(padded for _, _, padded in ops)

        return self._land_prefill(ops, [
            None if req.remaining_prefill > step
            # First-token sync: the host needs this token to route the
            # request into decode.
            else to_host(torch.argmax(logits[0, 0])).tolist()
            for (req, step, _), logits in zip(ops, outs, strict=True)])

    def _mesh_prefill(self, ops: list, pt: torch.Tensor | None):
        """A prefill wave on a mesh: this replica's chunk-ops, in order
        (their tensor-parallel collectives must meet), each timed into
        ``serve_prefill``; the paged rows every replica wrote exchanged;
        the finishing requests' first tokens all-reduced over 'data'
        (each is its own replica's, zeros elsewhere) in one read."""
        dev = self.device
        model = self.decision_model()
        firsts = torch.zeros(len(ops), dtype=torch.long, device=dev)
        t_dev = time.perf_counter()
        for i, (req, step, padded) in enumerate(ops):
            if not self.pool.holds(req.slot):
                continue
            piece = torch.zeros(padded, dtype=torch.long)
            piece[:step] = req.tokens[req.prefilled:req.prefilled + step]
            t0 = time.perf_counter()
            logits = self._prefill_forward(
                req.slot, piece.to(dev, non_blocking=True)[None],
                req.prefilled, step - 1,
                None if pt is None else pt[req.slot:req.slot + 1])
            device_sync(dev)
            if model is not None and padded in self._warm_prefill:
                model.observe(self.prefill_key, step,
                              time.perf_counter() - t0)
            if req.remaining_prefill == step:
                firsts[i] = torch.argmax(logits[0, 0])
        self._exchange([(req.slot, req.prefilled, req.prefilled + padded)
                        for req, _, padded in ops])
        all_reduce(firsts, self.mesh.groups["data"])
        toks = to_host(firsts).tolist()
        self._blocked_s += time.perf_counter() - t_dev
        self.host_roundtrips += 1
        self._warm_prefill.update(padded for _, _, padded in ops)
        return self._land_prefill(ops, [
            None if req.remaining_prefill > step else toks[i]
            for i, (req, step, _) in enumerate(ops)])

    def _land_prefill(self, ops: list, firsts: list):
        """Advance each op's request; a request whose prompt is done
        takes its first token (``firsts``) and moves to decode."""
        prefill_ops, finished = [], []
        for (req, step, _), tok in zip(ops, firsts, strict=True):
            req.prefilled += step
            self.pool.positions[req.slot] = req.prefilled
            prefill_ops.append((req.rid, step))
            if tok is not None:
                req.out.append(tok)
                req.first_token_at = self.clock()
                req.state = RequestState.DECODE
                if self.paged and req.host_tokens is not None:
                    # Publish the prompt's pages into the prefix cache
                    # (shared read-only; the slot's own next write
                    # copy-on-writes the tail page).
                    self.pool.register_prefix(req.slot, req.host_tokens)
                if len(req.out) >= req.max_new_tokens:
                    self._finish(req)
                    finished.append(req.rid)
                elif self._fused:
                    self._tok_overrides[req.slot] = tok
                    if self._spec:
                        # Seed the slot's history ring with the prompt
                        # tail + first token: the drafter reads it at
                        # the first speculative dispatch.
                        seed = list(req.host_tokens or ()) + [tok]
                        self._hist_overrides[req.slot] = \
                            seed[-self.spec_history:]
        return prefill_ops, finished

    # -- decode (per-tick path) ---------------------------------------------
    def _run_decode(self):
        decs = [r for r in self._active if r.state is RequestState.DECODE]
        if not decs:
            return [], []
        n = self.pool.n_slots
        toks = [0] * n
        steps = [0] * n
        for r in decs:
            toks[r.slot] = r.out[-1]
            steps[r.slot] = 1
        pool, params, dev = self.pool, self.params, self.device
        lanes = pool.lanes
        toks_a = host_to_device(toks, torch.long, dev)[lanes]
        poss_a = pool.positions_array()[lanes]
        step = self._fused_step()
        tuner = self._dispatch_tuner("fused")

        def run_decode(_):
            # One step of the fused decode (its graph, on the card), as
            # the reference jits this path as one program too.
            with flags.kernel_tuner(tuner):
                _, _, next_toks = step(params, pool.caches, toks_a, poss_a,
                                       steps[lanes])
            next_toks = self._gather_lanes(next_toks)
            device_sync(dev)
            return next_toks

        # A step that first runs under the tuner measures its plans and
        # captures anew: not timed as a warm one.
        if self._warm_decode and tuner is step.runner.tuner:
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

        self._exchange([(r.slot, self.pool.positions[r.slot],
                         self.pool.positions[r.slot] + 1) for r in decs])
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
    def _dispatch_tuner(self, step_id):
        """The kernel tuner a decode dispatch of ``step_id`` runs under.
        The first dispatch under it measures the step's plans on its own
        lanes, so that dispatch must carry the served load: until every
        slot holds a request the step keeps the analytic plans warmup
        captured (None); from its first dispatch over a full pool on,
        the scheduler's tuner (which captures the step anew once)."""
        tuner = self.kernel_tuner or flags.KERNEL_TUNER
        if tuner is None:
            return None
        if step_id not in self._tuned_steps:
            if self.pool.free_slots():
                return None
            self._tuned_steps.add(step_id)
        return tuner

    def _fused_step(self):
        if self._fused_fn is None:
            if self.paged:
                self._fused_fn = make_paged_decode_step(
                    self.cfg, page_size=self.pool.page_size,
                    max_depth=self.max_dispatch_depth, graphs=self.graphs)
            else:
                self._fused_fn = make_fused_decode_step(
                    self.cfg, window=self.window,
                    max_depth=self.max_dispatch_depth, graphs=self.graphs)
        return self._fused_fn

    def _spec_step(self, depth: int):
        """The speculative fused step for draft window ``depth`` (one
        per width, kept across the adaptive re-decisions)."""
        fn = self._spec_fns.get(depth)
        if fn is None:
            if self.paged:
                fn = make_paged_spec_decode_step(
                    self.cfg, depth=depth, page_size=self.pool.page_size,
                    max_depth=self.max_dispatch_depth, graphs=self.graphs)
            else:
                fn = make_spec_decode_step(
                    self.cfg, depth=depth, window=self.window,
                    max_depth=self.max_dispatch_depth, graphs=self.graphs)
            self._spec_fns[depth] = fn
        return fn

    def decode_cost_analysis(self) -> dict:
        """What one decode-loop iteration of the live step must do, on
        the scheduler's path (the fused step, contiguous or paged, or the
        speculative step at the live width): every lane one step at its
        live position, run once eagerly under a cost count
        (``analysis/roofline.count_costs``: tensor ops by their formulas
        and bytes, each kernel by its own count).  The reference's keys,
        the flops split into tensor-core and other, and the bound those
        give (the larger of the bytes over the memory rate and the flops
        over their peaks).  Every lane's budget is 0, so the step drops
        every write as a spent lane does (``fused_body``'s ``keep``) and
        does the same work: the pool, the tokens, the history and the
        live step's state are left as they were (the paged pool's
        scratch page 0, which takes the dropped rows, restored), and the
        launch counters too.

        On a mesh it counts this rank's step over its replica's lanes,
        under its tensor-parallel context: ``collective_bytes`` holds
        its collectives by kind (``roofline.collective_bytes``: a group
        of one rank counts its calls and no bytes) and
        ``collective_wire_bytes_per_device`` their ring-wire bytes.  The
        step's collectives must meet, so every rank of the mesh calls it.
        """
        from ..analysis import roofline

        dev = self.device
        lanes = self.pool.lanes
        n = lanes.stop - lanes.start
        spec = self._fused and self._spec and self._spec_depth >= 2
        step = self._spec_step(self._spec_depth) if spec \
            else self._fused_step()
        table = self.pool.page_table_array()[lanes] if self.paged else None
        hist = None
        if spec:
            hist = (self._dev_hist[lanes].clone()
                    if self._dev_hist is not None
                    else torch.full((n, self.spec_history), -1,
                                    dtype=torch.long, device=dev))
        st = StepState.empty(n, self.max_dispatch_depth, dev,
                             None if table is None else table.shape,
                             None if hist is None else hist.shape)
        if self._dev_toks is not None:
            st.toks.copy_(self._dev_toks[lanes])
        st.poss.copy_(self.pool.positions_array()[lanes])
        if table is not None:
            st.table.copy_(table)
        if hist is not None:
            st.hist.copy_(hist)
        caches = self.pool.caches
        ps = self.pool.page_size if self.paged else 0
        scratch = [(t, t[:ps].clone()) for c in caches
                   for k, t in c.items() if k in ("k", "v") and ps]
        before = build.snapshot()
        try:
            with strict.allow_sync(), flags.tensor_parallel(self.tp):
                costs = roofline.count_costs(step.runner.body, self.params,
                                             caches, st)
        finally:
            for t, rows in scratch:
                t[:ps].copy_(rows)
            build.restore(before)
        bound_s, bound_by = costs.bound()
        detail = roofline.collective_bytes(costs.collectives)
        return {"flops_per_device": costs.flops,
                "hbm_bytes_per_device": costs.bytes,
                "collective_wire_bytes_per_device":
                    detail["bytes"]["wire_total"],
                "n_devices": 1 if self.mesh is None else self.mesh.size,
                "collective_bytes": detail,
                "tensor_flops": costs.tensor_flops,
                "other_flops": costs.other_flops,
                "bound_s": bound_s, "bound_by": bound_by,
                "path": (f"spec{self._spec_depth}" if spec else "fused")
                + ("-paged" if self.paged else ""),
                "kernels": {name: dataclasses.asdict(w)
                            for name, w in costs.kernels.items()}}

    def _decode_hist(self) -> torch.Tensor:
        """The device-resident per-lane token-history ring the drafter
        reads, with host-known seeds (prompt tail + first token) spliced
        in."""
        n, h = self.pool.n_slots, self.spec_history
        if self._dev_hist is None:
            self._dev_hist = torch.full((n, h), -1, dtype=torch.long,
                                        device=self.device)
        if self._hist_overrides:
            mask = [False] * n
            vals = [[-1] * h for _ in range(n)]
            for slot, seed in self._hist_overrides.items():
                mask[slot] = True
                tail = list(seed[-h:])
                vals[slot] = [-1] * (h - len(tail)) + tail
            self._dev_hist = torch.where(
                host_to_device(mask, torch.bool, self.device)[:, None],
                host_to_device(vals, torch.long, self.device),
                self._dev_hist)
            self._hist_overrides.clear()
        return self._dev_hist

    def _decide_spec_depth(self) -> int:
        """Speculation width for the next dispatches — the
        ``serve_spec_depth`` decision.  Fixed widths are traced as such;
        ``auto`` trades expected accepted tokens per verify against the
        wider verify's cost, from the analytic prior acceptance until the
        drains have observed real acceptance (``serve_spec_accept``).
        Widening moves one candidate rung per decision; collapsed
        acceptance forces depth 1."""
        cap = min(self.max_spec_depth, self.max_dispatch_depth)
        model = self.decision_model()
        if self.speculate != "auto":
            d = max(min(int(self.speculate), cap), 1)
            if model is not None:
                model.note(self.spec_depth_key, policy="fixed-spec-depth",
                           cores=1, chunk=d, inputs=(("fixed", True),))
            return d
        if model is None:     # static params object: no store to consult
            return min(2, cap)
        evidence = (self.spec_accept_key, self.spec_step_key,
                    self.fused_key)
        inputs: tuple = ()
        ema = model.smoothed_t_iter(self.spec_accept_key)
        if ema is None:
            accept = DEFAULT_SPEC_ACCEPT
            inputs += (("seeded", True),)
        else:
            accept = min(max(float(ema), 0.0), 0.999)
            inputs += (("accept_ema", round(float(ema), 4)),)
        step = model.smoothed_t_iter(self.spec_step_key) \
            or model.smoothed_t_iter(self.fused_key) or 0.0
        cands = tuple(c for c in SPEC_DEPTH_CANDIDATES if c <= cap) \
            or (1,)
        # Width cost measured, not assumed, once both step EMAs hold
        # samples: seconds per speculative round over seconds per
        # width-1 iteration.
        kwargs: dict = {}
        spec_s = model.smoothed_t_iter(self.spec_step_key)
        iter_s = model.smoothed_t_iter(self.fused_iter_key)
        if spec_s and iter_s:
            d_ref = max(self._spec_depth, 2)
            wc = (spec_s / iter_s - 1.0) / (d_ref - 1.0)
            kwargs["width_cost"] = min(max(wc, 0.0), 1.0)
            inputs += (("width_cost_online", True),)
        decision = model.spec_depth(
            self.spec_depth_key, candidates=cands, accept_rate=accept,
            step_s=step, max_depth=cap, current=self._spec_depth,
            evidence=evidence, inputs=inputs, **kwargs)
        return decision.chunk

    def spec_stats(self) -> dict:
        """Cumulative speculation telemetry: verify events, tokens they
        emitted, loop rounds, tokens per verify, the EMA'd acceptance
        rate and the current width."""
        tpv = self.spec_emitted / self.spec_verifies \
            if self.spec_verifies else 0.0
        d = self._spec_depth if self._spec else 0
        model = self.decision_model()
        ema = model.smoothed_t_iter(self.spec_accept_key) \
            if model is not None else None
        accept = float(ema) if ema is not None \
            else ((tpv - 1.0) / (d - 1.0) if d >= 2 and tpv else 0.0)
        return {"enabled": self._spec, "depth": d,
                "verifies": self.spec_verifies,
                "emitted": self.spec_emitted,
                "rounds": self.spec_rounds,
                "tokens_per_verify": tpv,
                "acceptance_rate": max(accept, 0.0)}

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

    def _decide_page_size(self) -> int:
        """The ``serve_page_size`` decision: the page size minimising the
        Overhead-Law cost of the paged pool — per-request page management
        (measured ``serve_page_mgmt``, paid ``max_len / ps`` times)
        against half a page of wasted prefill per prompt tail (priced at
        the online-refined ``serve_prefill`` t_iter)."""
        model = self.decision_model()
        if model is None:
            return 16
        mgmt = model.smoothed_t_iter(self.page_mgmt_key) or 0.0
        pf = model.smoothed_t_iter(self.prefill_key)
        inputs: tuple = ()
        if pf is None:
            pf = self.acc.measure_iteration(
                self.executor, self.prefill_profile, self.max_len,
                key=self.prefill_key)
            inputs = (("seeded", True),)
        decision = model.page_size(
            self.page_size_key, candidates=DEFAULT_PAGE_CANDIDATES,
            max_len=self.max_len, page_mgmt_s=mgmt,
            prefill_token_s=pf or 0.0,
            evidence=(self.page_mgmt_key, self.prefill_key),
            inputs=inputs)
        return decision.chunk

    def _decide_interleave(self, chunk: int) -> int:
        """Per-tick ``serve_prefill_interleave`` decision: how many
        prefill chunk-ops fit the window the in-flight fused decode keeps
        the card busy (fused per-token time x last depth x decode lanes;
        one chunk costs the prefill t_iter x the chunk)."""
        ready = sum(1 for r in self._active
                    if r.state is RequestState.PREFILL)
        cap = max(ready, 1)
        model = self.decision_model()
        if self.prefill_interleave != "auto":
            r = min(int(self.prefill_interleave), cap)
            if model is not None:
                model.note(self.interleave_key, policy="fixed-interleave",
                           cores=1, chunk=max(r, 1),
                           inputs=(("fixed", True),))
            return max(r, 1)
        if model is None:
            return cap
        n_dec = sum(1 for r in self._active
                    if r.state is RequestState.DECODE)
        dev = model.smoothed_t_iter(self.fused_key) or 0.0
        window = dev * max(self._last_depth, 1) * max(n_dec, 1)
        t_pf = model.smoothed_t_iter(self.prefill_key)
        inputs: tuple = (("depth", self._last_depth), ("lanes", n_dec))
        if t_pf is None:
            t_pf = self.acc.measure_iteration(
                self.executor, self.prefill_profile, max(chunk, 1),
                key=self.prefill_key)
            inputs += (("seeded", True),)
        decision = model.prefill_interleave(
            self.interleave_key, pending_chunks=ready,
            decode_window_s=window,
            chunk_cost_s=max(t_pf or 0.0, 0.0) * max(chunk, 1),
            max_chunks=self.pool.n_slots,
            evidence=(self.fused_key, self.prefill_key,
                      self.host_tick_key),
            inputs=inputs)
        return decision.chunk

    def _dispatch_decode(self):
        """Dispatch one fused decode step (no sync): every DECODE slot
        advances by up to the decided depth, clamped to its remaining
        budget and cache room; the tokens land later via ``_drain``."""
        decs = [r for r in self._active if r.state is RequestState.DECODE]
        if not decs:
            return [], [], 0, 0, 0
        depth = self._agree(lambda: self._decide_depth(decs))
        self._last_depth = depth
        spec_d = self._spec_depth if self._spec else 1
        if self._spec and self.speculate == "auto" and spec_d < 2 \
                and min(self.max_spec_depth, self.max_dispatch_depth) >= 2 \
                and self.decode_dispatches % SPEC_PROBE_EVERY == 0:
            # Exploration probe (see SPEC_PROBE_EVERY).
            spec_d = 2
        use_spec = spec_d >= 2
        # Every verify window is ``spec_d`` wide whatever the lane's
        # remaining budget, so the last ``spec_d - 1`` positions are
        # reserved: a window must never write past the cache.
        margin = spec_d - 1 if use_spec else 0
        steps = [0] * self.pool.n_slots
        lanes_taken = []
        for r in decs:
            budget = min(r.max_new_tokens - len(r.out) - r.pending_out,
                         self.max_len - margin
                         - self.pool.positions[r.slot])
            take = max(min(depth, budget), 0)
            steps[r.slot] = take
            lanes_taken.append((r, r.slot, take))
        pt = ()
        if self.paged:
            # Allocation and copy-on-write land before the dispatch reads
            # the pool, and the table upload after: the dispatch reads
            # exactly this tick's mapping.  Speculation widens the
            # writable span by the draft margin, so a rejected draft only
            # ever lands in a page this slot owns alone.
            t_pg = time.perf_counter()
            for _, slot, take in lanes_taken:
                if take:
                    pos = self.pool.positions[slot]
                    self.pool.ensure_writable(
                        slot, pos, min(pos + take + margin, self.max_len))
            model = self.decision_model()
            if model is not None:
                model.observe(self.page_mgmt_key, len(lanes_taken),
                              max(time.perf_counter() - t_pg, 0.0))
            pt = (self.pool.page_table_array()[self.pool.lanes],)
        lanes = self.pool.lanes
        toks_a = self._decode_toks()[lanes]
        poss_a = self.pool.positions_array()[lanes]
        step_id = ("spec", spec_d) if use_spec else "fused"
        fused = self._spec_step(spec_d) if use_spec else self._fused_step()
        tuner = self._dispatch_tuner(step_id)
        # Periodic synced dispatch: the only honest wall-clock of the
        # device step is one with an empty pipeline around it.  A step
        # that first runs under the tuner measures its plans and captures
        # anew: not timed.
        timed = step_id in self._warm_steps \
            and tuner is fused.runner.tuner \
            and self.decode_dispatches % self.sync_every == 0
        if timed:
            self._drain(drop_to=0)
        t_dev = time.perf_counter()
        stats = None
        with flags.kernel_tuner(tuner):
            if use_spec:
                new_caches, new_hist, out_buf, final_toks, stats, reads = \
                    fused(self.params, self.pool.caches, *pt,
                          self._decode_hist()[lanes], toks_a, poss_a,
                          steps[lanes])
                self.host_roundtrips += reads
                new_hist = self._gather_lanes(new_hist)
                stats = self._gather_stats(stats)
            else:
                new_hist = None
                new_caches, out_buf, final_toks = fused(
                    self.params, self.pool.caches, *pt, toks_a, poss_a,
                    steps[lanes])
        out_buf = self._gather_lanes(out_buf, dim=1)
        final_toks = self._gather_lanes(final_toks)
        self._exchange([(slot, self.pool.positions[slot],
                         self.pool.positions[slot] + take)
                        for _, slot, take in lanes_taken if take])
        self.pool.mark_donated("fused decode dispatch")
        total = sum(take for _, _, take in lanes_taken)
        if timed:
            device_sync(self.device)
            dt = time.perf_counter() - t_dev
            self._blocked_s += dt
            self.host_roundtrips += 1
            model = self.decision_model()
            if model is not None and total > 0:
                model.observe(self.fused_key, total, dt)
                if stats is not None:
                    # The card is idle and the stats ready: reading the
                    # round count here rides the same sanctioned sync and
                    # prices one speculative round.
                    rounds = to_host(stats[0]).tolist()
                    if rounds > 0:
                        model.observe(self.spec_step_key, rounds, dt)
                else:
                    # Width-1 seconds per iteration, the denominator of
                    # the online width cost (``_decide_spec_depth``).
                    iters = max((take for _, _, take in lanes_taken),
                                default=0)
                    if iters > 0:
                        model.observe(self.fused_iter_key, iters, dt)
            if self._page_size_auto:
                # Re-decide with the page-management and prefill costs
                # observed so far: the refined size drives the next pool
                # over this store (the geometry of this one is fixed).
                self._agree(self._decide_page_size)
            if self._spec and self.speculate == "auto":
                self._spec_depth = self._agree(self._decide_spec_depth)
        self._warm_fused = True
        self._warm_steps.add(step_id)
        self.pool.adopt(new_caches)
        self._dev_toks = final_toks
        if new_hist is not None:
            self._dev_hist = new_hist
        self.decode_dispatches += 1
        self.decode_tokens += total
        if stats is None:
            self.decode_loop_iters += max(
                (take for _, _, take in lanes_taken), default=0)
        # else: speculative rounds vary; counted at drain from the stats.
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._inflight.append(
            (out_buf, stats, spec_d if use_spec else 0, ready, lanes_taken))

        decoded, finished = [], []
        for r, slot, take in lanes_taken:
            self.pool.advance(slot, take)
            r.pending_out += take
            decoded.append(r.rid)
            if len(r.out) + r.pending_out >= r.max_new_tokens \
                    or self.pool.positions[slot] >= self.max_len - margin:
                self._finish(r)
                finished.append(r.rid)
        return decoded, finished, depth, total, spec_d if use_spec else 0

    def _drain(self, drop_to: int | None = None,
               harvest: bool = False) -> None:
        """Land emitted tokens from finished fused dispatches.

        ``drop_to=N`` blocks until at most ``N`` dispatches remain in
        flight; ``harvest`` additionally pops any dispatch whose event
        has completed, without blocking.  One copy per dispatch (a
        speculative dispatch's stats ride in the same copy)."""
        while self._inflight:
            must = drop_to is not None and len(self._inflight) > drop_to
            if not must:
                if not harvest:
                    break
                ready = self._inflight[0][3]
                if ready is not None and not ready.query():
                    break
            out_buf, stats, disp_spec_d, _, lanes = self._inflight.popleft()
            t_dev = time.perf_counter()
            if stats is not None:
                flat = to_host(torch.cat([out_buf.reshape(-1), stats]))
                toks = flat[:-3].reshape(out_buf.shape).tolist()
                rounds, verifies, emitted = flat[-3:].tolist()
            else:
                toks = to_host(out_buf).tolist()
            if must:
                self._blocked_s += time.perf_counter() - t_dev
            self.host_roundtrips += 1
            if stats is not None:
                # Speculation telemetry; the acceptance rate is recovered
                # here, at the width this dispatch ran (tokens per verify
                # saturates at the width, so inverting it at another
                # width misreads acceptance).  Stored as elems=verifies,
                # seconds=accept x verifies: the EMA's per-element ratio
                # is the acceptance rate.
                self.decode_loop_iters += rounds
                self.spec_rounds += rounds
                self.spec_verifies += verifies
                self.spec_emitted += emitted
                model = self.decision_model()
                if model is not None and verifies > 0 \
                        and disp_spec_d >= 2:
                    a_s = (emitted / verifies - 1.0) / (disp_spec_d - 1.0)
                    # The floor keeps the sample visible to the EMA (it
                    # drops zero-cost observations), far below backoff.
                    a_s = min(max(a_s, 1e-3), 0.999)
                    model.observe(self.spec_accept_key, verifies,
                                  a_s * verifies)
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
