"""The ``ExecutionModel`` engine — one decide→execute→observe→refine loop.

The paper's contribution is not any single heuristic but an *execution
model*: a runtime-metric-driven strategy that decides execution
parameters uniformly behind the executor API.  Before this module the
repo had four parallel decision stacks that each reimplemented that loop
with incompatible keys and conventions:

* ``core/acc.AdaptiveCoreChunk`` + ``overhead_law.decide`` — algorithm
  core counts and chunk sizes;
* ``core/adaptive.AdaptiveExecutor`` + ``core/feedback.OnlineFeedback``
  — executor-level drift tracking (EMA over observed chunk wall-clock);
* ``kernels/autotune.KernelTuner`` — measured kernel block search;
* ``train/autotune.choose_plan`` / the serve scheduler's per-tick picks
  — train/serve planning.

``ExecutionModel`` owns the loop once; the former silos are *policies*
registered on it:

* **prior**   — ``AnalyticOverheadLaw``: the paper's closed form
  (Eqs 1-10, ``overhead_law.decide``) as the analytic seed;
* **search**  — ``MeasuredBlockSearch``: cold-call-excluded best-of-N
  wall-clock over a legal candidate neighbourhood (the loop that was
  ``KernelTuner._resolve``);
* **refine**  — ``OnlineEMA``: exponential smoothing of observed chunk
  timings back into the calibration store (the loop that was
  ``OnlineFeedback`` → ``CalibrationCache.smooth_t_iter``).

Every query goes through one typed IR:

* ``DecisionKey``   — workload kind + shape bucket + dtype + hardware;
* ``Decision``      — cores / chunk / block plan / batch width, plus
  *provenance* (``analytic | measured | online``) and the inputs that
  produced it;
* ``DecisionTrace`` — append-only explainable record of every decision
  (``--explain-decisions`` on the launch CLIs dumps it).

Provenance is monotone: once a key has measured data it never reports
``analytic`` again, and once it has online observations it never reports
``measured`` again (the calibration store only gains information; the
engine additionally clamps against the best level it has ever reported
for the key).  All state persists through one ``CalibrationCache``
(schema v3) so algorithm, kernel, serve and train decisions share a
single store.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import Counter, deque
from typing import Any, Callable, Hashable, Iterator, Sequence

from . import overhead_law
from .calibration import DEFAULT_SMOOTHING, CalibrationCache
from .overhead_law import AccDecision

# Self-speculative decoding priors (the ``serve_spec_depth`` decision).
# The acceptance prior seeds the analytic decision before any verify has
# drained; the width cost is the marginal fraction of a fixed decode
# step one extra verify position costs.  On a weight-streaming-bound
# accelerator that marginal is nearly free (the extra position rides the
# same weight reads); on a dispatch-overhead-bound host the draft /
# emit / history bookkeeping is a real per-round tax — the prior sits
# at the conservative end so the argmax only widens the verify when
# acceptance genuinely pays for it.  Below the backoff floor
# speculation is disabled outright.
DEFAULT_SPEC_ACCEPT = 0.5
DEFAULT_SPEC_WIDTH_COST = 0.25
MIN_SPEC_ACCEPT = 0.05

# Provenance levels, weakest to strongest.  A decision's provenance says
# what class of evidence backed it: a closed-form estimate, a one-shot
# measurement, or a continuously-refined online observation.
ANALYTIC = "analytic"
MEASURED = "measured"
ONLINE = "online"
PROVENANCE_LEVELS = (ANALYTIC, MEASURED, ONLINE)


def provenance_rank(level: str) -> int:
    """Position of ``level`` in the upgrade order (unknown maps to 0)."""
    try:
        return PROVENANCE_LEVELS.index(level)
    except ValueError:
        return 0


def provenance_max(a: str | None, b: str | None) -> str:
    """The stronger of two provenance levels (None counts as analytic)."""
    a = a or ANALYTIC
    b = b or ANALYTIC
    return a if provenance_rank(a) >= provenance_rank(b) else b


def hardware_key(device=None) -> str:
    """Stable id of the accelerator this process runs on.

    Measured winners and calibrations are only valid on the hardware
    that produced them: a timing taken on the CPU says nothing about an
    H100.  ``cuda:<device name>:<device count>`` for a CUDA device,
    ``cpu:<machine>:<cores>`` when the caller's device is the CPU — never
    a key the JAX package could produce, so the two frameworks cannot
    collide in one calibration store.  With no ``device`` the key names
    the CUDA card when one is present (a label only: nothing runs
    there because of it).
    """
    import os
    import platform

    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            return "cuda:unavailable:0"
        idx = dev.index if dev.index is not None else 0
        return (f"cuda:{torch.cuda.get_device_name(idx)}:"
                f"{torch.cuda.device_count()}")
    return f"cpu:{platform.machine() or 'unknown'}:{os.cpu_count() or 1}"


# ---------------------------------------------------------------------------
# The typed Decision IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecisionKey:
    """What a decision is *for*: workload kind + shape bucket + dtype +
    hardware.  ``cache_key()`` is the stable hashable the calibration
    store indexes by — a key adopted from a legacy workload key
    (``wrap``) keeps that key's *exact* cache identity (``raw``), so
    persisted v1/v2 entries keep resolving whatever shape the original
    key had (tuple, string, anything hashable)."""

    kind: str
    shape: tuple = ()
    dtype: str = ""
    hardware: str = ""
    # Set by wrap(): the legacy key verbatim.  When present it IS the
    # cache identity — typed fields above only label the trace.
    raw: Hashable | None = None

    def cache_key(self) -> Hashable:
        if self.raw is not None:
            return self.raw
        key: tuple = (self.kind,) + tuple(self.shape)
        if self.dtype:
            key += (self.dtype,)
        if self.hardware:
            key += (self.hardware,)
        return key

    @classmethod
    def wrap(cls, key: Hashable) -> "DecisionKey":
        """Adopt a legacy workload key (plain tuple, string, any
        hashable) into the IR without changing its cache identity."""
        if isinstance(key, DecisionKey):
            return key
        if isinstance(key, tuple) and key and isinstance(key[0], str):
            return cls(kind=key[0], shape=tuple(key[1:]), raw=key)
        return cls(kind=str(key), raw=key)

    def __str__(self) -> str:
        parts = ", ".join(str(s) for s in self.shape)
        text = f"{self.kind}({parts})"
        if self.dtype:
            text += f" {self.dtype}"
        if self.hardware:
            text += f" @{self.hardware}"
        return text


@dataclasses.dataclass(frozen=True)
class Decision:
    """One resolved decision: the execution parameters plus where they
    came from.  ``inputs`` is the (name, value) record that makes the
    decision explainable — everything the policy consumed."""

    key: DecisionKey
    policy: str                     # registered policy that produced it
    provenance: str                 # analytic | measured | online
    cores: int = 1                  # processing units / batch width
    chunk: int = 0                  # elements per task (0: not a chunked op)
    block_plan: tuple = ()          # kernel blocks, when a kernel decision
    batch_width: int | None = None  # serve/train width when distinct
    acc: AccDecision | None = None  # full Overhead-Law record when present
    inputs: tuple = ()              # ((name, value), ...)

    def input(self, name: str, default: Any = None) -> Any:
        for k, v in self.inputs:
            if k == name:
                return v
        return default

    def explain(self) -> str:
        """One human-readable line: key, result, policy, inputs."""
        result = []
        if self.block_plan:
            result.append(f"block={self.block_plan}")
        else:
            result.append(f"cores={self.cores} chunk={self.chunk}")
        if self.batch_width is not None:
            result.append(f"width={self.batch_width}")
        shown = []
        for k, v in self.inputs:
            if k == "timings":  # candidate sweep: summarise, don't dump
                v = f"<{len(v)} measured>"
            shown.append(f"{k}={_fmt(v)}")
        return (f"[{self.policy}/{self.provenance:8s}] {self.key}: "
                + " ".join(result)
                + ("  " + " ".join(shown) if shown else ""))


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    seq: int
    decision: Decision


class DecisionTrace:
    """Append-only, bounded record of every decision the engine made.

    Bounded because a serving loop decides every tick forever; the
    ``dropped`` counter says how many early entries aged out, so a dump
    is never silently mistaken for the full history."""

    def __init__(self, maxlen: int = 4096):
        self._entries: deque[TraceEntry] = deque(maxlen=maxlen)
        self._seq = 0
        self.dropped = 0
        self._lock = threading.Lock()

    def record(self, decision: Decision) -> TraceEntry:
        with self._lock:
            if len(self._entries) == self._entries.maxlen:
                self.dropped += 1
            entry = TraceEntry(self._seq, decision)
            self._seq += 1
            self._entries.append(entry)
        return entry

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[TraceEntry]:
        return iter(list(self._entries))

    def entries(self, kind: str | None = None) -> list[TraceEntry]:
        out = list(self._entries)
        if kind is not None:
            out = [e for e in out if e.decision.key.kind == kind]
        return out

    def explain(self, kind: str | None = None,
                limit: int | None = None) -> str:
        entries = self.entries(kind)
        kinds = Counter(e.decision.key.kind for e in entries)
        header = (f"decision trace: {len(entries)} decisions"
                  + (f" (+{self.dropped} aged out)" if self.dropped else "")
                  + " — "
                  + ", ".join(f"{n} {k}" for k, n in sorted(kinds.items())))
        if limit is not None:
            entries = entries[-limit:]
        lines = [f"  #{e.seq:04d} {e.decision.explain()}" for e in entries]
        return "\n".join([header] + lines)


# ---------------------------------------------------------------------------
# Policies (the former silos, now pluggable)
# ---------------------------------------------------------------------------

class AnalyticOverheadLaw:
    """Analytic prior policy: the paper's Overhead Law, Eqs 1-10.

    This is the single in-repo gateway to ``overhead_law.decide`` — every
    cores/chunk decision (algorithms, serve ticks, train plans,
    customization-point defaults) flows through here.
    """

    name = "overhead-law"

    def decide(self, *, t_iter: float, count: int, t0: float,
               max_cores: int,
               eff: float = overhead_law.DEFAULT_EFFICIENCY,
               chunks_per_core: int = overhead_law.DEFAULT_CHUNKS_PER_CORE,
               snap_cores: Callable[[int], int] | None = None
               ) -> AccDecision:
        d = overhead_law.decide(
            t_iter=t_iter, n_elements=count, t0=t0, max_cores=max_cores,
            eff=eff, chunks_per_core=chunks_per_core)
        if snap_cores is not None and d.n_cores > 1:
            # Backend constraint (e.g. mesh shardings need a divisor of
            # the data extent): snap, then recompute the derived fields.
            cores = max(int(snap_cores(d.n_cores)), 1)
            if cores != d.n_cores:
                import math

                chunk = overhead_law.chunk_size(count, cores,
                                                chunks_per_core)
                d = dataclasses.replace(
                    d, n_cores=cores, chunk_elems=chunk,
                    n_chunks=math.ceil(count / chunk),
                    predicted_time=overhead_law.predicted_time(
                        d.t1, cores, t0),
                    predicted_speedup=overhead_law.speedup(d.t1, cores, t0),
                    predicted_efficiency=overhead_law.efficiency(
                        d.t1, cores, t0),
                )
        return d


class MeasuredBlockSearch:
    """Measured-search policy (the loop that was ``KernelTuner``'s).

    ``run`` callables execute the real kernel once for a candidate on
    synthetic data of the right shape.  PyTorch runs eagerly, so there is
    no trace to escape; the probe instead synchronises the card around
    every timed call, so the clock times execution and not the launch.
    A ``run`` that times the device itself (CUDA events: a kernel shorter
    than its host launch would otherwise time the host) returns its
    seconds, which then stand for that call in place of the wall clock.
    """

    name = "measured-search"

    def __init__(self, repeats: int = 3):
        self.repeats = max(int(repeats), 1)

    @staticmethod
    def _eager():
        """No trace to escape in PyTorch: a no-op context, kept so the
        probe reads like the reference's."""
        return contextlib.nullcontext()

    @staticmethod
    def _sync() -> None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def measure(self, run: Callable[..., None], cand: tuple,
                repeats: int | None = None) -> float:
        repeats = self.repeats if repeats is None else max(int(repeats), 1)
        with self._eager():
            run(*cand)                   # cold call: build, untimed
            self._sync()
            best = float("inf")
            for _ in range(repeats):
                t = time.perf_counter()
                took = run(*cand)
                self._sync()
                wall = time.perf_counter() - t
                best = min(best, wall if took is None else float(took))
        return best

    def search(self, candidates: Sequence[tuple],
               run: Callable[..., None],
               repeats: int | None = None
               ) -> tuple[tuple, float, tuple]:
        """Best-of-``repeats`` wall-clock over ``candidates``; returns
        (winner, winner_seconds, ((candidate, seconds), ...))."""
        timings = tuple((cand, self.measure(run, cand, repeats))
                        for cand in candidates)
        winner, seconds = min(timings, key=lambda cs: cs[1])
        return winner, seconds, timings


class OnlineEMA:
    """Online refinement policy (the loop that was ``OnlineFeedback`` →
    ``smooth_t_iter``): fold observed per-chunk wall-clock back into the
    calibration store with exponential smoothing, so the *next* decision
    sees the drifted reality instead of a one-shot calibration."""

    name = "online-ema"

    def __init__(self, alpha: float = DEFAULT_SMOOTHING):
        self.alpha = alpha

    def refine(self, cache: CalibrationCache, key: tuple, elems: int,
               seconds: float, alpha: float | None = None) -> float | None:
        if elems <= 0 or seconds <= 0.0:
            return None
        per_elem = seconds / max(int(elems), 1)
        value = cache.smooth_t_iter(
            key, per_elem, self.alpha if alpha is None else alpha)
        cache.note_provenance(key, ONLINE)
        return value


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class ExecutionModel:
    """One decide→execute→observe→refine engine over one calibration
    store.  Construct directly for an isolated engine, or use
    ``ExecutionModel.of(cache)`` to share the engine (and its trace)
    among every consumer of that cache — which is how the acc object,
    the executor feedback layer, the kernel tuner and the serve/train
    planners end up in a single trace."""

    def __init__(self, cache: CalibrationCache | None = None, *,
                 hardware: str | None = None, trace_limit: int = 4096):
        self.cache = cache if cache is not None else CalibrationCache()
        self._hardware = hardware   # resolved lazily: hardware_key()
        self.trace = DecisionTrace(trace_limit)
        self.policies: dict[str, Any] = {}
        self.register_policy("prior", AnalyticOverheadLaw())
        self.register_policy("search", MeasuredBlockSearch())
        self.register_policy("refine", OnlineEMA())
        self._lock = threading.Lock()
        self._reported: dict[tuple, str] = {}   # provenance high-water
        self.decisions = 0
        self.cache_hits = 0     # tuned lookups answered from the store
        self.searches = 0       # measured candidate sweeps
        self.observations = 0   # online refinements folded in

    @property
    def hardware(self) -> str:
        """This process's accelerator id (resolved on first use so merely
        constructing an engine never touches the CUDA runtime)."""
        if self._hardware is None:
            self._hardware = hardware_key()
        return self._hardware

    @classmethod
    def of(cls, cache: CalibrationCache) -> "ExecutionModel":
        """The engine bound to ``cache`` (created and attached on first
        use).  Everyone who shares the cache shares the engine."""
        model = getattr(cache, "_execution_model", None)
        if model is None:
            model = cls(cache)
            cache._execution_model = model
        return model

    def register_policy(self, slot: str, policy: Any) -> Any:
        """Register ``policy`` under ``slot`` (``prior`` / ``search`` /
        ``refine`` are the built-in slots; new subsystems may add their
        own and query them via ``self.policies``)."""
        self.policies[slot] = policy
        return policy

    # -- provenance ----------------------------------------------------------
    def provenance_of(self, key: DecisionKey | Hashable) -> str:
        """Strongest evidence level available for ``key`` — the max of
        what the store records and what this engine has ever reported
        (so provenance never downgrades within a process either)."""
        k = DecisionKey.wrap(key).cache_key()
        stored = self.cache.provenance(k)
        with self._lock:
            return provenance_max(stored, self._reported.get(k))

    def _finish(self, decision: Decision) -> Decision:
        k = decision.key.cache_key()
        with self._lock:
            self._reported[k] = provenance_max(
                self._reported.get(k), decision.provenance)
            self.decisions += 1
        self.trace.record(decision)
        return decision

    # -- queries -------------------------------------------------------------
    def cores_chunk(self, key: DecisionKey | Hashable, *, t_iter: float,
                    count: int, t0: float, max_cores: int,
                    eff: float = overhead_law.DEFAULT_EFFICIENCY,
                    chunks_per_core: int =
                    overhead_law.DEFAULT_CHUNKS_PER_CORE,
                    snap_cores: Callable[[int], int] | None = None,
                    evidence: Sequence[Hashable] = (),
                    inputs: tuple = ()) -> Decision:
        """Cores + chunk for a workload: the analytic prior policy over
        ``t_iter`` (which may itself be measured or online-refined —
        provenance reflects the strongest evidence behind the key).
        ``evidence`` names extra workload keys whose calibrations fed
        the ``t_iter`` input (e.g. a serve tick blends the prefill and
        decode keys), so their provenance counts too."""
        dkey = DecisionKey.wrap(key)
        prior: AnalyticOverheadLaw = self.policies["prior"]
        d = prior.decide(t_iter=t_iter, count=count, t0=t0,
                         max_cores=max_cores, eff=eff,
                         chunks_per_core=chunks_per_core,
                         snap_cores=snap_cores)
        provenance = self.provenance_of(dkey)
        for ekey in evidence:
            provenance = provenance_max(provenance,
                                        self.provenance_of(ekey))
        return self._finish(Decision(
            key=dkey, policy=prior.name, provenance=provenance,
            cores=d.n_cores, chunk=d.chunk_elems, acc=d,
            inputs=(("t_iter", t_iter), ("count", count), ("t0", t0),
                    ("max_cores", max_cores)) + tuple(inputs)))

    def dispatch_depth(self, key: DecisionKey | Hashable, *,
                       host_overhead_s: float, device_step_s: float,
                       max_depth: int,
                       eff: float = overhead_law.DEFAULT_EFFICIENCY,
                       evidence: Sequence[Hashable] = (),
                       inputs: tuple = ()) -> Decision:
        """Dispatch depth for a fused device loop (decision kind
        ``serve_dispatch_depth``): how many iterations (decoded tokens)
        one device dispatch should carry so the fixed host overhead per
        dispatch amortises to the efficiency target.

        This is the paper's chunk-size floor re-read along the *time*
        axis: ``host_overhead_s`` is the ``T0`` paid once per dispatch
        (scheduler bookkeeping, engine queries, jit dispatch, the drain
        round-trip), ``device_step_s`` the per-iteration ``t_iter``, and
        the depth is the smallest ``k`` whose device work meets the
        ``T_opt = E/(1-E) * T0`` floor — at the default E=0.95, the
        dispatch must carry 19x its own overhead.  Clamped to
        ``[1, max_depth]`` (the compiled loop's static bound).

        The inputs are expected to come from calibrated/smoothed store
        entries; ``evidence`` names their keys so the decision's
        provenance reflects the strongest level backing them (online
        once the serve loop has timed real dispatches).
        """
        import math

        dkey = DecisionKey.wrap(key)
        prior: AnalyticOverheadLaw = self.policies["prior"]
        max_depth = max(int(max_depth), 1)
        if device_step_s > 0.0 and host_overhead_s > 0.0:
            depth = math.ceil(
                overhead_law.t_opt(host_overhead_s, eff) / device_step_s)
        elif host_overhead_s <= 0.0:
            depth = 1            # free dispatches: no need to fuse
        else:
            depth = max_depth    # unknown device time: amortise fully
        depth = min(max(depth, 1), max_depth)
        provenance = self.provenance_of(dkey)
        for ekey in evidence:
            provenance = provenance_max(provenance,
                                        self.provenance_of(ekey))
        return self._finish(Decision(
            key=dkey, policy=prior.name, provenance=provenance,
            cores=1, chunk=depth,
            inputs=(("host_overhead_s", host_overhead_s),
                    ("device_step_s", device_step_s),
                    ("max_depth", max_depth), ("eff", eff))
            + tuple(inputs)))

    def admission_width(self, key: DecisionKey | Hashable, *,
                        queue_depth: int, free_slots: int,
                        host_tick_s: float, request_cost_s: float,
                        max_width: int, slack_s: float | None = None,
                        eff: float = overhead_law.DEFAULT_EFFICIENCY,
                        evidence: Sequence[Hashable] = (),
                        inputs: tuple = ()) -> Decision:
        """Admission width for a serving tick (decision kind
        ``serve_admission``): how many queued requests to admit into free
        cache slots *this* tick.

        This is Eq. 7's "leave units free" applied at the request level:
        slots are the processing units, the waiting queue is the
        workload, ``host_tick_s`` is the fixed cost every admission round
        pays (the measured ``serve_host_tick`` T0), and
        ``request_cost_s`` is one admitted request's prefill bill (the
        online-refined ``serve_prefill`` t_iter times its prompt).  The
        Overhead-Law prior yields the widest admission that keeps the
        tick efficient — admitting an entire burst at once parks
        requests in slots where their prefills stall the decode lanes
        and, under EDF, locks the pool against later, more urgent
        arrivals.

        ``slack_s`` is the head-of-queue deadline slack: when waiting
        another throttled tick would plausibly cost the deadline
        (slack inside two admission rounds), the width opens up to every
        free slot — deadline pressure beats efficiency.  Clamped to
        ``[1, min(free_slots, queue_depth, max_width)]`` (a tick with
        queued work and a free slot always admits at least one request:
        throttling must never become starvation).

        Both timing inputs are expected to come from the calibration
        store; ``evidence`` names their keys so provenance upgrades to
        online once the serve loop has timed real ticks and prefills.
        """
        dkey = DecisionKey.wrap(key)
        prior: AnalyticOverheadLaw = self.policies["prior"]
        cap = max(min(int(free_slots), int(queue_depth), int(max_width)), 1)
        d = prior.decide(t_iter=max(request_cost_s, 0.0),
                         count=max(int(queue_depth), 1),
                         t0=max(host_tick_s, 0.0), max_cores=cap, eff=eff,
                         chunks_per_core=1)
        width = min(max(d.n_cores, 1), cap)
        urgent = slack_s is not None and \
            slack_s <= 2.0 * (host_tick_s + request_cost_s)
        if urgent:
            width = cap
        provenance = self.provenance_of(dkey)
        for ekey in evidence:
            provenance = provenance_max(provenance,
                                        self.provenance_of(ekey))
        return self._finish(Decision(
            key=dkey, policy=prior.name, provenance=provenance,
            cores=width, batch_width=width, acc=d,
            inputs=(("queue_depth", queue_depth),
                    ("free_slots", free_slots),
                    ("host_tick_s", host_tick_s),
                    ("request_cost_s", request_cost_s),
                    ("slack_s", slack_s), ("urgent", urgent))
            + tuple(inputs)))

    def mesh_batch(self, key: DecisionKey | Hashable, *,
                   demand: int, n_replicas: int, slots_per_replica: int,
                   host_tick_s: float, device_step_s: float,
                   eff: float = overhead_law.DEFAULT_EFFICIENCY,
                   evidence: Sequence[Hashable] = (),
                   inputs: tuple = ()) -> Decision:
        """Per-device batch width for a mesh-sharded serve loop (decision
        kind ``serve_mesh_batch``): how many decode lanes each
        data-parallel replica should keep active, so that
        ``global_batch = n_replicas * per_device_batch``.

        This is the paper's cores question at the next hardware scale:
        replicas took the place of cores when the serving path moved onto
        a device mesh, and the per-replica slot count is the resource the
        executor allocates.  The Overhead-Law prior reads the per-replica
        workload (``ceil(demand / n_replicas)`` requests) against the
        per-dispatch fixed cost: ``host_tick_s`` is the T0 every fused
        dispatch pays once for the whole mesh, ``device_step_s`` the
        measured per-token device time of the fused loop (the online-
        refined ``serve_decode_fused`` entry), and the width is Eq. 7's
        core count with slots-per-replica as the unit pool — opening
        every lane of an idle mesh is exactly the "more units than the
        workload can keep efficient" mistake the law prices.

        The key's ``hardware`` field is expected to carry the mesh shape
        (e.g. ``"cpu-8x...|mesh=4x2"``) so decisions made on one topology
        never back another.  Provenance follows ``evidence`` (the
        host-tick and fused-step timing keys): analytic until the serve
        loop has timed real dispatches, online after — never downgrading.
        """
        dkey = DecisionKey.wrap(key)
        prior: AnalyticOverheadLaw = self.policies["prior"]
        n_replicas = max(int(n_replicas), 1)
        slots_per_replica = max(int(slots_per_replica), 1)
        per_replica = max(-(-int(demand) // n_replicas), 1)  # ceil div
        d = prior.decide(t_iter=max(device_step_s, 0.0),
                         count=per_replica,
                         t0=max(host_tick_s, 0.0),
                         max_cores=slots_per_replica, eff=eff,
                         chunks_per_core=1)
        width = min(max(d.n_cores, 1), slots_per_replica)
        provenance = self.provenance_of(dkey)
        for ekey in evidence:
            provenance = provenance_max(provenance,
                                        self.provenance_of(ekey))
        return self._finish(Decision(
            key=dkey, policy=prior.name, provenance=provenance,
            cores=width, batch_width=width * n_replicas, acc=d,
            inputs=(("demand", demand), ("n_replicas", n_replicas),
                    ("slots_per_replica", slots_per_replica),
                    ("host_tick_s", host_tick_s),
                    ("device_step_s", device_step_s), ("eff", eff))
            + tuple(inputs)))

    def page_size(self, key: DecisionKey | Hashable, *,
                  candidates: Sequence[int], max_len: int,
                  page_mgmt_s: float, prefill_token_s: float,
                  evidence: Sequence[Hashable] = (),
                  inputs: tuple = ()) -> Decision:
        """KV page size for a paged slot pool (decision kind
        ``serve_page_size``): how many token rows one page should hold.

        This is the paper's chunk-size question applied to *memory
        layout*.  A page is a chunk of cache rows, and the same two
        opposing costs price it: ``page_mgmt_s`` is the measured
        per-page fixed overhead a request pays on the host (table
        updates, refcounts, allocation — the ``T0`` of the Overhead Law,
        observed from the pool's ``ensure_writable``/table-build time),
        so small pages multiply it by ``max_len / ps``; and a prompt's
        tail page is half empty on average, so large pages waste
        ``ps / 2`` rows of prefill writes and prefix-shareable
        granularity, priced at the online-refined per-token prefill time
        ``prefill_token_s``.  The pick minimises

            cost(ps) = (max_len / ps) * page_mgmt_s
                     + (ps / 2)      * prefill_token_s

        over the candidate set — analytic until the serve loop has
        observed real page-management and prefill timings (the
        ``evidence`` keys), online after.  With no timing signal at all
        the middle candidate wins (pure prior).  The chosen size rides
        in ``chunk``.
        """
        dkey = DecisionKey.wrap(key)
        prior: AnalyticOverheadLaw = self.policies["prior"]
        cands = sorted({max(int(c), 1) for c in candidates})
        if not cands:
            raise ValueError("page_size needs at least one candidate")
        if page_mgmt_s <= 0.0 and prefill_token_s <= 0.0:
            ps = cands[len(cands) // 2]
            costs = ()
        else:
            scored = [(max_len / c * max(page_mgmt_s, 0.0)
                       + c / 2.0 * max(prefill_token_s, 0.0), c)
                      for c in cands]
            _, ps = min(scored)
            costs = tuple((c, round(s, 9)) for s, c in scored)
        provenance = self.provenance_of(dkey)
        for ekey in evidence:
            provenance = provenance_max(provenance,
                                        self.provenance_of(ekey))
        return self._finish(Decision(
            key=dkey, policy=prior.name, provenance=provenance,
            cores=1, chunk=ps,
            inputs=(("max_len", max_len),
                    ("page_mgmt_s", page_mgmt_s),
                    ("prefill_token_s", prefill_token_s),
                    ("candidates", tuple(cands)),
                    ("costs", costs)) + tuple(inputs)))

    def prefill_interleave(self, key: DecisionKey | Hashable, *,
                           pending_chunks: int, decode_window_s: float,
                           chunk_cost_s: float, max_chunks: int,
                           evidence: Sequence[Hashable] = (),
                           inputs: tuple = ()) -> Decision:
        """Prefill/decode interleave ratio for a fused serve tick
        (decision kind ``serve_prefill_interleave``): how many prefill
        chunk-ops to run in the window one fused decode dispatch keeps
        the device busy.

        While a fused decode dispatch is in flight the host is free —
        that window is ``decode_window_s`` (the online-refined fused
        per-token time times the dispatch depth and active lanes).  Each
        prefill chunk costs ``chunk_cost_s`` of blocking host+device
        time; running more chunks than fit the window stalls the decode
        lanes when the next dispatch finds no queued work (the
        ``prefill_stall_s`` the throughput benchmark surfaces), while
        running fewer starves admission.  The ratio is simply how many
        chunks fit:

            r = clamp(floor(decode_window_s / chunk_cost_s),
                      1, min(pending_chunks, max_chunks))

        — at least one chunk always runs (prefill must never starve), at
        most what is actually pending.  An unknown chunk cost opens the
        cap: with nothing measured yet there is nothing to protect.
        Provenance follows the ``evidence`` keys (fused-step and prefill
        timings).  The ratio rides in ``chunk``.
        """
        import math

        dkey = DecisionKey.wrap(key)
        prior: AnalyticOverheadLaw = self.policies["prior"]
        cap = max(min(int(pending_chunks), int(max_chunks)), 1)
        if chunk_cost_s > 0.0 and decode_window_s > 0.0:
            r = int(math.floor(decode_window_s / chunk_cost_s))
        else:
            r = cap
        r = min(max(r, 1), cap)
        provenance = self.provenance_of(dkey)
        for ekey in evidence:
            provenance = provenance_max(provenance,
                                        self.provenance_of(ekey))
        return self._finish(Decision(
            key=dkey, policy=prior.name, provenance=provenance,
            cores=1, chunk=r,
            inputs=(("pending_chunks", pending_chunks),
                    ("decode_window_s", decode_window_s),
                    ("chunk_cost_s", chunk_cost_s),
                    ("max_chunks", max_chunks)) + tuple(inputs)))

    def spec_depth(self, key: DecisionKey | Hashable, *,
                   candidates: Sequence[int], accept_rate: float,
                   step_s: float = 0.0,
                   width_cost: float = DEFAULT_SPEC_WIDTH_COST,
                   min_accept: float = MIN_SPEC_ACCEPT,
                   max_depth: int = 8,
                   current: int | None = None,
                   evidence: Sequence[Hashable] = (),
                   inputs: tuple = ()) -> Decision:
        """Speculation depth for a self-speculative fused decode loop
        (decision kind ``serve_spec_depth``): how many positions one
        draft-and-verify round should carry.

        This is the Overhead Law applied to the *model itself*, and the
        engine's first stochastic decision input: every verify round
        pays a fixed cost (the weight-streaming-bound decode step — the
        round's ``T0``) whether it emits one token or ``d``, and
        widening the verify by a draft costs only ``width_cost`` of
        that fixed step (the batch dim rides the same weight reads).
        With per-draft acceptance rate ``a``, a round of depth ``d``
        emits the longest matching prefix plus the corrected token:

            E(d, a)   = 1 + a + a^2 + ... + a^(d-1)   (expected tokens)
            cost(d)   = 1 + width_cost * (d - 1)      (relative round)
            score(d)  = E(d, a) / cost(d)             (tokens per round)

        and the pick is the argmax over the candidate set — ``d = 1``
        (speculation off) wins by construction whenever acceptance
        cannot pay the verify width, and is *forced* when the EMA'd
        acceptance collapses below ``min_accept`` (adaptive backoff:
        drafting noise must not tax the steady state).  ``accept_rate``
        is expected to come from the drain-time ``serve_spec_accept``
        EMA (analytic prior before any spec dispatch has drained);
        ``step_s`` is contextual (the measured per-round seconds behind
        the throughput claim, recorded for ``--explain-decisions``).

        ``current`` enables one-step hysteresis: acceptance observed at
        depth ``d`` is censored at ``d - 1`` accepted drafts, so a
        saturated reading (every draft accepted) says nothing about how
        much *deeper* runs would fare — extrapolating the geometric
        E(d, a) several ladder rungs up routinely overshoots, then
        crashes to backoff when the wider width's real acceptance lands.
        With ``current`` set, the pick moves at most one candidate rung
        per decision (collapse backoff still drops straight to 1), so
        each widening is validated by a drain at the new width before
        the next.  Provenance follows ``evidence``.  The chosen depth
        rides in ``chunk``.
        """
        dkey = DecisionKey.wrap(key)
        prior: AnalyticOverheadLaw = self.policies["prior"]
        max_depth = max(int(max_depth), 1)
        cands = sorted({min(max(int(c), 1), max_depth)
                        for c in candidates} | {1})
        a = min(max(float(accept_rate), 0.0), 0.999)
        backoff = a < min_accept
        if backoff:
            depth = 1
            scores = ()
        else:
            scored = [(sum(a ** i for i in range(c))
                       / (1.0 + width_cost * (c - 1)), c)
                      for c in cands]
            # max() prefers the shallower depth on exact ties (the
            # cheaper compile and smaller rollback window).
            depth = max(scored, key=lambda sc: (sc[0], -sc[1]))[1]
            scores = tuple((c, round(s, 6)) for s, c in scored)
            if current is not None:
                cur = min(max(int(current), 1), max_depth)
                ci = max(i for i, c in enumerate(cands) if c <= cur)
                pi = cands.index(depth)
                ni = ci + (1 if pi > ci else -1 if pi < ci else 0)
                if cands[ni] != depth:
                    inputs = (("unclamped", depth),) + tuple(inputs)
                    depth = cands[ni]
        provenance = self.provenance_of(dkey)
        for ekey in evidence:
            provenance = provenance_max(provenance,
                                        self.provenance_of(ekey))
        return self._finish(Decision(
            key=dkey, policy=prior.name, provenance=provenance,
            cores=1, chunk=depth,
            inputs=(("accept_rate", round(a, 4)),
                    ("width_cost", width_cost),
                    ("step_s", step_s),
                    ("backoff", backoff),
                    ("candidates", tuple(cands)),
                    ("scores", scores))
            + (() if current is None else (("current", int(current)),))
            + tuple(inputs)))

    def default_cores_chunk(self, count: int, max_cores: int) -> AccDecision:
        """The customization-point *default* decision (paper: "splits the
        work into equally sized chunks while utilizing all available
        processing units"): the Overhead Law degenerates to exactly that
        at zero measured cost and one chunk per core.  Untraced — it is
        the absence of a policy, not a policy."""
        return default_cores_chunk(count, max_cores,
                                   prior=self.policies["prior"])

    def tuned_blocks(self, key: DecisionKey | Hashable,
                     candidates: Sequence[tuple],
                     run: Callable[..., None], fields: tuple[str, ...], *,
                     repeats: int | None = None,
                     legal: Callable[[tuple], bool] | None = None
                     ) -> Decision:
        """Measured winner for a kernel block key: from the store when a
        legal persisted record exists (positive fields, and ``legal``
        where given), else a candidate sweep through the measured-search
        policy, persisted for every later process sharing the store."""
        dkey = DecisionKey.wrap(key)
        k = dkey.cache_key()
        search: MeasuredBlockSearch = self.policies["search"]
        rec = self.cache.tuned(k)
        winner: tuple | None = None
        if rec is not None:
            try:
                winner = tuple(int(rec[f]) for f in fields)
                if any(v <= 0 for v in winner) or (
                        legal is not None and not legal(winner)):
                    winner = None  # illegal block: re-measure
            except (KeyError, TypeError, ValueError):
                winner = None      # torn/foreign record: re-measure
        if winner is not None:
            with self._lock:
                self.cache_hits += 1
            return self._finish(Decision(
                key=dkey, policy=search.name, provenance=MEASURED,
                block_plan=winner,
                inputs=(("prior", tuple(candidates[0])),
                        ("measured", False), ("from_store", True))))
        winner, seconds, timings = search.search(candidates, run, repeats)
        with self._lock:
            self.searches += 1
        record = {f: int(v) for f, v in zip(fields, winner, strict=True)}
        record.update(hw=dkey.hardware or self.hardware, seconds=seconds,
                      candidates=len(candidates))
        self.cache.set_tuned(k, record)
        self.cache.note_provenance(k, MEASURED)
        return self._finish(Decision(
            key=dkey, policy=search.name, provenance=MEASURED,
            block_plan=winner,
            inputs=(("prior", tuple(candidates[0])),
                    ("measured", True), ("seconds", seconds),
                    ("candidates", len(candidates)),
                    ("timings", timings))))

    def observe(self, key: DecisionKey | Hashable, elems: int,
                seconds: float, alpha: float | None = None) -> float | None:
        """Fold one observed chunk timing into the store (online
        refinement stage).  Returns the smoothed per-element time now
        backing decisions for ``key``.  Observations are counted but not
        traced — they refine inputs; decisions consume them."""
        refine: OnlineEMA = self.policies["refine"]
        k = DecisionKey.wrap(key).cache_key()
        value = refine.refine(self.cache, k, elems, seconds, alpha)
        if value is not None:
            with self._lock:
                self.observations += 1
        return value

    def measured_t_iter(self, key: DecisionKey | Hashable,
                        measure: Callable[[], float]) -> float:
        """Memoised one-shot t_iter measurement (paper Section 4.2),
        recorded as ``measured`` provenance for the key."""
        k = DecisionKey.wrap(key).cache_key()
        value = self.cache.t_iter(k, measure)
        self.cache.note_provenance(k, MEASURED)
        return value

    def smoothed_t_iter(self, key: DecisionKey | Hashable) -> float | None:
        """Current (possibly online-refined) t_iter for ``key``."""
        return self.cache.peek_t_iter(DecisionKey.wrap(key).cache_key())

    def t0(self, key: DecisionKey | Hashable,
           measure: Callable[[], float]) -> float:
        """Memoised T0 calibration through the shared store."""
        k = DecisionKey.wrap(key).cache_key()
        value = self.cache.t0(k, measure)
        self.cache.note_provenance(k, MEASURED)
        return value

    def note(self, key: DecisionKey | Hashable, *, policy: str,
             cores: int = 1, chunk: int = 0, block_plan: tuple = (),
             batch_width: int | None = None,
             acc: AccDecision | None = None,
             inputs: tuple = ()) -> Decision:
        """Trace a derived decision a consumer finalised outside the
        built-in policies (e.g. the train planner's divisor snapping) so
        the dump still attributes the *final* numbers."""
        dkey = DecisionKey.wrap(key)
        return self._finish(Decision(
            key=dkey, policy=policy, provenance=self.provenance_of(dkey),
            cores=cores, chunk=chunk, block_plan=tuple(block_plan),
            batch_width=batch_width, acc=acc, inputs=tuple(inputs)))

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"decisions": self.decisions,
                    "cache_hits": self.cache_hits,
                    "searches": self.searches,
                    "observations": self.observations,
                    "trace_len": len(self.trace),
                    "hardware": self.hardware}

    def explain(self, kind: str | None = None,
                limit: int | None = None) -> str:
        s = self.stats()
        header = (f"ExecutionModel[{s['hardware']}]: "
                  f"{s['decisions']} decisions, {s['searches']} searches, "
                  f"{s['cache_hits']} store hits, "
                  f"{s['observations']} observations")
        return header + "\n" + self.trace.explain(kind=kind, limit=limit)


_DEFAULT_PRIOR = AnalyticOverheadLaw()


def default_cores_chunk(count: int, max_cores: int, *,
                        prior: AnalyticOverheadLaw | None = None
                        ) -> AccDecision:
    """The shared customization-point default (see
    ``ExecutionModel.default_cores_chunk``): all available units, equal
    chunks, via the same Overhead-Law policy every engine uses — the
    defaults in core/customization.py delegate here instead of
    reimplementing the formulas."""
    prior = prior if prior is not None else _DEFAULT_PRIOR
    return prior.decide(t_iter=0.0, count=max(int(count), 1), t0=0.0,
                        max_cores=max(int(max_cores), 1),
                        chunks_per_core=1)


_DECISION_OVERHEAD_S: float | None = None


def decision_overhead_s() -> float:
    """Measured seconds per engine decision on this host, memoised.

    The decision-engine microbench (benchmarks/executor_overhead.py)
    inlined: an isolated engine answers a warm ``cores_chunk`` query in
    a tight loop.  Consumers (the serve scheduler's fused-dispatch
    seeding) use it as the *analytic* component of the host-overhead
    estimate before any real tick has been timed — a scheduler tick
    makes a handful of engine queries, so its host floor is a small
    multiple of this number.
    """
    global _DECISION_OVERHEAD_S
    if _DECISION_OVERHEAD_S is None:
        engine = ExecutionModel(CalibrationCache())
        key = DecisionKey("microbench", ())

        def query():
            engine.cores_chunk(key, t_iter=1e-6, count=4096, t0=1e-5,
                               max_cores=4)

        for _ in range(8):
            query()              # warm: caches, code paths
        n = 64
        start = time.perf_counter()
        for _ in range(n):
            query()
        _DECISION_OVERHEAD_S = (time.perf_counter() - start) / n
    return _DECISION_OVERHEAD_S
