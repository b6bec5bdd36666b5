"""Online-feedback telemetry: executors report observed chunk wall-clock
back into the calibration cache.

The paper measures t_iter once per workload and trusts it forever
(Section 4.2).  Under a serving load that assumption breaks: per-token
cost drifts with sequence length, cache occupancy, co-tenants and thermal
state.  ``OnlineFeedback`` closes the loop — every chunk an
``AdaptiveExecutor`` runs is timed and handed to the ``ExecutionModel``
engine's online-refinement policy (core/model.py), which smooths it into
the same ``CalibrationCache`` entry the acc policy reads and upgrades
the key's provenance to ``online``, so the *next* decision sees the
drifted reality.  This class is the executor-side *collector*; the EMA
itself is the engine's ``refine`` policy.

Producers tag work with a workload key:

    thunk.__workload_key__ = ("serve_prefill", cfg.name)
    thunk.__workload_elems__ = 128        # for then_execute continuations

``bulk_async_execute`` infers the element count from each ``Chunk``;
``then_execute`` (single continuation, no chunk) needs the explicit
``__workload_elems__`` tag.  **Untagged work passes through untimed**:
instrumenting anonymous thunks would merge unrelated workloads under one
junk key and — worse — perturb the very probes ``measure_t0_empty_task``
dispatches through the same executor to calibrate T0.

Timed thunks must synchronise internally (``torch.cuda.synchronize``):
an async launch would record launch cost, not compute, as t_iter.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Hashable

from .calibration import DEFAULT_SMOOTHING, CalibrationCache
from .model import ExecutionModel

WORKLOAD_KEY_ATTR = "__workload_key__"
WORKLOAD_ELEMS_ATTR = "__workload_elems__"


def tag_workload(fn: Callable, key: Hashable,
                 elems: int | None = None) -> Callable:
    """Annotate ``fn`` so executors attribute its timings to ``key``."""
    fn.__workload_key__ = key
    if elems is not None:
        fn.__workload_elems__ = int(elems)
    return fn


def workload_key_of(fn: Callable) -> Hashable | None:
    """The telemetry key ``fn`` was tagged with, or None (untimed)."""
    return getattr(fn, WORKLOAD_KEY_ATTR, None)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One timed chunk: ``seconds`` of wall-clock over ``elems`` elements."""

    key: Hashable
    elems: int
    seconds: float

    @property
    def per_elem(self) -> float:
        return self.seconds / max(self.elems, 1)


class OnlineFeedback:
    """Collects chunk timings and smooths them into a calibration cache.

    A recent-observation ring is kept for inspection (benchmarks print
    it; tests assert convergence) — the cache itself only ever holds the
    smoothed scalar per key.
    """

    def __init__(self, cache: CalibrationCache | None = None,
                 alpha: float = DEFAULT_SMOOTHING, history: int = 512):
        self.cache = cache if cache is not None else CalibrationCache()
        self.model = ExecutionModel.of(self.cache)
        self.alpha = alpha
        self.observations: collections.deque[Observation] = \
            collections.deque(maxlen=history)

    def observe(self, key: Hashable, elems: int,
                seconds: float) -> float | None:
        """Record one chunk timing; returns the new smoothed t_iter."""
        if elems <= 0 or seconds <= 0.0:
            return None
        obs = Observation(key, int(elems), float(seconds))
        self.observations.append(obs)
        return self.model.observe(key, obs.elems, obs.seconds,
                                  alpha=self.alpha)

    def t_iter(self, key: Hashable) -> float | None:
        """The smoothed per-element time currently backing ``key``."""
        return self.model.smoothed_t_iter(key)

    def count(self, key: Hashable | None = None) -> int:
        if key is None:
            return len(self.observations)
        return sum(1 for o in self.observations if o.key == key)

    # -- instrumentation helpers used by AdaptiveExecutor --------------------
    def timed_chunk_fn(self, fn: Callable[[Any], Any]) -> Callable[[Any], Any]:
        """Wrap a *tagged* bulk chunk thunk: time each call, attribute
        ``chunk.size`` elements to its workload key.  Untagged thunks
        pass through untouched, and so does any individual call whose
        chunk object carries no ``.size``: attributing a default element
        count (e.g. 1) would divide real seconds by a fake denominator
        and poison the smoothed per-element time for every later
        decision on that key."""
        key = workload_key_of(fn)
        if key is None:
            return fn

        def timed(chunk):
            size = getattr(chunk, "size", None)
            if size is None:
                return fn(chunk)
            t = time.perf_counter()
            out = fn(chunk)
            self.observe(key, size, time.perf_counter() - t)
            return out

        timed.__name__ = getattr(fn, "__name__", "chunk_fn")
        return timed

    def timed_continuation(self, fn: Callable[[Any], Any]
                           ) -> Callable[[Any], Any]:
        """Wrap a ``then_execute`` continuation if it carries an element
        count; untagged continuations pass through untimed (their element
        count is unknowable here)."""
        elems = getattr(fn, WORKLOAD_ELEMS_ATTR, None)
        key = workload_key_of(fn)
        if not elems or key is None:
            return fn

        def timed(value):
            t = time.perf_counter()
            out = fn(value)
            self.observe(key, elems, time.perf_counter() - t)
            return out

        timed.__name__ = getattr(fn, "__name__", "continuation")
        return timed
