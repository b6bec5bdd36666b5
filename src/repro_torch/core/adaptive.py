"""``AdaptiveExecutor`` — the paper's adaptivity fused into the executor.

The v1 API made callers thread the acc execution-parameters object through
every algorithm call (``par.on(ex).with_(AdaptiveCoreChunk())``).  HPX's
Smart Executors instead *are* the adaptation: you hand the algorithm an
executor and the runtime machinery hides behind it.  ``AdaptiveExecutor``
is that executor: it wraps any backend, carries an ``AdaptiveCoreChunk``
as its ``params`` annotation, and overloads the three customization points
via the existing attribute-lookup dispatch (core/customization.py rule 2),
so

    par.on(adaptive(HostParallelExecutor()))

gives paper-style adaptation with zero algorithm-signature changes and
makes the *same* core/chunk decisions as an explicitly-passed acc object
(asserted by tests/test_executor_v2.py).

Execution functions delegate to the wrapped executor; ``inner`` is public
so ``unwrap_executor`` / ``mesh_executor_of`` see through the wrapper.
"""
from __future__ import annotations

from typing import Any, Hashable

from .acc import AdaptiveCoreChunk
from .executor import ExecutorBase, Future
from .feedback import OnlineFeedback
from .properties import ExecutorAnnotations, PropertySupport


class AdaptiveExecutor(ExecutorBase, PropertySupport):
    """Wrap ``inner`` with acc-driven core/chunk adaptation.

    Every bulk chunk and tagged continuation is wall-clocked and fed to an
    ``OnlineFeedback`` recorder (core/feedback.py) that smooths the
    observation into the acc object's ``CalibrationCache`` — callers get
    drift-tracking t_iter for free just by running work through the
    executor.  Pass ``feedback=None`` explicitly to disable telemetry.
    """

    _SENTINEL = object()

    def __init__(self, inner: Any, params: Any = None,
                 feedback: OnlineFeedback | None | object = _SENTINEL):
        self.inner = inner
        self._annotations = ExecutorAnnotations(
            params=params if params is not None else AdaptiveCoreChunk())
        if feedback is AdaptiveExecutor._SENTINEL:
            cache = getattr(self.params, "cache", None)
            feedback = OnlineFeedback(cache) if cache is not None else None
        self.feedback = feedback

    @property
    def params(self) -> Any:
        """The execution-parameters object this executor adapts with."""
        return self.annotations.params

    def with_params(self, params: Any):
        """Rebinding params must also rebind the feedback recorder: the
        timings have to land in the cache the *new* acc object reads, not
        the one the clone inherited from the original."""
        clone = super().with_params(params)
        cache = getattr(params, "cache", None)
        clone.feedback = OnlineFeedback(cache) if cache is not None else None
        return clone

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"AdaptiveExecutor({self.inner!r})"

    # -- execution functions: delegate to the wrapped backend ---------------
    def num_units(self) -> int:
        return self.inner.num_units()

    def sync_execute(self, fn, *args) -> Any:
        return self.inner.sync_execute(fn, *args)

    def async_execute(self, fn, *args) -> Future:
        return self.inner.async_execute(fn, *args)

    def bulk_async_execute(self, fn, chunks) -> list[Future]:
        if self.feedback is not None:
            fn = self.feedback.timed_chunk_fn(fn)
        return self.inner.bulk_async_execute(fn, chunks)

    def then_execute(self, fn, future: Future) -> Future:
        if self.feedback is not None:
            fn = self.feedback.timed_continuation(fn)
        return self.inner.then_execute(fn, future)

    # -- customization points (executor-level overloads; the dispatch rule
    # -- calls these without a leading params/executor argument) ------------
    def measure_iteration(self, body: Any, count: int,
                          key: Hashable | None = None) -> float:
        return self.params.measure_iteration(self, body, count, key=key)

    def processing_units_count(self, t_iter: float, count: int) -> int:
        return self.params.processing_units_count(self, t_iter, count)

    def get_chunk_size(self, t_iter: float, cores: int, count: int) -> int:
        return self.params.get_chunk_size(self, t_iter, cores, count)


def adaptive(executor: Any, params: Any = None) -> AdaptiveExecutor:
    """``par.on(adaptive(ex))`` — the one-word opt-in to adaptation."""
    if isinstance(executor, AdaptiveExecutor):
        return executor if params is None else AdaptiveExecutor(
            executor.inner, params)
    return AdaptiveExecutor(executor, params)
