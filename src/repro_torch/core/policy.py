"""Execution policies mirroring hpx::execution / std::execution.

``seq``/``par``/``unseq``/``par_unseq`` singletons; ``.on(executor)`` binds
an executor, ``.with_(params)`` binds an execution-parameters object (the
acc object, a static-chunk object, ...).  Algorithms receive a policy as
their first argument, exactly like the C++ parallel algorithms.

``with_`` is one instance of the general executor-property mechanism
(core/properties.py): it is ``prefer(with_params, policy, params)``, which
resolves through the frozen-dataclass field and so round-trips through
``dataclasses.replace``.  ``with_priority`` / ``with_hint`` forward to the
bound executor's property hooks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from . import properties


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    kind: str                      # "seq" | "par" | "unseq" | "par_unseq"
    executor: Any = None
    params: Any = None

    def on(self, executor: Any) -> "ExecutionPolicy":
        return dataclasses.replace(self, executor=executor)

    def with_(self, params: Any) -> "ExecutionPolicy":
        return properties.prefer(properties.with_params, self, params)

    def with_priority(self, priority: str) -> "ExecutionPolicy":
        return self._annotate_executor(properties.with_priority, priority)

    def with_hint(self, hint: Any) -> "ExecutionPolicy":
        return self._annotate_executor(properties.with_hint, hint)

    def _annotate_executor(self, prop, value) -> "ExecutionPolicy":
        if self.executor is None:
            raise ValueError(
                f"policy has no bound executor to annotate; call "
                f".on(executor) before .with_{prop.name}()")
        return dataclasses.replace(
            self, executor=properties.require(prop, self.executor, value))

    @property
    def allows_parallel(self) -> bool:
        return self.kind in ("par", "par_unseq")

    @property
    def allows_vectorization(self) -> bool:
        return self.kind in ("unseq", "par_unseq")

    def resolve_executor(self):
        """Executor to use: bound one, else a policy-appropriate default."""
        if self.executor is not None:
            return self.executor
        from .executor import HostParallelExecutor, SequentialExecutor

        if self.allows_parallel:
            return HostParallelExecutor()
        return SequentialExecutor()

    def resolve_params(self, executor: Any = None):
        """Execution-parameters object: the policy-bound one, else one
        annotated onto the (resolved) executor, else None.  This is the
        hook that lets ``AdaptiveExecutor`` carry the acc object."""
        if self.params is not None:
            return self.params
        return properties.params_of(
            executor if executor is not None else self.executor)


seq = ExecutionPolicy("seq")
par = ExecutionPolicy("par")
unseq = ExecutionPolicy("unseq")
par_unseq = ExecutionPolicy("par_unseq")
