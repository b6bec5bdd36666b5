"""Executor properties / annotations (``hpx::experimental::prefer``).

HPX attaches scheduling metadata to executors through *properties*: a
property tag applied to an executor yields a new executor carrying the
annotation, and ``prefer`` degrades gracefully when the target does not
support the property (``require`` does not).  The dispatch rule here
mirrors the customization-point rule in core/customization.py — attribute
lookup instead of ADL:

    1. a ``with_<name>`` method on the target (executor or policy),
    2. a dataclass field ``<name>`` on the target (``dataclasses.replace``),
    3. otherwise: ``prefer`` returns the target unchanged,
                  ``require`` raises ``UnsupportedProperty``.

``ExecutionPolicy.with_(params)`` is one instance of this mechanism
(property ``params`` via rule 2); executors gain ``with_priority`` /
``with_hint`` / ``with_params`` through the ``PropertySupport`` mixin,
which stores a frozen ``ExecutorAnnotations`` record so annotated clones
round-trip through ``dataclasses.replace`` and never mutate the original.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any


class UnsupportedProperty(TypeError):
    """``require`` on a target that has no hook for the property."""


@dataclasses.dataclass(frozen=True)
class ExecutorAnnotations:
    """The annotation record a ``PropertySupport`` executor carries.

    ``priority`` and ``hint`` are scheduling *preferences* — recorded,
    queryable, and forwarded, but an executor may ignore them (exactly
    ``prefer``'s contract).  ``params`` is load-bearing: an
    execution-parameters object annotated onto an executor is picked up by
    the algorithm planner whenever the policy itself binds none (this is
    how ``AdaptiveExecutor`` fuses the acc object into the executor).
    """

    priority: str = "normal"        # "low" | "normal" | "high"
    hint: Any = None                # free-form scheduling hint
    params: Any = None              # execution-parameters object


_DEFAULT_ANNOTATIONS = ExecutorAnnotations()


class ExecutorProperty:
    """A named property tag.  Calling the tag is ``prefer``:
    ``with_priority(ex, "high")`` == ``prefer(with_priority, ex, "high")``.
    """

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<executor property {self.name}>"

    def __call__(self, target: Any, value: Any) -> Any:
        return prefer(self, target, value)


def _hook(prop: ExecutorProperty, target: Any):
    meth = getattr(target, f"with_{prop.name}", None)
    if callable(meth):
        return lambda value: meth(value)
    if dataclasses.is_dataclass(target) and any(
            f.name == prop.name for f in dataclasses.fields(target)):
        return lambda value: dataclasses.replace(target, **{prop.name: value})
    return None


def prefer(prop: ExecutorProperty, target: Any, value: Any) -> Any:
    """Apply ``prop`` if ``target`` supports it, else return it unchanged."""
    hook = _hook(prop, target)
    return hook(value) if hook is not None else target


def require(prop: ExecutorProperty, target: Any, value: Any) -> Any:
    """Apply ``prop``; raise ``UnsupportedProperty`` if unsupported."""
    hook = _hook(prop, target)
    if hook is None:
        raise UnsupportedProperty(
            f"{type(target).__name__} does not support property "
            f"'{prop.name}' (no with_{prop.name} method or field)")
    return hook(value)


with_priority = ExecutorProperty("priority")
with_hint = ExecutorProperty("hint")
with_params = ExecutorProperty("params")


class PropertySupport:
    """Mixin: frozen-annotation storage + the three standard properties.

    ``with_*`` return a shallow clone carrying the new annotations; the
    original executor is untouched.  Clones of pooled executors share the
    pool (annotation is metadata, not a new resource).
    """

    _annotations: ExecutorAnnotations | None = None

    @property
    def annotations(self) -> ExecutorAnnotations:
        return self._annotations or _DEFAULT_ANNOTATIONS

    def _with_annotations(self, **changes: Any):
        clone = copy.copy(self)
        clone._annotations = dataclasses.replace(self.annotations, **changes)
        return clone

    def with_priority(self, priority: str):
        return self._with_annotations(priority=priority)

    def with_hint(self, hint: Any):
        return self._with_annotations(hint=hint)

    def with_params(self, params: Any):
        return self._with_annotations(params=params)


def params_of(executor: Any) -> Any:
    """The execution-parameters object annotated onto ``executor`` (or one
    of its wrappers), if any.  Walks ``inner`` chains so an annotation on a
    wrapping executor is visible through the wrapper stack."""
    seen = set()
    while executor is not None and id(executor) not in seen:
        seen.add(id(executor))
        ann = getattr(executor, "annotations", None)
        if isinstance(ann, ExecutorAnnotations) and ann.params is not None:
            return ann.params
        executor = getattr(executor, "inner", None)
    return None
