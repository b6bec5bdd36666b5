"""tag_invoke-style customization points (paper Section 4.1/4.2).

HPX dispatches its algorithm-internal hooks through ``tag_invoke``: a
callable tag object finds, via ADL, an overload supplied by either the
*execution parameters* object or the *executor*, falling back to a default.
Python has no ADL; the equivalent dispatch rule here is attribute lookup,
in priority order:

    1. a method named after the tag on the execution-parameters object,
    2. a method named after the tag on the executor,
    3. the registered default implementation.

This preserves the property the paper leans on: new behaviour (the acc
object) plugs into the unchanged algorithm implementations purely by
defining the three methods — no algorithm code changes.
"""
from __future__ import annotations

from typing import Any, Callable


class CustomizationPoint:
    """A named, overloadable hook ("tag" in tag_invoke terms)."""

    def __init__(self, name: str, default: Callable[..., Any]):
        self.name = name
        self._default = default

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<customization point {self.name}>"

    def __call__(self, params: Any, executor: Any, *args: Any, **kw: Any) -> Any:
        impl = getattr(params, self.name, None)
        if callable(impl):
            return impl(executor, *args, **kw)
        impl = getattr(executor, self.name, None)
        if callable(impl):
            return impl(*args, **kw)
        return self._default(params, executor, *args, **kw)


# ---------------------------------------------------------------------------
# Defaults (paper: "The default implementations for these customization
# points splits the work into equally sized chunks while utilizing all
# available processing units.")
#
# Both defaults delegate to the ExecutionModel's analytic prior policy
# at zero measured cost and one chunk per core — the Overhead Law
# degenerates to exactly the paper's default there (all units, equal
# chunks, never more units than chunks).  One formula, one owner;
# previously these were a drifting reimplementation of the same math.
# ---------------------------------------------------------------------------

def _default_measure_iteration(params, executor, body, count: int) -> float:
    """Default: no measurement — report zero cost so the default policy
    (all units, equal chunks) is used unchanged."""
    return 0.0


def _default_units(executor) -> int:
    units = getattr(executor, "num_units", None)
    if callable(units):
        return max(int(units()), 1)
    return 1


def _default_processing_units_count(params, executor, t_iter: float, count: int) -> int:
    from .model import default_cores_chunk

    return default_cores_chunk(count, _default_units(executor)).n_cores


def _default_get_chunk_size(params, executor, t_iter: float, cores: int, count: int) -> int:
    from .model import default_cores_chunk

    return default_cores_chunk(count, max(int(cores), 1)).chunk_elems


measure_iteration = CustomizationPoint(
    "measure_iteration", _default_measure_iteration)
processing_units_count = CustomizationPoint(
    "processing_units_count", _default_processing_units_count)
get_chunk_size = CustomizationPoint(
    "get_chunk_size", _default_get_chunk_size)
