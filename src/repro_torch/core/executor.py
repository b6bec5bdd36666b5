"""Executors: where chunks actually run (v2, HPX-faithful surface).

Three backends share one protocol of four *execution functions*, mirroring
``hpx::parallel::execution``:

* ``sync_execute(fn, *args)``          — run one task, return its value;
* ``async_execute(fn, *args)``         — run one task, return a ``Future``;
* ``bulk_async_execute(fn, chunks)``   — one task per chunk, list of futures;
* ``then_execute(fn, future)``         — continuation: run ``fn`` on the
  future's value through this executor, return the chained future.

``bulk_sync_execute`` (the v1 sync surface, deprecated in the v2 API
release) has been **removed**: accessing it raises ``AttributeError``
with a pointer to the ``when_all(bulk_async_execute(...))`` spelling.

Backends:

* ``SequentialExecutor``  — in-order, inline, no parallel overhead.
* ``HostParallelExecutor``— a thread pool over chunk thunks.  On the CPU
  a thunk runs PyTorch ops, which release the GIL, so on a multi-core host
  this is genuine parallelism; on the card a thunk launches a kernel on
  the caller's stream and waits for it (algorithms/detail.py binds the
  stream), so the pool overlaps the host side of the chunks.  It is the
  faithful analogue of HPX's thread pool.  Supports ``with`` for
  deterministic pool shutdown.
* ``MeshExecutor``        — a device mesh.  It does not run Python
  thunks per chunk (that would serialize an SPMD program); bulk execution
  raises ``UnsupportedOperation`` (the mesh backend of the port is
  still to come).  It carries the mesh and exposes the unit count and
  sub-mesh selection used by that backend and the training/serving loops.

Executors may overload customization points simply by defining methods of
the same name (see core/customization.py); ``AdaptiveExecutor``
(core/adaptive.py) is the executor that does.  Properties/annotations
(``with_priority`` / ``with_hint`` / ``with_params``) come from the
``PropertySupport`` mixin (core/properties.py).
"""
from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

from .future import Future
from .properties import PropertySupport


class UnsupportedOperation(RuntimeError):
    """An execution function this executor cannot meaningfully provide."""


@dataclasses.dataclass(frozen=True)
class Chunk:
    """Half-open element range [start, start + size) assigned to one task."""

    start: int
    size: int


def make_chunks(count: int, chunk_elems: int) -> list[Chunk]:
    """Split ``count`` elements into tasks of ``chunk_elems`` (last partial)."""
    if count <= 0:
        return []
    chunk_elems = max(int(chunk_elems), 1)
    return [
        Chunk(start, min(chunk_elems, count - start))
        for start in range(0, count, chunk_elems)
    ]


@runtime_checkable
class Executor(Protocol):
    def num_units(self) -> int: ...

    def sync_execute(self, fn: Callable[..., Any], *args: Any) -> Any: ...

    def async_execute(self, fn: Callable[..., Any], *args: Any) -> Future: ...

    def bulk_async_execute(
        self, fn: Callable[[Chunk], Any], chunks: Sequence[Chunk]
    ) -> list[Future]: ...

    def then_execute(
        self, fn: Callable[[Any], Any], future: Future
    ) -> Future: ...


class ExecutorBase:
    """Default execution functions, all derived from ``async_execute``
    (inline, on the calling thread).  Backends override the primitives
    they can do better — exactly HPX's executor-customization design."""

    def sync_execute(self, fn: Callable[..., Any], *args: Any) -> Any:
        return self.async_execute(fn, *args).result()

    def async_execute(self, fn: Callable[..., Any], *args: Any) -> Future:
        return Future.from_call(fn, *args)

    def bulk_async_execute(self, fn, chunks) -> list[Future]:
        return [self.async_execute(fn, c) for c in chunks]

    def then_execute(self, fn: Callable[[Any], Any], future: Future) -> Future:
        return future.then(fn, executor=self)

    # -- removed v1 surface --------------------------------------------------
    def __getattr__(self, name: str):
        # Only reached when normal attribute lookup fails.  The v1
        # bulk_sync_execute shim (deprecated through the v2 API release)
        # is gone; fail hard with the migration pointer instead of a
        # generic AttributeError.
        if name == "bulk_sync_execute":
            raise AttributeError(
                "bulk_sync_execute was removed from the executor API; use "
                "when_all(executor.bulk_async_execute(fn, chunks)).result() "
                "(repro_torch.core.when_all)")
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")


class SequentialExecutor(ExecutorBase, PropertySupport):
    """Runs every task in order on the calling thread; futures come back
    already resolved (``seq`` policy)."""

    def num_units(self) -> int:
        return 1


class HostParallelExecutor(ExecutorBase, PropertySupport):
    """Thread pool over chunk thunks (HPX thread-pool analogue).

    ``max_workers`` bounds the pool; the *effective* unit count for a given
    workload is decided by the execution-parameters object (e.g. acc) via
    the chunk count of each bulk call — the pool never runs more chunks
    concurrently than it has workers.

    Use as a context manager for deterministic pool shutdown::

        with HostParallelExecutor(max_workers=4) as ex:
            futs = ex.bulk_async_execute(thunk, chunks)
            outs = when_all(futs).result()

    ``__del__`` remains as a best-effort backstop only.
    """

    def __init__(self, max_workers: int | None = None):
        import os

        self._max_workers = max_workers or (os.cpu_count() or 1)
        self._pool: _cf.ThreadPoolExecutor | None = None
        self._owns_pool = True

    def __copy__(self) -> "HostParallelExecutor":
        # Property annotation clones share the pool but must not tear it
        # down when garbage-collected (only explicit shutdown/__exit__ or
        # the owning instance's __del__ may).
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone._owns_pool = False
        return clone

    def num_units(self) -> int:
        return self._max_workers

    def _ensure_pool(self) -> _cf.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = _cf.ThreadPoolExecutor(max_workers=self._max_workers)
            self._owns_pool = True
        return self._pool

    def async_execute(self, fn, *args) -> Future:
        return Future(self._ensure_pool().submit(fn, *args))

    def bulk_async_execute(self, fn, chunks) -> list[Future]:
        if len(chunks) <= 1:
            # Degenerate bulk: inline, no dispatch overhead.
            return [Future.from_call(fn, c) for c in chunks]
        pool = self._ensure_pool()
        return [Future(pool.submit(fn, c)) for c in chunks]

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "HostParallelExecutor":
        self._ensure_pool()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()

    def __del__(self):  # pragma: no cover - best-effort cleanup
        try:
            if getattr(self, "_owns_pool", True):
                self.shutdown()
        except Exception:
            pass


class MeshExecutor(ExecutorBase, PropertySupport):
    """Executor view of a device mesh: any object with a ``shape``
    mapping axis names to sizes.  A ``launch.mesh.Mesh`` (ranks of a
    ``torch.distributed`` job) runs the parallel algorithms' mesh path
    (``algorithms/detail.mesh_*``); a shape alone (``launch.mesh.
    HostMesh``, a stub) answers ``num_units`` / ``submesh_size`` for the
    plans that read them (``train.autotune.choose_plan``).

    ``data_axes`` are the axes over which a data-parallel workload may be
    spread; ``num_units`` is their total extent.  ``submesh_size(n)`` maps
    an acc core-count decision onto a realisable device count (a divisor of
    the full extent, so shardings stay regular).

    On a distributed mesh, ``subgroup(cores)`` reads the process group
    over the mesh's first ``submesh_size(cores)`` ranks (the reference's
    ``submesh_1d`` takes the first ``cores`` devices), which the mesh
    made with its other groups (``launch.mesh.Mesh.subgroups``):
    ``dist.new_group`` is itself a collective, and made lazily after a
    rank-local decision it would deadlock.  Construction enters no
    collective.

    Bulk execution of Python thunks is *not* provided: running one thunk
    per chunk on the host would serialize what the mesh runs SPMD, which
    is a silent performance bug, so ``bulk_async_execute`` /
    ``bulk_sync_execute`` raise ``UnsupportedOperation``.  Single-task
    ``sync_execute`` / ``async_execute`` / ``then_execute`` run inline on
    the host (they launch whole programs, not per-chunk work).
    """

    def __init__(self, mesh, data_axes: tuple[str, ...] = ("data",)):
        self.mesh = mesh
        self.data_axes = tuple(a for a in data_axes if a in mesh.shape)
        n = 1
        for a in self.data_axes:
            n *= mesh.shape[a]
        self._units = n

    def subgroup(self, cores: int) -> tuple[Any, tuple[int, ...]]:
        """(this rank's process group over the first ``cores`` ranks, or
        None when it is not one of them; those ranks)."""
        subgroups = getattr(self.mesh, "subgroups", None)
        if not subgroups:
            raise ValueError(
                "this MeshExecutor's mesh has no process group (a shape "
                "alone): the mesh path needs a launch.mesh.Mesh, made with "
                "make_mesh under torch.distributed")
        return subgroups[self.submesh_size(cores)]

    def num_units(self) -> int:
        return self._units

    def submesh_size(self, n_cores: int) -> int:
        """Largest divisor of the data extent that is <= n_cores (>= 1)."""
        n_cores = max(min(int(n_cores), self._units), 1)
        for d in range(n_cores, 0, -1):
            if self._units % d == 0:
                return d
        return 1

    def bulk_async_execute(self, fn, chunks):
        raise UnsupportedOperation(
            "MeshExecutor does not run per-chunk Python thunks (that would "
            "serialize an SPMD program on the host). Use the mesh "
            "backend: repro_torch.algorithms.detail.mesh_map / "
            "mesh_map_with_left_halo / mesh_reduce / mesh_scan over an "
            "acc-sized sub-group.")

    def bulk_sync_execute(self, fn, chunks):
        # Deliberately not the deprecation shim: fail loudly either way.
        self.bulk_async_execute(fn, chunks)


def unwrap_executor(executor: Any) -> Any:
    """Innermost executor of a wrapper chain (``inner`` attributes)."""
    seen = set()
    while id(executor) not in seen:
        seen.add(id(executor))
        inner = getattr(executor, "inner", None)
        if inner is None:
            return executor
        executor = inner
    return executor


def mesh_executor_of(executor: Any) -> MeshExecutor | None:
    """The ``MeshExecutor`` behind ``executor`` (itself or through
    wrappers such as ``AdaptiveExecutor``), or None."""
    ex = unwrap_executor(executor)
    return ex if isinstance(ex, MeshExecutor) else None
