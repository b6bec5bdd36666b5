"""Shared machinery for the parallel-algorithm suite.

Every algorithm follows the paper's call sequence (Listing 1.1):

    t_iter = measure_iteration(params, exec, body, count)
    cores  = processing_units_count(params, exec, t_iter, count)
    chunk  = get_chunk_size(params, exec, t_iter, cores, count)

then dispatches its chunk thunks with ``bulk_async_execute`` on the
policy's executor and joins them with ``when_all``.  On a CUDA tensor a
thunk launches its chunk's work on the stream that was current when the
algorithm was called (a worker thread would otherwise start on the
default stream, unordered after the input's producer) and returns only
once that work has finished on the card: it records an event and waits
on it, which blocks its own worker alone, so the executor's feedback
times execution, not the launch.  ``measure_iteration`` times a sample
chunk's work on the card between CUDA events: its per-element time then
holds no launch or wait, which are per-task costs like T0's.  Chunks
from several workers interleave on that one stream.

The reference's mesh path (shard_map over an acc-sized sub-mesh) is not
ported: a parallel policy whose executor is or wraps a ``MeshExecutor``
raises ``NotImplementedError`` (ROADMAP A.6, multi-GPU).

Execution parameters resolve from the policy first, then from the
executor's ``params`` annotation — that second step is what makes
``par.on(adaptive(ex))`` equivalent to ``par.on(ex).with_(acc)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core import customization as cp
from ..core.calibration import DeviceBody
from ..core.executor import (Chunk, SequentialExecutor, make_chunks,
                             mesh_executor_of)
from ..core.future import when_all
from ..core.policy import ExecutionPolicy

__all__ = ["Plan", "plan", "on_stream", "measured_body", "run_map_chunks",
           "run_reduce_chunks", "pad_to"]


@dataclasses.dataclass
class Plan:
    executor: Any
    params: Any
    t_iter: float
    cores: int
    chunk_elems: int
    chunks: list[Chunk]

    @property
    def parallel(self) -> bool:
        return self.cores > 1 and len(self.chunks) > 1


def plan(policy: ExecutionPolicy, count: int,
         body: Callable[[int, int], Any] | Any = None,
         key: Any = None) -> Plan:
    """Run the three customization points and build the chunk list.

    The key (explicit, or derived from an analytic profile's name)
    labels the decision in the ExecutionModel trace and is where online
    feedback for this workload accumulates."""
    executor = policy.resolve_executor()
    params = policy.resolve_params(executor)
    if not policy.allows_parallel or count <= 1:
        return Plan(SequentialExecutor(), params, 0.0, 1, max(count, 1),
                    make_chunks(count, max(count, 1)))
    if mesh_executor_of(executor) is not None:
        raise NotImplementedError(
            "the parallel algorithms' mesh path is not ported yet "
            "(ROADMAP A.6, multi-GPU); use a HostParallelExecutor")
    if key is None and getattr(body, "name", None) is not None \
            and not callable(body):
        key = ("algorithm", body.name)   # WorkloadProfile-style bodies
    kw = {"key": key} if (key is not None and params is not None
                          and hasattr(params, "measure_iteration")) else {}
    t_iter = cp.measure_iteration(params, executor, body, count, **kw)
    cores = cp.processing_units_count(params, executor, t_iter, count)
    chunk = cp.get_chunk_size(params, executor, t_iter, cores, count)
    return Plan(executor, params, t_iter, cores, chunk,
                make_chunks(count, chunk))


def on_stream(fn: Callable[..., Any], x: torch.Tensor) -> Callable[..., Any]:
    """``fn`` bound to the stream current now on ``x``'s card, returning
    only once the work it queued there has finished.  ``fn`` itself for
    a CPU tensor."""
    if x.device.type != "cuda":
        return fn
    stream = torch.cuda.current_stream(x.device)

    def run(*args):
        with torch.cuda.stream(stream):
            out = fn(*args)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return out

    return run


def measured_body(chunk_fn: Callable, *arrays: torch.Tensor):
    """Wrap a chunk function into the body(start, size) thunk that
    ``measure_iteration`` times.  Calling it returns once the chunk has
    finished.  For a CUDA tensor it is a ``DeviceBody`` on the stream
    current now, which the acc object times between CUDA events."""
    def body(start: int, size: int):
        return chunk_fn(*(a[start:start + size] for a in arrays))

    x = arrays[0]
    if x.device.type != "cuda":
        return body
    return DeviceBody(body, torch.cuda.current_stream(x.device))


def run_map_chunks(plan_: Plan, chunk_fn: Callable,
                   *arrays: torch.Tensor) -> torch.Tensor:
    """Elementwise chunked execution + concatenation."""
    if not plan_.parallel:
        return chunk_fn(*arrays)

    def chunk(c: Chunk):
        return chunk_fn(*(a[c.start:c.start + c.size] for a in arrays))

    futs = plan_.executor.bulk_async_execute(on_stream(chunk, arrays[0]),
                                             plan_.chunks)
    return torch.cat(when_all(futs).result())


def run_reduce_chunks(plan_: Plan, partial_fn: Callable,
                      combine: Callable[[Any, Any], Any],
                      *arrays: torch.Tensor) -> Any:
    """Two-phase reduction: parallel chunk partials, serial combine."""
    if not plan_.parallel:
        return partial_fn(*arrays)

    def chunk(c: Chunk):
        return partial_fn(*(a[c.start:c.start + c.size] for a in arrays))

    partials = when_all(plan_.executor.bulk_async_execute(
        on_stream(chunk, arrays[0]), plan_.chunks)).result()
    acc = partials[0]
    for p in partials[1:]:
        acc = combine(acc, p)
    return acc


def pad_to(x: torch.Tensor, multiple: int, fill=0) -> tuple[torch.Tensor, int]:
    """x padded along dim 0 with ``fill`` to a multiple of ``multiple``,
    and its original length."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = torch.full((rem,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad]), n
