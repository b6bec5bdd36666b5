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

The mesh path, taken when the bound executor is — or wraps — a
``MeshExecutor`` over a ``launch.mesh.Mesh``, is the reference's
shard_map over an acc-sized sub-mesh done by hand: every rank of the
job runs the algorithm (SPMD) on the same input; the acc decision is
taken on mesh rank 0 and broadcast (``Mesh.agree``: its measured t_iter
would differ from rank to rank); each rank of the first ``cores`` ranks
(``MeshExecutor.subgroup``) runs its block through the same chunk bodies
as the host path (kernels 4–7 for the default operators over float32 /
bfloat16); the halo moves to the right neighbour by send/recv, a scan's
block totals by ``all_gather``, a sum by ``all_reduce``; and the result
is ``all_gather``-ed so that every rank returns the whole array, as the
reference returns a global one (ranks outside the sub-group receive it
by broadcast).

Execution parameters resolve from the policy first, then from the
executor's ``params`` annotation — that second step is what makes
``par.on(adaptive(ex))`` equivalent to ``par.on(ex).with_(acc)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from .. import collectives
from ..collectives import all_gather_into
from ..core import customization as cp
from ..core.calibration import DeviceBody
from ..core.executor import (Chunk, SequentialExecutor, make_chunks,
                             mesh_executor_of)
from ..core.future import when_all
from ..core.model import ExecutionModel
from ..core.policy import ExecutionPolicy

__all__ = ["Plan", "plan", "on_stream", "measured_body", "run_map_chunks",
           "run_reduce_chunks", "mesh_executor_of", "submesh_1d", "pad_to",
           "mesh_map", "mesh_map_with_left_halo", "mesh_scan",
           "mesh_reduce"]


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
    mexec = mesh_executor_of(executor)
    if mexec is not None:
        mexec.subgroup(1)       # raises for a mesh with no process group
    if key is None and getattr(body, "name", None) is not None \
            and not callable(body):
        key = ("algorithm", body.name)   # WorkloadProfile-style bodies
    kw = {"key": key} if (key is not None and params is not None
                          and hasattr(params, "measure_iteration")) else {}

    def decide():
        t_iter = cp.measure_iteration(params, executor, body, count, **kw)
        cores = cp.processing_units_count(params, executor, t_iter, count)
        chunk = cp.get_chunk_size(params, executor, t_iter, cores, count)
        return t_iter, cores, chunk

    if mexec is None:
        t_iter, cores, chunk = decide()
    else:
        cache = getattr(params, "cache", None)
        t_iter, cores, chunk = mexec.mesh.agree(
            decide, None if cache is None else ExecutionModel.of(cache))
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


# ---------------------------------------------------------------------------
# Mesh path helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubMesh:
    """The first ``cores`` ranks of a ``MeshExecutor``'s mesh: this
    rank's group over them (None outside) and its index among them."""

    mexec: Any
    cores: int
    group: Any
    ranks: tuple[int, ...]

    @property
    def index(self) -> int:
        return self.ranks.index(dist.get_rank())


def submesh_1d(mexec, cores: int) -> SubMesh:
    """The 1-d sub-group over the mesh's first ``cores`` ranks (``cores``
    snapped to a divisor of the data extent, whose group the executor
    made at construction)."""
    cores = mexec.submesh_size(cores)
    group, ranks = mexec.subgroup(cores)
    return SubMesh(mexec, cores, group, tuple(ranks))


def _block(sub: SubMesh, xp: torch.Tensor) -> torch.Tensor:
    return xp.chunk(sub.cores)[sub.index]


def _gather(sub: SubMesh, blk: torch.Tensor | None) -> torch.Tensor:
    """Every member's equal-length block, concatenated in rank order, on
    every rank of the mesh (members by ``all_gather``; the others by a
    broadcast from the sub-group's first rank over the whole mesh)."""
    out = None
    if sub.group is not None:
        blk = blk.contiguous()
        out = torch.empty((sub.cores * blk.shape[0],) + tuple(blk.shape[1:]),
                          dtype=blk.dtype, device=blk.device)
        all_gather_into(out, blk, group=sub.group)
    mesh = sub.mexec.mesh
    if sub.cores == mesh.size:
        return out
    box = [None if out is None else (tuple(out.shape), out.dtype)]
    dist.broadcast_object_list(box, src=sub.ranks[0], group=mesh.ctrl)
    if out is None:
        shape, dtype = box[0]
        out = torch.empty(shape, dtype=dtype, device=mesh.device)
    collectives.broadcast(out, sub.ranks[0], mesh.whole)
    return out


def mesh_map(mexec, cores: int, shard_fn: Callable, *xs: torch.Tensor,
             fill=0) -> torch.Tensor:
    """Elementwise map over an acc-chosen sub-group: each member maps its
    block of the padded inputs (``shard_fn(*blocks)``), and the blocks
    are gathered."""
    sub = submesh_1d(mexec, cores)
    padded = [pad_to(x, sub.cores, fill) for x in xs]
    n = padded[0][1]
    blk = None
    if sub.group is not None:
        blk = shard_fn(*(_block(sub, xp) for xp, _ in padded))
    return _gather(sub, blk)[:n]


def _halo(sub: SubMesh, send: torch.Tensor, shift: int) -> torch.Tensor:
    """``send`` from each member to the member ``shift`` places on,
    cyclically (the reference's ppermute); what this rank receives.  A
    one-member sub-group receives its own."""
    i, c = sub.index, sub.cores
    if c == 1:
        return send.clone()
    recv = torch.empty_like(send)
    collectives.send_recv(send.contiguous(), sub.ranks[(i + shift) % c],
                          recv, sub.ranks[(i - shift) % c], sub.group)
    return recv


def mesh_map_with_left_halo(mexec, cores: int, shard_fn: Callable,
                            x: torch.Tensor, fill=0) -> torch.Tensor:
    """Map where each block also needs its left neighbour's last element
    (adjacent_difference).  The halo moves one member to the right;
    ``shard_fn(block, left_halo, index)``."""
    sub = submesh_1d(mexec, cores)
    xp, n = pad_to(x, sub.cores, fill)
    blk = None
    if sub.group is not None:
        xl = _block(sub, xp)
        left = _halo(sub, xl[-1:], 1)
        blk = shard_fn(xl, left, sub.index)
    return _gather(sub, blk)[:n]


def mesh_halo_map(mexec, cores: int, shard_fn: Callable, x: torch.Tensor,
                  fill=0) -> torch.Tensor:
    """Map where each block needs one element from each neighbour (the
    3-point stencil): ``shard_fn(left + block + right)`` over the block
    extended by both halos (cyclic at the ends, as the reference's two
    ppermutes)."""
    sub = submesh_1d(mexec, cores)
    xp, n = pad_to(x, sub.cores, fill)
    blk = None
    if sub.group is not None:
        xl = _block(sub, xp)
        left = _halo(sub, xl[-1:], 1)
        right = _halo(sub, xl[:1], -1)
        blk = shard_fn(torch.cat([left, xl, right]))
    return _gather(sub, blk)[:n]


def mesh_scan(mexec, cores: int, x: torch.Tensor, local_scan: Callable,
              local_total: Callable, apply_offset: Callable,
              identity) -> torch.Tensor:
    """Distributed prefix sum: block-local scan, ``all_gather`` of the
    block totals, each block's offset from an exclusive scan of them."""
    sub = submesh_1d(mexec, cores)
    ident = torch.as_tensor(identity, dtype=x.dtype)
    xp, n = pad_to(x, sub.cores, ident.item())
    blk = None
    if sub.group is not None:
        xl = _block(sub, xp)
        scanned = local_scan(xl)
        total = local_total(xl).reshape(1).to(x.dtype)
        totals = torch.empty(sub.cores, dtype=total.dtype,
                             device=total.device)
        all_gather_into(totals, total, group=sub.group)
        mask = torch.arange(sub.cores, device=totals.device) < sub.index
        offset = local_total(torch.where(mask, totals,
                                         ident.to(totals.device)))
        blk = apply_offset(scanned, offset)
    return _gather(sub, blk)[:n]


# Operators a sum-like all_reduce combines exactly as ``op`` would.
_REDUCE_OPS = {torch.add: dist.ReduceOp.SUM, torch.mul: dist.ReduceOp.PRODUCT,
               torch.minimum: dist.ReduceOp.MIN,
               torch.maximum: dist.ReduceOp.MAX}


def mesh_reduce(mexec, cores: int, x: torch.Tensor, local_partial: Callable,
                identity, op: Callable) -> torch.Tensor:
    """Block-local partials combined over the sub-group: by ``all_reduce``
    for add / mul / minimum / maximum, else gathered (the reference's
    (cores,) partials) and folded with ``op`` in rank order; on every
    rank of the mesh."""
    sub = submesh_1d(mexec, cores)
    ident = torch.as_tensor(identity)
    xp, _ = pad_to(x, sub.cores, ident.item())
    part = None
    if sub.group is not None:
        part = local_partial(_block(sub, xp)).reshape(1)
        if op in _REDUCE_OPS and part.dtype != torch.bool:
            collectives.all_reduce(part, sub.group, op=_REDUCE_OPS[op])
    parts = _gather(sub, part)
    if op in _REDUCE_OPS and parts.dtype != torch.bool:
        return parts[0]
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc
