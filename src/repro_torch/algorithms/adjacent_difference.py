"""adjacent_difference — the paper's memory-bound benchmark algorithm.

out[0] = x[0];  out[i] = op(x[i], x[i-1])  (op defaults to subtraction).

Chunked execution needs a one-element left halo per chunk: an interior
chunk reads from one element to its left and keeps ``[1:]`` of the
result.  On a mesh each rank's block takes its halo from its left
neighbour (``adjacent_difference_on_mesh`` over
``detail.mesh_map_with_left_halo``).  With ``op=torch.sub`` over a
float32 or bfloat16 tensor every chunk body is the adjacent_difference
kernel (``kernels.ops``; its plain version for a CPU tensor); other
operators and dtypes run plain PyTorch ops, as the reference runs
jnp.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.future import when_all
from ..kernels import ops
from . import detail
from .reduce import KERNEL_DTYPES


def _bodies(op, x: torch.Tensor) -> tuple[Callable, Callable]:
    """(the first chunk's body, an interior chunk's body over the chunk
    with its one-element left halo): the adjacent_difference kernel for
    subtraction over float32 / bfloat16, else plain ops."""
    if op in (torch.sub, torch.subtract) and x.dtype in KERNEL_DTYPES:
        def interior(c_with_halo):
            return ops.adjacent_difference(c_with_halo)[1:]
        return ops.adjacent_difference, interior

    def whole(c):
        return torch.cat([c[:1], op(c[1:], c[:-1])])

    def interior(c_with_halo):
        return op(c_with_halo[1:], c_with_halo[:-1])
    return whole, interior


def adjacent_difference(policy, x: torch.Tensor,
                        op: Callable = torch.sub) -> torch.Tensor:
    count = x.shape[0]
    if count == 0:
        return x

    whole, interior = _bodies(op, x)
    body = detail.measured_body(whole, x)
    p = detail.plan(policy, count, body, key=("adjdiff", str(x.dtype)))
    if not p.parallel:
        return whole(x)

    mexec = detail.mesh_executor_of(p.executor)
    if mexec is not None:
        return adjacent_difference_on_mesh(mexec, p.cores, x, op)

    def chunk(c):
        if c.start == 0:
            return whole(x[:c.size])
        return interior(x[c.start - 1:c.start + c.size])

    outs = when_all(p.executor.bulk_async_execute(
        detail.on_stream(chunk, x), p.chunks)).result()
    return torch.cat(outs)


def adjacent_difference_on_mesh(mexec, cores: int, x: torch.Tensor,
                                op: Callable = torch.sub) -> torch.Tensor:
    """``adjacent_difference``'s mesh branch: the first rank of the first
    ``cores`` of ``mexec``'s mesh runs the first-chunk body on its block,
    every other one the interior body on its block behind the halo from
    its left neighbour."""
    whole, interior = _bodies(op, x)

    def shard_fn(xl, left, idx):
        if idx == 0:
            return whole(xl)
        return interior(torch.cat([left, xl]))

    return detail.mesh_map_with_left_halo(mexec, cores, shard_fn, x)
