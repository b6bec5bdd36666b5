"""adjacent_difference — the paper's memory-bound benchmark algorithm.

out[0] = x[0];  out[i] = op(x[i], x[i-1])  (op defaults to subtraction).

Chunked execution needs a one-element left halo per chunk: an interior
chunk reads from one element to its left and keeps ``[1:]`` of the
result.  With ``op=torch.sub`` over a float32 or bfloat16 tensor every
chunk body is the adjacent_difference kernel (``kernels.ops``; its plain
version for a CPU tensor); other operators and dtypes run plain PyTorch
ops, as the reference runs jnp.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.future import when_all
from ..kernels import ops
from . import detail
from .reduce import KERNEL_DTYPES


def adjacent_difference(policy, x: torch.Tensor,
                        op: Callable = torch.sub) -> torch.Tensor:
    count = x.shape[0]
    if count == 0:
        return x

    if op in (torch.sub, torch.subtract) and x.dtype in KERNEL_DTYPES:
        whole = ops.adjacent_difference

        def interior(c_with_halo):
            return ops.adjacent_difference(c_with_halo)[1:]
    else:
        def whole(c):
            return torch.cat([c[:1], op(c[1:], c[:-1])])

        def interior(c_with_halo):
            return op(c_with_halo[1:], c_with_halo[:-1])

    body = detail.measured_body(whole, x)
    p = detail.plan(policy, count, body, key=("adjdiff", str(x.dtype)))
    if not p.parallel:
        return whole(x)

    def chunk(c):
        if c.start == 0:
            return whole(x[:c.size])
        return interior(x[c.start - 1:c.start + c.size])

    outs = when_all(p.executor.bulk_async_execute(
        detail.on_stream(chunk, x), p.chunks)).result()
    return torch.cat(outs)
