"""Prefix sums (paper: "map-reduce-type ... prefix sums").

Chunk-parallel three-phase scan:
  1. scan each chunk locally           (parallel),
  2. exclusive-scan the chunk totals   (serial, n_chunks elements),
  3. combine each chunk with its offset (parallel).

With ``op=torch.add`` over a float32 or bfloat16 tensor, phase 1 of each
chunk is the inclusive_scan kernel (``kernels.ops``; its plain version
for a CPU tensor).  Phase 3 stays ``op(offset, chunk)``, as in the
reference, and other operators and dtypes scan with plain PyTorch ops.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.future import when_all
from ..kernels import ops
from . import detail
from .reduce import KERNEL_DTYPES


def _assoc_scan(op, c: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of the 1-d ``c`` with an associative ``op``."""
    if op is torch.add:
        return torch.cumsum(c, 0, dtype=c.dtype)
    out, k = c, 1                 # any other op: Hillis-Steele doubling
    while k < out.shape[0]:
        out = torch.cat([out[:k], op(out[:-k], out[k:])])
        k *= 2
    return out


def inclusive_scan(policy, x: torch.Tensor,
                   op: Callable = torch.add) -> torch.Tensor:
    if op is torch.add and x.dtype in KERNEL_DTYPES:
        local = ops.inclusive_scan
    else:
        def local(c):
            return _assoc_scan(op, c)

    body = detail.measured_body(local, x)
    p = detail.plan(policy, x.shape[0], body, key=("iscan", str(x.dtype)))
    if not p.parallel:
        return local(x)

    # Phase 1: local scans (parallel)
    def scan_chunk(c):
        return local(x[c.start:c.start + c.size])

    scanned = when_all(p.executor.bulk_async_execute(
        detail.on_stream(scan_chunk, x), p.chunks)).result()
    # Phase 2: serial exclusive scan of totals
    offsets = []
    carry = None
    for s in scanned:
        offsets.append(carry)
        carry = s[-1] if carry is None else op(carry, s[-1])

    # Phase 3: apply offsets (parallel)
    def apply(args):
        i, off = args
        return scanned[i] if off is None else op(off, scanned[i])

    outs = when_all(p.executor.bulk_async_execute(
        detail.on_stream(apply, x), list(enumerate(offsets)))).result()
    return torch.cat(outs)


def exclusive_scan(policy, x: torch.Tensor, init,
                   op: Callable = torch.add) -> torch.Tensor:
    """out[0] = init; out[i] = op(out[i-1], x[i-1])."""
    inc = inclusive_scan(policy, x, op)
    first = torch.tensor([init], dtype=x.dtype, device=x.device)
    return torch.cat([first, op(first[0], inc[:-1])])
