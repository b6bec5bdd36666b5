"""Map-type algorithms: transform, for_each, copy, fill, generate.

These are the algorithms the paper classifies as "map-type" (Section 1).
Each takes an execution policy first, mirroring the C++ API:

    transform(par.on(adaptive(HostParallelExecutor())), x, fn)
    transform(par.on(HostParallelExecutor()).with_(acc), x, fn)   # equivalent

``fn`` is a PyTorch function over a chunk (a 1-d slice).  The tensor's
own device runs it: a CUDA tensor on the card, a CPU tensor on the CPU.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from . import detail


def _chunk_key(fn: Callable, x: torch.Tensor, tag: str):
    return (tag, id(fn), str(x.dtype))


def transform(policy, x: torch.Tensor, fn: Callable,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = fn(x[i])  (or fn(x[i], y[i]) for the binary overload)."""
    arrays = (x,) if y is None else (x, y)
    body = detail.measured_body(fn, *arrays)
    p = detail.plan(policy, x.shape[0], body,
                    key=_chunk_key(fn, x, "transform"))
    return detail.run_map_chunks(p, fn, *arrays)


def for_each(policy, x: torch.Tensor, fn: Callable) -> torch.Tensor:
    """Apply fn to every element and return the mapped tensor (for_each
    is transform with the result returned, as in the reference)."""
    return transform(policy, x, fn)


def copy(policy, x: torch.Tensor) -> torch.Tensor:
    return transform(policy, x, torch.clone)


def fill(policy, x: torch.Tensor, value) -> torch.Tensor:
    return transform(policy, x, lambda a: torch.full_like(a, value))


def generate(policy, count: int, fn: Callable, dtype=torch.float32,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """out[i] = fn(i) — fn maps an int32 index tensor.  Runs on the card
    unless ``device="cpu"`` is passed; with no card it raises."""
    idx = torch.arange(count, dtype=torch.int32,
                       device=resolve_device(device))
    out = transform(policy, idx, fn)
    return out if out.dtype == dtype else out.to(dtype)
