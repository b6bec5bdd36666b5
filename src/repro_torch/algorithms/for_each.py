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

from ..core.calibration import function_key
from ..device import resolve_device
from . import detail


def _map(policy, fn: Callable, key, *arrays: torch.Tensor) -> torch.Tensor:
    body = detail.measured_body(fn, *arrays)
    p = detail.plan(policy, arrays[0].shape[0], body, key=key)
    mexec = detail.mesh_executor_of(p.executor)
    if mexec is not None and p.parallel:
        return detail.mesh_map(mexec, p.cores, fn, *arrays)
    return detail.run_map_chunks(p, fn, *arrays)


def transform(policy, x: torch.Tensor, fn: Callable,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = fn(x[i])  (or fn(x[i], y[i]) for the binary overload).
    The calibration is keyed by ``fn`` itself (``function_key``), where
    the reference keys by its ``id()``."""
    arrays = (x,) if y is None else (x, y)
    return _map(policy, fn, ("transform", function_key(fn), str(x.dtype)),
                *arrays)


def for_each(policy, x: torch.Tensor, fn: Callable) -> torch.Tensor:
    """Apply fn to every element and return the mapped tensor (for_each
    is transform with the result returned, as in the reference)."""
    return transform(policy, x, fn)


def copy(policy, x: torch.Tensor) -> torch.Tensor:
    return transform(policy, x, torch.clone)


def fill(policy, x: torch.Tensor, value) -> torch.Tensor:
    """Keyed by x's type alone: the body costs the same for any value."""
    return _map(policy, lambda a: torch.full_like(a, value),
                ("fill", str(x.dtype)), x)


def generate(policy, count: int, fn: Callable, dtype=torch.float32,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """out[i] = fn(i) — fn maps an int32 index tensor.  Runs on the card
    unless ``device="cpu"`` is passed; with no card it raises."""
    idx = torch.arange(count, dtype=torch.int32,
                       device=resolve_device(device))
    out = transform(policy, idx, fn)
    return out if out.dtype == dtype else out.to(dtype)
