"""Map-reduce-type algorithms (paper Section 1): reduce, transform_reduce,
count_if, all_of / any_of / none_of, min_element / max_element.

``reduce`` with ``op=torch.add`` over a float32 or bfloat16 tensor takes
each chunk's partial from the reduce_sum kernel (``kernels.ops``; its
plain version for a CPU tensor).  Every other operator and dtype, and
the other algorithms here, reduce with plain PyTorch ops, as the
reference does with jnp.  On a mesh the partials of the ranks' blocks
combine by ``all_reduce`` (``reduce_on_mesh`` over
``detail.mesh_reduce``); min_element / max_element have no mesh path,
as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.calibration import function_key
from ..core.future import when_all
from ..kernels import ops
from . import detail

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _plan_for(policy, x, partial, tag):
    body = detail.measured_body(partial, x)
    return detail.plan(policy, x.shape[0], body, key=(tag, str(x.dtype)))


def reduce(policy, x: torch.Tensor, op: Callable = torch.add, init=None):
    """Generic associative reduction.  ``op`` is a binary PyTorch callable;
    add, mul, minimum, maximum, logical_and and logical_or have fused
    partials."""
    identity = _identity_for(op, x.dtype, init)
    partial = _partial_for(op, x, identity)
    p = _plan_for(policy, x, partial, "reduce")
    mexec = detail.mesh_executor_of(p.executor)
    if mexec is not None and p.parallel:
        out = reduce_on_mesh(mexec, p.cores, x, op, identity)
    else:
        out = detail.run_reduce_chunks(p, partial, op, x)
    if init is not None and op is torch.add:
        out = op(out, init)
    return out


def reduce_on_mesh(mexec, cores: int, x: torch.Tensor,
                   op: Callable = torch.add, identity=None):
    """``reduce``'s mesh branch (without ``init``): each rank of the
    first ``cores`` of ``mexec``'s mesh folds its block with the entry's
    partial (the reduce_sum kernel for add over float32 / bfloat16), and
    the partials combine over the sub-group."""
    if identity is None:
        identity = _identity_for(op, x.dtype, None)
    return detail.mesh_reduce(mexec, cores, x,
                              _partial_for(op, x, identity),
                              identity.to(x.dtype), op)


def _partial_for(op, x: torch.Tensor, identity: torch.Tensor) -> Callable:
    """The chunk partial of ``reduce``: the reduce_sum kernel for add
    over float32 / bfloat16, else a plain fold."""
    if op is torch.add and x.dtype in KERNEL_DTYPES:
        return ops.reduce_sum

    def partial(c):
        return _fold(op, c, identity)
    return partial


def _identity_for(op, dtype, init) -> torch.Tensor:
    if op is torch.add:
        return torch.zeros((), dtype=dtype)
    if op is torch.mul:
        return torch.ones((), dtype=dtype)
    if op in (torch.minimum, torch.maximum):
        lo = op is torch.maximum
        if dtype.is_floating_point:
            return torch.tensor(-torch.inf if lo else torch.inf, dtype=dtype)
        info = torch.iinfo(dtype)
        return torch.tensor(info.min if lo else info.max, dtype=dtype)
    if op is torch.logical_and:
        return torch.tensor(True)
    if op is torch.logical_or:
        return torch.tensor(False)
    if init is not None:
        return torch.tensor(init, dtype=dtype)
    raise ValueError(f"no identity known for {op}; pass init=")


def _fold(op, c: torch.Tensor, identity: torch.Tensor) -> torch.Tensor:
    """Reduce the 1-d ``c`` with ``op`` (``identity`` when empty)."""
    if c.numel() == 0:
        return identity.to(c.device)
    if op is torch.add:
        return c.sum(dtype=c.dtype)
    if op is torch.mul:
        return c.prod(dtype=c.dtype)
    if op is torch.minimum:
        return c.amin()
    if op is torch.maximum:
        return c.amax()
    if op is torch.logical_and:
        return c.bool().all()
    if op is torch.logical_or:
        return c.bool().any()
    acc = c                       # any other associative op: a tree
    while acc.shape[0] > 1:
        if acc.shape[0] % 2:
            acc = torch.cat([acc, identity.to(acc.device, acc.dtype)[None]])
        acc = op(acc[0::2], acc[1::2])
    return acc[0]


def _transform_reduce(policy, x, transform_fn, op, init, tag):
    identity = _identity_for(op, x.dtype, init)

    def partial(c):
        t = transform_fn(c)
        return _fold(op, t, identity.to(t.dtype))

    p = _plan_for(policy, x, partial, tag)
    mexec = detail.mesh_executor_of(p.executor)
    if mexec is not None and p.parallel:
        return detail.mesh_reduce(mexec, p.cores, x, partial, identity, op)
    return detail.run_reduce_chunks(p, partial, op, x)


def transform_reduce(policy, x: torch.Tensor, transform_fn: Callable,
                     op: Callable = torch.add, init=None):
    """Keyed by ``transform_fn`` and ``op`` themselves
    (``function_key``), where the reference keys by ``id(transform_fn)``."""
    return _transform_reduce(
        policy, x, transform_fn, op, init,
        ("transform_reduce", function_key(transform_fn), function_key(op)))


def count_if(policy, x: torch.Tensor, pred: Callable):
    """Keyed by ``pred``, not by the wrapper made here on every call."""
    return _transform_reduce(
        policy, x, lambda c: pred(c).to(torch.int32), torch.add, None,
        ("count_if", function_key(pred)))


def all_of(policy, x: torch.Tensor, pred: Callable):
    return _transform_reduce(policy, x, pred, torch.logical_and, None,
                             ("all_of", function_key(pred)))


def any_of(policy, x: torch.Tensor, pred: Callable):
    return _transform_reduce(policy, x, pred, torch.logical_or, None,
                             ("any_of", function_key(pred)))


def none_of(policy, x: torch.Tensor, pred: Callable):
    return torch.logical_not(any_of(policy, x, pred))


def _arg_extreme(policy, x: torch.Tensor, is_min: bool):
    """(value, index) of the extreme element, chunk-parallel; the first
    such element on ties, as in the reference."""
    def partial(c):
        i = torch.argmin(c) if is_min else torch.argmax(c)
        return c[i], i

    body = detail.measured_body(partial, x)
    p = detail.plan(policy, x.shape[0], body,
                    key=("min" if is_min else "max", str(x.dtype)))
    if not p.parallel:
        return partial(x)

    def chunk(c):
        v, i = partial(x[c.start:c.start + c.size])
        return v, i + c.start

    partials = when_all(p.executor.bulk_async_execute(
        detail.on_stream(chunk, x), p.chunks)).result()
    vals = torch.stack([v for v, _ in partials])
    idxs = torch.stack([i for _, i in partials])
    sel = torch.argmin(vals) if is_min else torch.argmax(vals)
    return vals[sel], idxs[sel]


def min_element(policy, x: torch.Tensor):
    return _arg_extreme(policy, x, True)


def max_element(policy, x: torch.Tensor):
    return _arg_extreme(policy, x, False)
