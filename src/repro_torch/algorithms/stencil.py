"""3-point stencil update — the paper's motivating Cauchy-problem kernel
(Section 2: finite-difference evolution of grid data).

out[i] = a*x[i-1] + b*x[i] + c*x[i+1], boundaries copied through.  Each
chunk reads a one-element halo on each side (plain PyTorch ops, as the
reference runs jnp).  ``artificial_work`` is the paper's compute-bound
body (Figures 3/4): ``iters`` dependent multiply-adds per element, each
chunk one launch of the artificial_work kernel (``kernels.ops``; its
plain version for a CPU tensor), float32 only.
"""
from __future__ import annotations

import torch

from ..core.future import when_all
from ..kernels import ops
from . import detail


def _stencil_once(arr: torch.Tensor, a: float, b: float,
                  c: float) -> torch.Tensor:
    inner = a * arr[:-2] + b * arr[1:-1] + c * arr[2:]
    return torch.cat([arr[:1], inner, arr[-1:]])


def stencil3(policy, x: torch.Tensor, a: float = 1.0, b: float = -2.0,
             c: float = 1.0) -> torch.Tensor:
    count = x.shape[0]
    if count < 3:
        return x

    def whole(arr):
        return _stencil_once(arr, a, b, c)

    body = detail.measured_body(whole, x)
    p = detail.plan(policy, count, body, key=("stencil3", str(x.dtype)))
    if not p.parallel:
        return whole(x)

    # Each chunk applies the whole-array stencil (which copies slice
    # boundaries) to its halo-extended slice and keeps the range it owns;
    # the copies land exactly on the true boundaries because the outermost
    # slices are not extended there.
    def chunk(ch):
        lo = max(ch.start - 1, 0)
        hi = min(ch.start + ch.size + 1, count)
        off = ch.start - lo
        return whole(x[lo:hi])[off:off + ch.size]

    outs = when_all(p.executor.bulk_async_execute(
        detail.on_stream(chunk, x), p.chunks)).result()
    return torch.cat(outs)


def artificial_work(policy, x: torch.Tensor, iters: int = 256) -> torch.Tensor:
    """The paper's compute-bound body: ``iters`` fused multiply-adds per
    element (negligible memory traffic relative to FLOPs).

    ``transform`` with the kernel as its body, keyed by ``iters`` where
    the reference keys by the id() of a body made anew on every call: a
    later call with the same ``iters`` reuses the calibration."""
    def body(c):
        return ops.artificial_work(c, iters=iters)

    p = detail.plan(policy, x.shape[0], detail.measured_body(body, x),
                    key=("artificial_work", int(iters), str(x.dtype)))
    return detail.run_map_chunks(p, body, x)
