"""Public wrappers of the 1-d kernels: each picks a block plan and calls
its kernel module.

The plan is static — ``tuning.plan_1d`` with the card's SM count, the
paper's Eq. 10 at the kernel grid — or measured, by an
``autotune.KernelTuner`` passed as ``tuner=``; ``block=`` pins it.  The
kernels mask the ragged edge themselves, so there is no pad-to-plan copy
and no unpad.  For a CPU tensor each wrapper runs its kernel's plain
version and the plan is moot.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from . import adjacent_difference as _adjdiff
from . import artificial_work as _awork
from . import reduce_scan as _rscan
from . import tuning


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_sms(x: torch.Tensor) -> int:
    """SMs of the card that holds ``x``; 1 for a CPU tensor."""
    if x.device.type != "cuda":
        return 1
    index = x.device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def _block(kernel: str, x: torch.Tensor, block: int | None, tuner,
           call: Callable[[torch.Tensor, int], torch.Tensor]) -> int:
    if block is not None:
        return int(block)
    n, item = x.numel(), x.element_size()
    if tuner is not None:
        def run(b: int) -> None:
            call(torch.zeros(n, dtype=x.dtype, device=x.device), b)

        return tuner.plan_1d(kernel, n, run, num_sms=num_sms(x),
                             dtype=str(x.dtype), bytes_per_elem=item).block
    return tuning.plan_1d(n, num_sms=num_sms(x), bytes_per_elem=item).block


def adjacent_difference(x: torch.Tensor, *, block: int | None = None,
                        tuner=None) -> torch.Tensor:
    """out[0] = x[0]; out[i] = x[i] - x[i-1] (kernel 6)."""
    def call(xz, b):
        return _adjdiff.adjacent_difference(xz, block=b)

    return call(x, _block("adjacent_difference", x, block, tuner, call))


def artificial_work(x: torch.Tensor, *, iters: int = 256,
                    block: int | None = None, tuner=None) -> torch.Tensor:
    """``iters`` dependent FMAs per element, f32 (kernel 7)."""
    def call(xz, b):
        return _awork.artificial_work(xz, iters=iters, block=b)

    return call(x, _block(f"artificial_work_{iters}", x, block, tuner, call))


def reduce_sum(x: torch.Tensor, *, block: int | None = None,
               tuner=None) -> torch.Tensor:
    """0-d f32-accumulated sum, in x's type (kernel 4)."""
    def call(xz, b):
        return _rscan.reduce_sum(xz, block=b)

    return call(x, _block("reduce_sum", x, block, tuner, call))


def inclusive_scan(x: torch.Tensor, *, block: int | None = None,
                   tuner=None) -> torch.Tensor:
    """Prefix sum, f32 inside, in x's type (kernel 5)."""
    def call(xz, b):
        return _rscan.inclusive_scan(xz, block=b)

    return call(x, _block("inclusive_scan", x, block, tuner, call))
