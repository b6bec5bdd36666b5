"""artificial_work: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``repro.kernels.artificial_work.artificial_work_pallas`` (the
Pallas TPU kernel) and ``repro.kernels.ref.artificial_work_ref`` (its
oracle): ``iters`` dependent steps ``c ← c·1.000000119 + 0.1`` per
element.  The kernel lives in ``csrc/artificial_work.cu``.
``artificial_work`` launches it for a CUDA tensor and runs
``artificial_work_ref`` for a CPU tensor; there is no other route.

float32 only, as the reference's tests use it; another dtype raises
``TypeError`` on either device (in bf16 the two frameworks round
``+ 0.1`` at different places).  Each step is rounded once, as a fused
multiply-add rounds: the kernel issues one FMA a step, and XLA contracts
the reference's ``c * a + b`` into one on the CPU.  The plain version
gets the same rounding by computing each step in f64 (the product is
exact there) and rounding to f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, tuning

launches = build.LaunchCounter("artificial_work")

_DTYPES = {torch.float32: 0}
# The step's constants as the f32 values the kernel (and XLA) use.
_MUL = float(torch.tensor(1.000000119, dtype=torch.float32))
_ADD = float(torch.tensor(0.1, dtype=torch.float32))


def artificial_work_ref(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` steps of ``c * 1.000000119 + 0.1``, each rounded once
    to f32."""
    c = x
    for _ in range(int(iters)):
        c = (c.double() * _MUL + _ADD).float()
    return c


@functools.cache
def _fn():
    fn = build.library("artificial_work").repro_artificial_work
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                   ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def artificial_work(x: torch.Tensor, *, iters: int,
                    block: int) -> torch.Tensor:
    """x: (n,) f32; ``block`` elements per thread block."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"artificial_work: dtype {x.dtype} not supported "
                        f"(float32)")
    if int(iters) < 0:
        raise ValueError(f"artificial_work: iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return artificial_work_ref(x, iters)
    tuning.check_1d("artificial_work", x, block, _DTYPES)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _fn()(x.data_ptr(), out.data_ptr(), x.numel(), int(block),
                int(iters), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "artificial_work")
    launches.add()
    return out
