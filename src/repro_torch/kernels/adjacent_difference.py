"""adjacent_difference: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``repro.kernels.adjacent_difference.adjacent_difference_pallas``
(the Pallas TPU kernel) and ``repro.kernels.ref.adjacent_difference_ref``
(its oracle).  The kernel lives in ``csrc/adjacent_difference.cu``.
``adjacent_difference`` launches it for a CUDA tensor and runs
``adjacent_difference_ref`` for a CPU tensor; there is no other route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, tuning

launches = build.LaunchCounter("adjacent_difference")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def adjacent_difference_ref(x: torch.Tensor) -> torch.Tensor:
    """out[0] = x[0]; out[i] = x[i] - x[i-1]."""
    return torch.cat([x[:1], x[1:] - x[:-1]])


@functools.cache
def _fn():
    fn = build.library("adjacent_difference").repro_adjacent_difference
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                   ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adjacent_difference(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """x: (n,), f32 or bf16; ``block`` elements per thread block."""
    if x.device.type == "cpu":
        return adjacent_difference_ref(x)
    code = tuning.check_1d("adjacent_difference", x, block, _DTYPES)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _fn()(x.data_ptr(), out.data_ptr(), x.numel(), int(block), code,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "adjacent_difference")
    launches.add()
    return out
