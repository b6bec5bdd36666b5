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


def out_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape and type whose first element lies at
    x's offset from a 16-byte boundary: a view into a buffer one vector
    longer.  The kernel's body then loads and stores whole vectors of
    both (an interior ``par`` chunk is a view one element left of a
    boundary, where a fresh tensor would start on one)."""
    per_vec = 16 // x.element_size()
    buf = torch.empty(x.numel() + per_vec, dtype=x.dtype, device=x.device)
    want = x.data_ptr() % 16 // x.element_size()
    have = buf.data_ptr() % 16 // x.element_size()
    off = (want - have) % per_vec
    return buf[off:off + x.numel()]


def adjacent_difference(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """x: (n,), f32 or bf16; ``block`` elements per thread block."""
    if x.device.type == "cpu":
        return adjacent_difference_ref(x)
    code = tuning.check_1d("adjacent_difference", x, block, _DTYPES)
    out = out_like(x)
    if x.numel() == 0:
        return out
    err = _fn()(x.data_ptr(), out.data_ptr(), x.numel(), int(block), code,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "adjacent_difference")
    launches.add()
    return out
