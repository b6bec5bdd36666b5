"""RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro.kernels.rmsnorm.rmsnorm_pallas`` (the Pallas TPU kernel)
and ``repro.kernels.ref.rmsnorm_ref`` (its oracle).  The kernel lives in
``csrc/rmsnorm.cu``.  ``rmsnorm`` launches it for a CUDA tensor and runs
``rmsnorm_ref`` for a CPU tensor; there is no other route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = build.LaunchCounter("rmsnorm")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``(x / sqrt(mean(x²) + eps)) · γ`` in f32, cast back to x's type."""
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * gamma.float()).to(x.dtype)


@functools.cache
def _fn():
    fn = build.library("rmsnorm").repro_rmsnorm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d), γ: (d,).  Leading dims are flattened to rows."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if gamma.shape != (d,) or gamma.device != x.device:
        raise ValueError(f"rmsnorm: gamma {tuple(gamma.shape)} on "
                         f"{gamma.device} does not match x (..., {d}) on "
                         f"{x.device}")
    if d % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("rmsnorm: x must be contiguous, 16-byte aligned, "
                         "with d a multiple of 8")
    g = gamma if gamma.dtype == torch.float32 else gamma.float()
    g = g.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    err = _fn()(x.data_ptr(), g.data_ptr(), out.data_ptr(), rows, d,
                float(eps), _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm")
    launches.add()
    return out
