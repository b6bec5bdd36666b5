"""reduce_sum and inclusive_scan: the CUDA kernels' wrappers and their
plain PyTorch versions.

Port of ``repro.kernels.reduce_scan.reduce_sum_pallas`` and
``inclusive_scan_pallas`` (the Pallas TPU kernels) and
``repro.kernels.ref.reduce_sum_ref`` / ``inclusive_scan_ref`` (their
oracles; the plain scan accumulates in f64 where the reference's
accumulates in f32, see ``inclusive_scan_ref``).  The kernels live in
``csrc/reduce_scan.cu``.  Each wrapper
launches them for a CUDA tensor and runs the plain version for a CPU
tensor; there is no other route.

``reduce_sum`` launches the partial-sum kernel over x, then once more
over the (grid,) f32 partials as a single block; ``inclusive_scan``
launches the local scan, scans the (grid,) block totals with
``torch.cumsum`` (phase 2, which the reference also runs outside its
kernel), and launches the offset pass.  With one block the second launch
is not needed.  Each launch counts.  The scratch vectors (partials,
totals, offsets) may be freed as soon as a wrapper returns: PyTorch's
caching allocator hands their memory out again only to work queued after
the kernels on the same stream.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, tuning

reduce_launches = build.LaunchCounter("reduce_sum")
scan_launches = build.LaunchCounter("inclusive_scan")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reduce_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Sum in f32, cast to x's type."""
    return torch.sum(x, dtype=torch.float32).to(x.dtype)


def inclusive_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum accumulated in f64 and rounded once to x's type: the
    exact prefix sum, correctly rounded.  (An f32 ``torch.cumsum`` on the
    card carries its running sum across tiles in an order that changes
    from run to run, and at 2^26 elements strays further from the exact
    sum than a sound f32 scan may; as an oracle it must not.)"""
    return torch.cumsum(x, 0, dtype=torch.float64).to(x.dtype)


@functools.cache
def _lib():
    lib = build.library("reduce_scan")
    vp, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    for name, args in (("repro_reduce_sum_partials", [vp, vp, sz, sz, i, vp]),
                       ("repro_scan_local", [vp, vp, vp, sz, sz, i, vp]),
                       ("repro_scan_add_offsets", [vp, vp, sz, sz, i, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def reduce_sum(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """0-d sum of x (n,), f32 or bf16, accumulated in f32 and cast to
    x's type; ``block`` elements per thread block."""
    if x.device.type == "cpu":
        return reduce_sum_ref(x)
    code = tuning.check_1d("reduce_sum", x, block, _DTYPES)
    n = x.numel()
    if n == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    grid = math.ceil(n / int(block))
    partials = torch.empty(grid, dtype=torch.float32, device=x.device)
    build.check(lib.repro_reduce_sum_partials(
        x.data_ptr(), partials.data_ptr(), n, int(block), code, stream),
        "reduce_sum")
    reduce_launches.add()
    if grid > 1:
        total = torch.empty(1, dtype=torch.float32, device=x.device)
        build.check(lib.repro_reduce_sum_partials(
            partials.data_ptr(), total.data_ptr(), grid, grid, 0, stream),
            "reduce_sum")
        reduce_launches.add()
        partials = total
    return partials[0].to(x.dtype)


def inclusive_scan(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """Prefix sum of x (n,), f32 or bf16, in f32 inside each block, cast
    to x's type; ``block`` elements per thread block."""
    if x.device.type == "cpu":
        return inclusive_scan_ref(x)
    code = tuning.check_1d("inclusive_scan", x, block, _DTYPES)
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    grid = math.ceil(n / int(block))
    totals = torch.empty(grid, dtype=torch.float32, device=x.device)
    build.check(lib.repro_scan_local(
        x.data_ptr(), out.data_ptr(), totals.data_ptr(), n, int(block), code,
        stream), "inclusive_scan")
    scan_launches.add()
    if grid > 1:
        offsets = torch.cat([totals.new_zeros(1),
                             torch.cumsum(totals, 0)[:-1]])
        build.check(lib.repro_scan_add_offsets(
            out.data_ptr(), offsets.data_ptr(), n, int(block), code, stream),
            "inclusive_scan")
        scan_launches.add()
    return out
