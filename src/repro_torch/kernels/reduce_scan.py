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

Each wrapper makes one zeroed scratch vector on the call's stream and
launches one kernel, which counts once.  ``reduce_sum``: the blocks'
f32 partials and a counter; the last block to finish sums the partials
and writes the 0-d result in x's type.  ``inclusive_scan``: one pass
over the segments of ``scan_plan``, which hold their aggregates, the
groups' totals and a ticket in the scratch (the look-back is described
in the source).  The scratch may be freed as soon as a wrapper returns:
PyTorch's caching allocator hands its memory out again only to work
queued after the kernel on the same stream, and no status word outlives
the call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import build, tuning

reduce_launches = build.LaunchCounter("reduce_sum")
scan_launches = build.LaunchCounter("inclusive_scan")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The scan's segment plan, mirrored by the constants of csrc/reduce_scan.cu.
SCAN_SEG_BYTES = 8 * tuning.THREADS * tuning.BYTES_PER_THREAD  # kScanSegTiles tiles
SCAN_GROUP = 32          # segments per group of the look-back (kGroup)
SCAN_SEG_MIN_TILES = 4   # the least segment, in tiles


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Segment k covers [k * seg, min((k + 1) * seg, n)), whatever block
    takes ticket k, and lies in group k // SCAN_GROUP."""

    seg: int             # elements of one segment (the last may be shorter)
    n_segs: int
    n_groups: int

    @property
    def scratch_words(self) -> int:
        """64-bit status words: the aggregates, the group totals, the
        ticket."""
        return self.n_segs + self.n_groups + 1


def scan_seg_max(itemsize: int) -> int:
    """Elements of the largest segment: 8192 f32, 16384 bf16."""
    return SCAN_SEG_BYTES // int(itemsize)


def scan_plan(n: int, block: int, itemsize: int) -> ScanPlan:
    """Segments of a scan of ``n`` elements at ``block``: min(block,
    ``scan_seg_max``), a block below ``SCAN_SEG_MIN_TILES`` tiles raised
    to that.  Each segment pays a ticket and a look-back whatever its
    size, so a smaller one costs more than it balances (PERF.md)."""
    seg = min(max(int(block),
                  SCAN_SEG_MIN_TILES * tuning.tile_elems(itemsize)),
              scan_seg_max(itemsize))
    n_segs = max(math.ceil(int(n) / seg), 1)
    return ScanPlan(seg=seg, n_segs=n_segs,
                    n_groups=math.ceil(n_segs / SCAN_GROUP))


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
    for name in ("repro_reduce_sum", "repro_inclusive_scan"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, sz, sz, i, vp]
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
    out = torch.empty((), dtype=x.dtype, device=x.device)
    grid = math.ceil(n / int(block))
    scratch = torch.zeros(grid + 1, dtype=torch.int32, device=x.device)
    build.check(_lib().repro_reduce_sum(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, int(block),
        code, torch.cuda.current_stream(x.device).cuda_stream), "reduce_sum")
    reduce_launches.add()
    return out


def inclusive_scan(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """Prefix sum of x (n,), f32 or bf16, accumulated in f32 and rounded
    once to x's type; segments of ``scan_plan(n, block, itemsize)``."""
    if x.device.type == "cpu":
        return inclusive_scan_ref(x)
    code = tuning.check_1d("inclusive_scan", x, block, _DTYPES)
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:
        return out
    plan = scan_plan(n, int(block), x.element_size())
    status = torch.zeros(plan.scratch_words, dtype=torch.int64,
                         device=x.device)
    build.check(_lib().repro_inclusive_scan(
        x.data_ptr(), out.data_ptr(), status.data_ptr(), n, plan.seg, code,
        torch.cuda.current_stream(x.device).cuda_stream), "inclusive_scan")
    scan_launches.add()
    return out
