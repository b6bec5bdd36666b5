"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

One module per kernel (``rmsnorm``, ``flash_attention`` with the
contiguous and the paged kernel, ``adjacent_difference``,
``artificial_work``, ``reduce_scan``): its wrapper launches the kernel
for CUDA tensors (built with ``nvcc`` on
first use, ``build.py``) and runs the plain version for CPU tensors, and
keeps a launch counter.  ``ops`` plans each kernel's launch — the 1-d
kernels' grids, kernel 1's warps per block, kernels 2 and 3's attention
plan — statically (``tuning``) or measured by an ``autotune.KernelTuner``
(the reference's exports; the kernel functions stay in their modules,
whose names they share).
"""
from . import autotune, ops, tuning
from .autotune import KernelTuner

__all__ = ["autotune", "ops", "tuning", "KernelTuner"]
