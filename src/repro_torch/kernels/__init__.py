"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

One module per kernel (``rmsnorm``, ``flash_attention`` with the
contiguous and the paged kernel, ``adjacent_difference``,
``artificial_work``, ``reduce_scan``): its wrapper launches the kernel
for CUDA tensors (built with ``nvcc`` on
first use, ``build.py``) and runs the plain version for CPU tensors, and
keeps a launch counter.  ``ops`` plans the 1-d kernels' grids
(``tuning``, or a measured ``autotune.KernelTuner``).
"""
