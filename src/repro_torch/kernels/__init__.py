"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

One module per kernel (``rmsnorm``, ``flash_attention``): its wrapper
launches the kernel for CUDA tensors (built with ``nvcc`` on first use,
``build.py``) and runs the plain version for CPU tensors, and keeps a
``launches`` counter.
"""
