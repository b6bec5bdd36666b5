"""PyTorch/CUDA port of the adaptive execution model and its serve path.

The JAX package (``repro``) stays the reference; this package imports
``torch`` and nothing of it.  The slices ported so far serve dense
attention models (``qwen3-0.6b``) through the adaptive ``ServeScheduler``
on an H100, with hand-written CUDA kernels for RMSNorm and flash
attention, and run the paper's parallel algorithms
(``repro_torch.algorithms``) under execution policies and the adaptive
executor, with CUDA kernels for reduce, scan, adjacent_difference and
artificial work.  Entry points run on the card unless the caller passes
``device="cpu"``; the algorithms run where their input tensor lies.
"""
__all__ = ["algorithms", "configs", "core", "kernels", "models", "serve",
           "launch"]
