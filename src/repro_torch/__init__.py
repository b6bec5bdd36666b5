"""PyTorch/CUDA port of the adaptive execution model and its serve path.

The JAX package (``repro``) stays the reference; this package imports
``torch`` and nothing of it.  The slice ported so far serves dense
attention models (``qwen3-0.6b``) through the adaptive ``ServeScheduler``
on an H100, with hand-written CUDA kernels for RMSNorm and flash
attention.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
__all__ = ["configs", "core", "kernels", "models", "serve", "launch"]
