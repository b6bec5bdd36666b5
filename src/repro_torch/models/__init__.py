"""Model layer of the port: dense and MoE attention, hybrid Mamba2, xLSTM
and cross-attention (vision), the JAX package's ten architectures."""
from .lm import forward_cached, init_caches, init_params

__all__ = ["forward_cached", "init_caches", "init_params"]
